"""LM model: parameter init, forward, prefill, decode — all six families
of the reference's ``repro/models/lm/model.py`` (dense, moe, ssm, hybrid,
encdec, vlm).

* Parameters keep the reference's tree.  Homogeneous stacks (dense, moe,
  ssm, vlm) hold their layer leaves stacked on a leading layer axis
  (``params["layers"]``); heterogeneous ones hold lists of per-layer dicts
  (hybrid's ``layers_list``, whose kinds come from ``cfg.layer_kind(i)``;
  encdec's ``enc_layers`` and ``dec_layers``), so
  ``engine.weights.lm_params_from_numpy`` carries the reference's
  parameters over unchanged.  The reference's ``lax.scan`` over the
  stacked axis is a Python loop over layers here, as are its loops over
  the lists.
* The caches are the reference's: a ``(L, B, Hkv, max_len, hd)`` KV cache
  and ``(L, B, ...)`` SSM/conv states; for hybrid one dict a layer, a ring
  of ``w = min(local_window, max_len)`` slots (position p at slot p % w)
  for an attention layer and the LRU and conv states for a recurrent one;
  for encdec per decoder layer a self-attention KV cache and the
  cross-attention K/V of the encoder's output.  The reference returns new
  cache arrays from ``prefill`` and ``decode_step``; the port writes the
  new entries into the cache in place and returns the same dict, so a
  caller that keeps a cache across steps owns it (``LMSession.generate``
  builds its own per call).
* A ``moe`` layer is a dense layer whose MLP is ``layers.moe_ffn``; a
  ``vlm`` layer is a dense one, its image embeddings (a stub frontend's)
  put before the text's.  ``forward`` returns the logits only: the
  reference's summed MoE aux loss is for training (ROADMAP A10) and is
  checked at the ``moe_ffn`` level.  On one card the reference's
  ``shard_hint`` calls are the identity and are dropped (ROADMAP A10).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch.models.lm import layers as L
from repro_torch.models.lm import rglru, ssm
from repro_torch.models.lm.config import LMConfig

# the families whose layers are stacked on a leading axis
STACKED = ("dense", "moe", "ssm", "vlm")
# the most fp32 values one draw of ``_Init.mat`` makes (64 MiB), below one
# arctic-480b expert matrix (7168 x 4864)
DRAW_ELEMS = 1 << 24


def _dt(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ===========================================================================
# Parameter initialization
# ===========================================================================

class _Init:
    """Draws from one ``torch.Generator`` seeded by ``seed`` on ``device``.
    The draws differ from ``jax.random``'s; tests carry the reference's
    parameters across instead.  A leaf is allocated once in its own type
    and filled one matrix (one layer, one expert) at a time, in row chunks
    of at most ``DRAW_ELEMS`` fp32 values, so that no fp32 copy of a whole
    stacked leaf exists: arctic-480b's ``experts.wu`` of one layer is
    8.9 GB in bf16 and would be 17.8 GB in fp32."""

    def __init__(self, cfg: LMConfig, seed: int, device) -> None:
        self.cfg = cfg
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def mat(self, shape, scale=None) -> torch.Tensor:
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        rows, cols = shape[-2], shape[-1]
        out = torch.empty(shape, dtype=_dt(self.cfg), device=self.device)
        step = max(1, DRAW_ELEMS // cols)
        for m in out.view(-1, rows, cols):
            for r0 in range(0, rows, step):
                part = torch.randn((min(step, rows - r0), cols),
                                   generator=self.gen, dtype=torch.float32,
                                   device=self.device)
                m[r0:r0 + step].copy_(part.mul_(scale))
        return out

    def full(self, shape, value, dtype=None) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype or _dt(self.cfg),
                          device=self.device)


def _norm_p(ini: _Init, n: int, d: int) -> Dict:
    p = {"w": ini.full((n, d), 1.0)}
    if ini.cfg.norm == "layernorm":
        p["b"] = ini.full((n, d), 0.0)
    return p


def _attn_p(ini: _Init, n: int) -> Dict:
    cfg = ini.cfg
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"wq": ini.mat((n, d, h * hd)),
         "wk": ini.mat((n, d, kv * hd)),
         "wv": ini.mat((n, d, kv * hd)),
         "wo": ini.mat((n, h * hd, d))}
    if cfg.qkv_bias:
        p["bq"] = ini.full((n, h * hd), 0.0)
        p["bk"] = ini.full((n, kv * hd), 0.0)
        p["bv"] = ini.full((n, kv * hd), 0.0)
    return p


def _mlp_p(ini: _Init, n: int, d_ff: int) -> Dict:
    d = ini.cfg.d_model
    if ini.cfg.mlp_gated:
        return {"wg": ini.mat((n, d, d_ff)), "wu": ini.mat((n, d, d_ff)),
                "wd": ini.mat((n, d_ff, d))}
    return {"wu": ini.mat((n, d, d_ff)), "wd": ini.mat((n, d_ff, d))}


def _moe_p(ini: _Init, n: int) -> Dict:
    cfg = ini.cfg
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    # the reference draws each layer's (E, d, f) up-projections with its
    # default scale 1/sqrt(shape[0]), which is 1/sqrt(E), not 1/sqrt(d)
    p = {"router": ini.mat((n, d, e), scale=0.02)}
    experts = {"wu": ini.mat((n, e, d, f), scale=1 / math.sqrt(e)),
               "wd": ini.mat((n, e, f, d), scale=1 / math.sqrt(f))}
    if cfg.mlp_gated:
        experts["wg"] = ini.mat((n, e, d, f), scale=1 / math.sqrt(e))
    p["experts"] = experts
    if cfg.n_shared_experts:
        p["shared"] = _mlp_p(ini, n, cfg.moe_d_ff * cfg.n_shared_experts)
    if cfg.dense_residual:
        p["dense"] = _mlp_p(ini, n, cfg.d_ff)
    return p


def _dense_layer_p(ini: _Init, n: int) -> Dict:
    d = ini.cfg.d_model
    p = {"ln1": _norm_p(ini, n, d), "attn": _attn_p(ini, n),
         "ln2": _norm_p(ini, n, d)}
    if ini.cfg.family == "moe":
        p["moe"] = _moe_p(ini, n)
    else:
        p["mlp"] = _mlp_p(ini, n, ini.cfg.d_ff)
    return p


def _ssm_layer_p(ini: _Init, n_layers: int) -> Dict:
    cfg = ini.cfg
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    f32 = torch.float32
    return {
        "norm": _norm_p(ini, n_layers, d),
        "in_proj": ini.mat((n_layers, d, 2 * di + 2 * n + nh)),
        "conv_w": ini.mat((n_layers, cfg.conv_kernel, di + 2 * n), scale=0.5),
        "dt_bias": ini.full((n_layers, nh), 0.0, f32),
        "a_log": ini.full((n_layers, nh), 0.0, f32),     # A = -1
        "d_skip": ini.full((n_layers, nh), 1.0, f32),
        "norm_w": ini.full((n_layers, di), 1.0),
        "out_proj": ini.mat((n_layers, di, d)),
    }


def _rec_layer_p(ini: _Init) -> Dict:
    """One RG-LRU sublayer (unstacked).  Griffin's Lambda runs linearly
    over [0.5, 2] across the width, as in the reference."""
    cfg = ini.cfg
    d, w = cfg.d_model, cfg.lru_width
    p = {"wx": ini.mat((d, w)), "wy": ini.mat((d, w)),
         "conv_w": ini.mat((cfg.conv_kernel, w), scale=0.5),
         "lam": torch.linspace(0.5, 2.0, w, dtype=torch.float32,
                               device=ini.device),
         "wo": ini.mat((w, d))}
    if cfg.fused_gates:
        p["w_gates"] = ini.mat((w, 2 * w))
        p["b_gates"] = ini.full((2 * w,), 0.0)
    else:
        p["w_in_gate"] = ini.mat((w, w))
        p["b_in_gate"] = ini.full((w,), 0.0)
        p["w_rec_gate"] = ini.mat((w, w))
        p["b_rec_gate"] = ini.full((w,), 0.0)
    return p


def _hybrid_layer_p(ini: _Init, kind: str) -> Dict:
    d = ini.cfg.d_model
    p = {"ln1": _norm_p(ini, 1, d), "ln2": _norm_p(ini, 1, d),
         "mlp": _mlp_p(ini, 1, ini.cfg.d_ff)}
    if kind == "attn":
        p["attn"] = _attn_p(ini, 1)
    p = _layer(p, 0)
    if kind != "attn":
        p["rec"] = _rec_layer_p(ini)
    return p


def _encdec_layer_p(ini: _Init, cross: bool) -> Dict:
    d = ini.cfg.d_model
    p = {"ln1": _norm_p(ini, 1, d), "attn": _attn_p(ini, 1),
         "ln2": _norm_p(ini, 1, d), "mlp": _mlp_p(ini, 1, ini.cfg.d_ff)}
    if cross:
        p["ln_x"] = _norm_p(ini, 1, d)
        p["xattn"] = _attn_p(ini, 1)
    return _layer(p, 0)


def init_params(cfg: LMConfig, seed: int = 0, device="cuda") -> Dict:
    """The reference's parameter tree and scales, drawn on ``device``."""
    ini = _Init(cfg, seed, device)
    p: Dict[str, Any] = {
        "embed": ini.mat((cfg.vocab, cfg.d_model), scale=0.02),
        "final_norm": _layer(_norm_p(ini, 1, cfg.d_model), 0),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ini.mat((cfg.d_model, cfg.vocab))
    if cfg.family == "ssm":
        p["layers"] = _ssm_layer_p(ini, cfg.n_layers)
    elif cfg.family == "hybrid":
        p["layers_list"] = [_hybrid_layer_p(ini, cfg.layer_kind(i))
                            for i in range(cfg.n_layers)]
    elif cfg.family == "encdec":
        p["enc_layers"] = [_encdec_layer_p(ini, cross=False)
                           for _ in range(cfg.enc_layers)]
        p["dec_layers"] = [_encdec_layer_p(ini, cross=True)
                           for _ in range(cfg.n_layers)]
        p["enc_pos"] = ini.mat((cfg.enc_positions, cfg.d_model), scale=0.02)
        p["enc_norm"] = _layer(_norm_p(ini, 1, cfg.d_model), 0)
    else:
        p["layers"] = _dense_layer_p(ini, cfg.n_layers)
    return p


def params_to(tree, device):
    """The same tree (dicts and lists) with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    return tree.to(device)


def _layer(tree: Dict, i: int) -> Dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(params: Dict, cfg: LMConfig) -> Iterator[Dict]:
    for i in range(cfg.n_layers):
        yield _layer(params["layers"], i)


# ===========================================================================
# Forward passes
# ===========================================================================

def _ffn(h, lp, cfg: LMConfig):
    """A dense, vlm or moe layer's feed-forward block on (B, S, d)."""
    if cfg.family != "moe":
        return L.mlp(h, lp["mlp"], cfg)
    b, s, d = h.shape
    flat = h.reshape(b * s, d)
    y, _ = L.moe_ffn(flat, lp["moe"], cfg)
    # The reference adds the shared (kimi-k2) and dense residual (arctic)
    # MLPs only where the layer's own parameters hold "shared" or "dense",
    # and its tree keeps them under lp["moe"], so neither runs there; the
    # port matches it (ROADMAP C)
    return y.reshape(b, s, d)


def _dense_layer_fwd(x, lp, cfg: LMConfig, positions):
    """One dense, vlm or moe layer; also returns its rope'd K/V for a
    cache."""
    h = L.apply_norm(x, lp["ln1"], cfg)
    attn_out, kv = L.attention(h, lp["attn"], cfg, positions=positions)
    x = x + attn_out
    h = L.apply_norm(x, lp["ln2"], cfg)
    return x + _ffn(h, lp, cfg), kv


def _run_stacked(params, cfg: LMConfig, x, positions, cache=None):
    """The layer loop of a stacked family.  With ``cache``, each layer's
    K/V (dense, moe, vlm) or final SSM and conv states (ssm) are written
    into it at position 0."""
    for i, lp in enumerate(_layers(params, cfg)):
        if cfg.family == "ssm":
            normed = L.apply_norm(x, lp["norm"], cfg)
            out, (s_new, c_new) = ssm.mamba2_layer(normed, lp, cfg)
            x = x + out
            if cache is not None:
                cache["ssm"][i] = s_new
                cache["conv"][i] = c_new
        else:
            x, kv = _dense_layer_fwd(x, lp, cfg, positions)
            if cache is not None:
                _write_kv(cache["k"][i], cache["v"][i], kv, 0)
    return x


def _ring(t: torch.Tensor, w: int) -> torch.Tensor:
    """The last ``w`` positions of (B, Hkv, S, hd) K or V (S >= w) in the
    ring layout: position p at slot p % w."""
    return torch.roll(t[:, :, -w:], t.shape[2] % w, dims=2)


def _run_hybrid(params, cfg: LMConfig, x, positions, cache=None):
    """The hybrid layer loop: banded attention (``local_window``) or an
    RG-LRU block, each followed by the MLP.  With ``cache``, an attention
    layer's ring holds its last ``w`` positions' K/V, and a recurrent
    layer's LRU and conv states are its final ones."""
    s = x.shape[1]
    for i, lp in enumerate(params["layers_list"]):
        h = L.apply_norm(x, lp["ln1"], cfg)
        if cfg.layer_kind(i) == "attn":
            out, kv = L.attention(h, lp["attn"], cfg, positions=positions,
                                  window=cfg.local_window)
            if cache is not None:
                cl = cache["layers"][i]
                w = cl["k"].shape[2]
                if s >= w:
                    cl["k"], cl["v"] = (_ring(t, w) for t in kv)
                else:
                    _write_kv(cl["k"], cl["v"], kv, 0)
        else:
            out, (lru, conv) = rglru.recurrent_block(h, lp["rec"], cfg)
            if cache is not None:
                cache["layers"][i].update(lru=lru, conv=conv)
        x = x + out
        h = L.apply_norm(x, lp["ln2"], cfg)
        x = x + L.mlp(h, lp["mlp"], cfg)
    return x


def _encode(params, cfg: LMConfig, frames):
    """Whisper encoder over (stub-frontend) frame embeddings (B, S_enc,
    d): learned positions, non-causal attention without RoPE."""
    s = frames.shape[1]
    x = frames.to(_dt(cfg)) + params["enc_pos"][None, :s]
    pos = torch.arange(s, device=x.device)
    for lp in params["enc_layers"]:
        h = L.apply_norm(x, lp["ln1"], cfg)
        out, _ = L.attention(h, lp["attn"], cfg, positions=pos,
                             causal=False, use_rope=False)
        x = x + out
        h = L.apply_norm(x, lp["ln2"], cfg)
        x = x + L.mlp(h, lp["mlp"], cfg)
    return L.apply_norm(x, params["enc_norm"], cfg)


def _cross_kv(lp, cfg: LMConfig, enc_out):
    """One decoder layer's cross-attention K/V (B, Hkv, S_enc, hd) of the
    encoder's output (no bias, as in the reference)."""
    b, s, _ = enc_out.shape
    kv, hd = cfg.n_kv, cfg.head_dim
    k = (enc_out @ lp["xattn"]["wk"]).reshape(b, s, kv, hd)
    v = (enc_out @ lp["xattn"]["wv"]).reshape(b, s, kv, hd)
    return (k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())


def _run_decoder(params, cfg: LMConfig, x, positions, enc_out, cache=None):
    """The whisper decoder: causal self-attention (RoPE), cross-attention
    to ``enc_out``, MLP.  With ``cache``, each layer's self K/V are
    written at position 0 and its cross K/V stored."""
    for i, lp in enumerate(params["dec_layers"]):
        h = L.apply_norm(x, lp["ln1"], cfg)
        out, kv = L.attention(h, lp["attn"], cfg, positions=positions)
        x = x + out
        ck, cv = _cross_kv(lp, cfg, enc_out)
        if cache is not None:
            _write_kv(cache["self"][i]["k"], cache["self"][i]["v"], kv, 0)
            cache["cross"][i] = {"k": ck.to(_dt(cfg)), "v": cv.to(_dt(cfg))}
        h = L.apply_norm(x, lp["ln_x"], cfg)
        out, _ = L.attention(h, lp["xattn"], cfg, positions=positions,
                             cross_kv=(ck, cv))
        x = x + out
        h = L.apply_norm(x, lp["ln2"], cfg)
        x = x + L.mlp(h, lp["mlp"], cfg)
    return x


def _logits(params, cfg: LMConfig, x):
    x = L.apply_norm(x, params["final_norm"], cfg)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def _embed(params, cfg: LMConfig, tokens, img_embeds):
    """Token embeddings, after a vlm's image embeddings (cast to the
    model's type) where given."""
    x = params["embed"][tokens]
    if cfg.family == "vlm" and img_embeds is not None:
        x = torch.cat([img_embeds.to(device=x.device, dtype=_dt(cfg)), x],
                      dim=1)
    return x


def _frames(cfg: LMConfig, frames):
    if cfg.family == "encdec" and frames is None:
        raise ValueError(f"{cfg.name}: the encdec family needs frames= "
                         "(B, S_enc, d_model) frame embeddings")
    return frames


def _run(params, cfg: LMConfig, x, frames, cache=None):
    """Every layer of any family over the embedded sequence x."""
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family in STACKED:
        return _run_stacked(params, cfg, x, positions, cache=cache)
    if cfg.family == "hybrid":
        return _run_hybrid(params, cfg, x, positions, cache=cache)
    enc_out = _encode(params, cfg, frames.to(x.device))
    return _run_decoder(params, cfg, x, positions, enc_out, cache=cache)


def forward(params, cfg: LMConfig, tokens: torch.Tensor, *,
            img_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: (B, S_text) integers on the parameters' device; a vlm takes
    ``img_embeds`` (B, S_img, d), an encdec ``frames`` (B, S_enc, d).
    Returns logits (B, S_total, V).  (The reference also returns the
    summed MoE aux loss, a training term.)"""
    if cfg.family == "vlm" and img_embeds is None:
        raise ValueError(f"{cfg.name}: the vlm family's forward needs "
                         "img_embeds=")
    x = _embed(params, cfg, tokens, img_embeds)
    return _logits(params, cfg, _run(params, cfg, x, _frames(cfg, frames)))


# ===========================================================================
# Serving: cache init / prefill / decode
# ===========================================================================

def init_cache(cfg: LMConfig, batch: int, max_len: int, device) -> Dict:
    dt = _dt(cfg)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family == "ssm":
        return {
            "ssm": zeros((cfg.n_layers, batch, cfg.ssm_heads,
                          cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
            "conv": zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                           cfg.d_inner + 2 * cfg.ssm_state))}
    if cfg.family == "hybrid":
        w = min(cfg.local_window, max_len)
        kv = (batch, cfg.n_kv, w, cfg.head_dim)
        return {"layers": [
            {"k": zeros(kv), "v": zeros(kv)} if cfg.layer_kind(i) == "attn"
            else {"lru": zeros((batch, cfg.lru_width), torch.float32),
                  "conv": zeros((batch, cfg.conv_kernel - 1, cfg.lru_width))}
            for i in range(cfg.n_layers)]}
    if cfg.family == "encdec":
        shape = (batch, cfg.n_kv, max_len, cfg.head_dim)
        xshape = (batch, cfg.n_kv, cfg.enc_positions, cfg.head_dim)
        return {"self": [{"k": zeros(shape), "v": zeros(shape)}
                         for _ in range(cfg.n_layers)],
                "cross": [{"k": zeros(xshape), "v": zeros(xshape)}
                          for _ in range(cfg.n_layers)]}
    shape = (cfg.n_layers, batch, cfg.n_kv, max_len, cfg.head_dim)
    return {"k": zeros(shape), "v": zeros(shape)}


def _write_kv(kc, vc, new_kv, pos: int) -> None:
    """Write (B, Hkv, S_new, hd) K/V into one layer's cache at ``pos``, in
    place."""
    k_t, v_t = new_kv
    s = k_t.shape[2]
    kc[:, :, pos:pos + s] = k_t
    vc[:, :, pos:pos + s] = v_t


def prefill(params, cfg: LMConfig, tokens: torch.Tensor, *, max_len: int,
            img_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None):
    """Full forward that also populates a fresh cache of size ``max_len``.
    A vlm's ``img_embeds`` (B, S_img, d) come before the text; an encdec
    needs ``frames`` (B, S_enc, d).  Returns (cache, last-position
    logits)."""
    frames = _frames(cfg, frames)
    x = _embed(params, cfg, tokens, img_embeds)
    cache = init_cache(cfg, tokens.shape[0], max_len, x.device)
    x = _run(params, cfg, x, frames, cache=cache)
    # only the last position's logits are returned: the norm and the head
    # act on each position alone, so the others are not computed
    return cache, _logits(params, cfg, x[:, -1:])[:, -1]


def _token_attn_decode(h, lp_attn, cfg, kc, vc, pos: int, cache_len: int,
                       window: int = 0):
    """One-token attention against (and updating, in place) one layer's
    cache; with ``window``, a ring whose slot ``pos % window`` takes the
    new K/V."""
    b = h.shape[0]
    kv, hd, hq = cfg.n_kv, cfg.head_dim, cfg.n_heads
    q = h @ lp_attn["wq"]
    k = h @ lp_attn["wk"]
    v = h @ lp_attn["wv"]
    if cfg.qkv_bias and "bq" in lp_attn:
        q, k, v = q + lp_attn["bq"], k + lp_attn["bk"], v + lp_attn["bv"]
    q = q.reshape(b, 1, hq, hd)
    k = k.reshape(b, 1, kv, hd)
    v = v.reshape(b, 1, kv, hd)
    posv = torch.full((b, 1), pos, device=h.device)
    q = L.rope(q, posv, cfg.rope_theta)
    k = L.rope(k, posv, cfg.rope_theta)
    write_at = pos % window if window else pos
    _write_kv(kc, vc, (k.transpose(1, 2), v.transpose(1, 2)), write_at)
    out = L.decode_attention(q.transpose(1, 2), kc, vc, cache_len)
    out = out.transpose(1, 2).reshape(b, 1, hq * hd)
    return out @ lp_attn["wo"]


def _decode_layer(x, lp, cfg: LMConfig, cl: Dict, pos: int,
                  cross: Optional[Dict] = None):
    """One hybrid or encdec decoder layer of a decode step, its cache
    entries ``cl`` (and ``cross``) updated in place."""
    h = L.apply_norm(x, lp["ln1"], cfg)
    if "rec" in lp:
        out, (lru, conv) = rglru.recurrent_block(
            h, lp["rec"], cfg, lru_state=cl["lru"], conv_state=cl["conv"],
            decode=True)
        cl.update(lru=lru, conv=conv)
    elif cfg.family == "hybrid":
        w = cl["k"].shape[2]
        out = _token_attn_decode(h, lp["attn"], cfg, cl["k"], cl["v"], pos,
                                 min(pos + 1, w), window=w)
    else:
        out = _token_attn_decode(h, lp["attn"], cfg, cl["k"], cl["v"], pos,
                                 pos + 1)
    x = x + out
    if cross is not None:
        h = L.apply_norm(x, lp["ln_x"], cfg)
        out, _ = L.attention(h, lp["xattn"], cfg, positions=None,
                             cross_kv=(cross["k"], cross["v"]))
        x = x + out
    h = L.apply_norm(x, lp["ln2"], cfg)
    return x + L.mlp(h, lp["mlp"], cfg)


def decode_step(params, cfg: LMConfig, token: torch.Tensor, cache: Dict,
                pos: int):
    """token: (B, 1) integers; pos: the current position index.  Returns
    (logits (B, V), cache), the cache updated in place."""
    pos = int(pos)
    x = params["embed"][token]
    if cfg.family == "hybrid":
        for i, lp in enumerate(params["layers_list"]):
            x = _decode_layer(x, lp, cfg, cache["layers"][i], pos)
    elif cfg.family == "encdec":
        for i, lp in enumerate(params["dec_layers"]):
            x = _decode_layer(x, lp, cfg, cache["self"][i], pos,
                              cross=cache["cross"][i])
    else:
        for i, lp in enumerate(_layers(params, cfg)):
            if cfg.family != "ssm":
                h = L.apply_norm(x, lp["ln1"], cfg)
                x = x + _token_attn_decode(h, lp["attn"], cfg,
                                           cache["k"][i], cache["v"][i],
                                           pos, pos + 1)
                h = L.apply_norm(x, lp["ln2"], cfg)
                x = x + _ffn(h, lp, cfg)
            else:
                normed = L.apply_norm(x, lp["norm"], cfg)
                out, (s_new, c_new) = ssm.mamba2_layer(
                    normed, lp, cfg, ssm_state=cache["ssm"][i],
                    conv_state=cache["conv"][i], decode=True)
                cache["ssm"][i] = s_new
                cache["conv"][i] = c_new
                x = x + out
    return _logits(params, cfg, x)[:, -1], cache
