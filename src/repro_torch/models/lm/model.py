"""LM model: parameter init, forward, prefill, decode — the ``dense``,
``moe`` and ``ssm`` families, ported from the reference's
``repro/models/lm/model.py``.

* Parameters keep the reference's tree: nested dicts whose layer leaves
  are stacked on a leading layer axis (``params["layers"]``), so
  ``engine.weights.lm_params_from_numpy`` carries the reference's
  parameters over unchanged.  The reference's ``lax.scan`` over that axis
  is a Python loop over layers here.
* The KV cache is ``(L, B, Hkv, max_len, hd)`` and the SSM/conv states
  ``(L, B, ...)``, as in the reference.  The reference returns new cache
  arrays from ``prefill`` and ``decode_step``; the port writes the new
  entries into the cache in place and returns the same dict, so a caller
  that keeps a cache across steps owns it (``LMSession.generate`` builds
  its own per call).
* A ``moe`` layer is a dense layer whose MLP is ``layers.moe_ffn``; it
  shares the dense family's K/V cache, prefill and decode.  ``forward``
  returns the logits only: the reference's summed MoE aux loss is for
  training (ROADMAP A10) and is checked at the ``moe_ffn`` level.
* The other families (hybrid, encdec, vlm) wait for ROADMAP A8; on one
  card the reference's ``shard_hint`` calls are the identity and are
  dropped (ROADMAP A10).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator

import torch

from repro_torch.models.lm import layers as L
from repro_torch.models.lm import ssm
from repro_torch.models.lm.config import FAMILIES as ALL_FAMILIES
from repro_torch.models.lm.config import LMConfig

FAMILIES = ("dense", "moe", "ssm")
# the most fp32 values one draw of ``_Init.mat`` makes (64 MiB), below one
# arctic-480b expert matrix (7168 x 4864)
DRAW_ELEMS = 1 << 24


def _dt(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_family(cfg: LMConfig) -> None:
    if cfg.family not in FAMILIES:
        missing = ", ".join(f for f in ALL_FAMILIES if f not in FAMILIES)
        raise NotImplementedError(
            f"the port runs the {FAMILIES} LM families; {cfg.name!r} is "
            f"{cfg.family!r}: the {missing} families wait for ROADMAP A8")


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


def init_params(cfg: LMConfig, seed: int = 0, device="cuda") -> Dict:
    """The reference's parameter tree and scales, drawn on ``device``."""
    check_family(cfg)
    ini = _Init(cfg, seed, device)
    p: Dict[str, Any] = {
        "embed": ini.mat((cfg.vocab, cfg.d_model), scale=0.02),
        "final_norm": {k: v[0] for k, v in _norm_p(ini, 1, cfg.d_model)
                       .items()},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ini.mat((cfg.d_model, cfg.vocab))
    if cfg.family == "ssm":
        p["layers"] = _ssm_layer_p(ini, cfg.n_layers)
    else:
        p["layers"] = _dense_layer_p(ini, cfg.n_layers)
    return p


def params_to(params: Dict, device) -> Dict:
    """The same tree with every tensor on ``device``."""
    return {k: params_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


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
    """A dense or moe layer's feed-forward block on (B, S, d)."""
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
    """One dense or moe layer; also returns its rope'd K/V for a cache."""
    h = L.apply_norm(x, lp["ln1"], cfg)
    attn_out, kv = L.attention(h, lp["attn"], cfg, positions=positions)
    x = x + attn_out
    h = L.apply_norm(x, lp["ln2"], cfg)
    return x + _ffn(h, lp, cfg), kv


def _run_stacked(params, cfg: LMConfig, x, positions, cache=None):
    """The layer loop.  With ``cache``, each layer's K/V (dense) or final
    SSM and conv states (ssm) are written into it at position 0."""
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


def _logits(params, cfg: LMConfig, x):
    x = L.apply_norm(x, params["final_norm"], cfg)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def forward(params, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) integers on the parameters' device.  Returns logits
    (B, S, V).  (The reference also returns the summed MoE aux loss, a
    training term.)"""
    check_family(cfg)
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    return _logits(params, cfg, _run_stacked(params, cfg, x, positions))


# ===========================================================================
# Serving: cache init / prefill / decode
# ===========================================================================

def init_cache(cfg: LMConfig, batch: int, max_len: int, device) -> Dict:
    check_family(cfg)
    dt = _dt(cfg)
    if cfg.family != "ssm":
        shape = (cfg.n_layers, batch, cfg.n_kv, max_len, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                            cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype=dt,
                            device=device)}


def _write_kv(kc, vc, new_kv, pos: int) -> None:
    """Write (B, Hkv, S_new, hd) K/V into one layer's cache at ``pos``, in
    place."""
    k_t, v_t = new_kv
    s = k_t.shape[2]
    kc[:, :, pos:pos + s] = k_t
    vc[:, :, pos:pos + s] = v_t


def prefill(params, cfg: LMConfig, tokens: torch.Tensor, *, max_len: int):
    """Full forward that also populates a fresh cache of size ``max_len``.
    Returns (cache, last-position logits)."""
    check_family(cfg)
    x = params["embed"][tokens]
    cache = init_cache(cfg, tokens.shape[0], max_len, x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_stacked(params, cfg, x, positions, cache=cache)
    # only the last position's logits are returned: the norm and the head
    # act on each position alone, so the others are not computed
    return cache, _logits(params, cfg, x[:, -1:])[:, -1]


def _token_attn_decode(h, lp_attn, cfg, kc, vc, pos: int, cache_len: int):
    """One-token attention against (and updating, in place) one layer's
    cache."""
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
    _write_kv(kc, vc, (k.transpose(1, 2), v.transpose(1, 2)), pos)
    out = L.decode_attention(q.transpose(1, 2), kc, vc, cache_len)
    out = out.transpose(1, 2).reshape(b, 1, hq * hd)
    return out @ lp_attn["wo"]


def decode_step(params, cfg: LMConfig, token: torch.Tensor, cache: Dict,
                pos: int):
    """token: (B, 1) integers; pos: the current position index.  Returns
    (logits (B, V), cache), the cache updated in place."""
    check_family(cfg)
    pos = int(pos)
    x = params["embed"][token]
    for i, lp in enumerate(_layers(params, cfg)):
        if cfg.family != "ssm":
            h = L.apply_norm(x, lp["ln1"], cfg)
            x = x + _token_attn_decode(h, lp["attn"], cfg, cache["k"][i],
                                       cache["v"][i], pos, pos + 1)
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
