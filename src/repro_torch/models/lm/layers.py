"""Transformer building blocks: norms, RoPE, attention, MLP, MoE — the
port of the reference's ``repro/models/lm/layers.py``.

Prefill attention is ``flash_attention`` (the signature of the reference's
``flash_attention_xla``): on a CUDA tensor it launches the hand-written
kernel B3, on a CPU tensor its plain version, which is the reference's
online-softmax loop.  Decode attention stays plain torch, as the reference
has no kernel for it; a window's ring (the hybrid family) is read
through the same function.

MoE is the reference's capacity-dropping formulation: the router's
``softmax(x @ router)`` is ``dense_softmax``, which on a CUDA tensor
launches the hand-written blocked matmul B2 with the softmax fused into its
tail; tokens are ranked within their chosen expert by a stable sort,
scattered into an (E, capacity, d) buffer, run through batched expert
products and combined with their top-k gates.  Cross-attention (whisper's
decoder) is ``flash_attention`` too, its keys the encoder's S_enc
positions against S queries, S_enc != S: B3 takes a kv length of its own.

Under a mesh (``sharding.use_mesh``) the activations are DTensors: the
reference's ``shard_hint`` and ``shard_attn_q`` calls redistribute them;
B3, B2 and decode attention run on their local shards
(``sharding.local_kernel``), and the MoE's routing, dispatch and combine
on every rank over all tokens, its expert products expert-parallel.
Outside a mesh those calls are the identity.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.kernels.ops import dense_softmax
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.sharding import (BATCH, MODEL, attn_kernel_spec,
                                            current_mesh, local_kernel,
                                            shard_attn_q, shard_heads,
                                            shard_hint)

__all__ = ["NEG_INF", "apply_norm", "attention", "decode_attention",
           "sharded_decode_attention", "sharded_flash_attention",
           "flash_attention", "layernorm", "mlp", "moe_capacity", "moe_ffn",
           "rmsnorm", "rope"]


# ---------------------------------------------------------------------------
# Norms: normalise in fp32, cast to x's type, then scale (the reference's
# cast order)
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def apply_norm(x: torch.Tensor, p: Dict, cfg: LMConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Single-position attention against a cache
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """Single-position attention against a (B, Hkv, S_max, D) cache.
    ``cache_len`` (an int, or one length per batch row) masks positions
    >= the currently valid length.  With an int, only the first
    ``cache_len`` positions are read: the masked ones would add exact
    zeros to the softmax's sums."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    if isinstance(cache_len, int):
        k_cache = k_cache[:, :, :cache_len]
        v_cache = v_cache[:, :, :cache_len]
    qg = q.reshape(b, hkv, g, d)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg.float(),
                          k_cache.float()) / math.sqrt(d)
    if not isinstance(cache_len, int):
        smax = k_cache.shape[2]
        lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
        valid = torch.arange(smax, device=q.device)[None] < lens
        logits = torch.where(valid[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _contiguous(fn):
    """``fn`` on contiguous copies of its tensors (a DTensor's local shard
    need not be one, and the kernels read raw pointers)."""
    return lambda *ts: fn(*(t.contiguous() for t in ts))


def sharded_flash_attention(q, k, v, **kw) -> torch.Tensor:
    """``flash_attention`` (B3); under a mesh on the local shards of q, k
    and v (``sharding.attn_kernel_spec``)."""
    fn = _contiguous(functools.partial(flash_attention, **kw))
    mesh = current_mesh()
    if mesh is None:
        return fn(q, k, v)
    spec = attn_kernel_spec(mesh, q.shape[1], k.shape[1])
    return local_kernel(fn, (q, k, v), (spec,) * 3)


def sharded_decode_attention(q, k_cache, v_cache, cache_len
                             ) -> torch.Tensor:
    """``decode_attention``; under a mesh on the local shards of q and the
    cache, under B3's spec (``sharding.attn_kernel_spec``)."""
    fn = functools.partial(decode_attention, cache_len=cache_len)
    mesh = current_mesh()
    if mesh is None:
        return fn(q, k_cache, v_cache)
    spec = attn_kernel_spec(mesh, q.shape[1], k_cache.shape[1])
    return local_kernel(fn, (q, k_cache, v_cache), (spec,) * 3)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + flash / cache paths)
# ---------------------------------------------------------------------------

def attention(x: torch.Tensor, p: Dict, cfg: LMConfig, *,
              positions: torch.Tensor, causal: bool = True, window: int = 0,
              kv_cache: Optional[Tuple] = None, cache_len=None,
              cross_kv: Optional[Tuple] = None, use_rope: bool = True):
    """x: (B, S, d).  Modes:
    * prefill: kv_cache None -> flash attention over x itself; returns
      (out, (k, v)) so prefill can seed a cache;
    * decode: kv_cache=(k, v) pre-updated with this token -> cache
      attention;
    * cross: cross_kv=(k, v) (B, Hkv, S_enc, hd) from the encoder
      (whisper) -> flash attention of the S queries against the S_enc
      keys, no mask and no RoPE; returns (out, None).
    ``use_rope=False`` leaves q and k unrotated (whisper's encoder)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim

    def proj(name, heads):
        y = x @ p[f"w{name}"]
        if cfg.qkv_bias and f"b{name}" in p:
            y = y + p[f"b{name}"]
        return shard_heads(y, heads).reshape(b, s, heads, hd)

    q = proj("q", h)
    if cross_kv is not None:
        ck, cv = cross_kv
        # the reference's flash_attention_xla with its default chunks
        out = sharded_flash_attention(q.transpose(1, 2), ck, cv,
                                      causal=False)
        return out.transpose(1, 2).reshape(b, s, h * hd) @ p["wo"], None
    key = proj("k", kv)
    val = proj("v", kv)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        key = rope(key, positions, cfg.rope_theta)

    qt = q.transpose(1, 2)                             # (B, H, S, hd)
    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        out = sharded_decode_attention(qt, k_cache, v_cache, cache_len)
        new_kv = (key.transpose(1, 2), val.transpose(1, 2))
    else:
        kt = key.transpose(1, 2).contiguous()
        vt = val.transpose(1, 2).contiguous()
        # per-op activation layout: heads on the model axis where they
        # divide it, else sequence-parallel q (kv gathered; cheap for GQA)
        qt = shard_attn_q(qt, h)
        kt = shard_attn_q(kt, kv)
        vt = shard_attn_q(vt, kv)
        out = sharded_flash_attention(qt, kt, vt, causal=causal,
                                      window=window,
                                      q_chunk=cfg.attn_q_chunk,
                                      kv_chunk=cfg.attn_kv_chunk)
        new_kv = (kt, vt)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ p["wo"], new_kv


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, p: Dict, cfg: LMConfig) -> torch.Tensor:
    if cfg.mlp_gated:
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return F.gelu(x @ p["wu"], approximate="tanh") @ p["wd"]


# ---------------------------------------------------------------------------
# Mixture of experts (capacity-dropping, sort-based dispatch)
# ---------------------------------------------------------------------------

def moe_capacity(n_tokens: int, cfg: LMConfig) -> int:
    cap = math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                    * cfg.capacity_factor)
    # tiny token counts (decode steps) run dropless: the buffer is small
    # and drops would make serving non-deterministic against prefill
    floor = n_tokens * cfg.top_k if n_tokens * cfg.top_k <= 64 else 1
    return max(floor, min(cap, n_tokens * cfg.top_k))


def _top_k(probs: torch.Tensor, k: int):
    """The top-k gates of each row (descending), renormalised, and their
    experts."""
    gates, eids = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, eids


def _dispatch(x: torch.Tensor, eids: torch.Tensor, e: int, cap: int):
    """Scatter the (T, d) tokens into the (E, capacity, d) buffer of their
    chosen experts: each assignment ranked within its expert, token-major
    and rank-minor, as the reference's stable argsort does, past the
    capacity dropped.  Also each assignment's expert, slot and kept flag,
    and the fraction routed to each expert (the load-balance loss's f)."""
    t, d = x.shape
    k = eids.shape[1]
    dev = x.device
    flat_e = eids.reshape(-1)                                  # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos_sorted = torch.arange(t * k, device=dev) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap - 1)
    tok = torch.arange(t * k, device=dev) // k

    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev)
    contrib = torch.where(keep[:, None], x[tok], 0)
    buf.index_put_((flat_e, safe_pos), contrib, accumulate=True)
    f = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, keep.float()) / (t * k)
    return buf, flat_e, safe_pos, keep, f


def _combine(out_buf, flat_e, safe_pos, keep, gates, dtype):
    """Each token's kept expert outputs, weighted by its gates."""
    t, k = gates.shape
    d = out_buf.shape[-1]
    y_tok = out_buf[flat_e, safe_pos] * keep[:, None]         # (T*K, d)
    return (y_tok.reshape(t, k, d) * gates[..., None].to(dtype)).sum(dim=1)


def moe_ffn(x: torch.Tensor, p: Dict, cfg: LMConfig
            ) -> Tuple[torch.Tensor, Dict]:
    """x: (T, d) token-major.  Returns (out, aux), where aux carries the
    load-balance loss term (Shazeer-style f.P) and the dropped share of
    the token-expert assignments.  Under a mesh the routing, the dispatch
    and the combine run on every rank over all T tokens (the capacity is
    the whole batch's), and the expert products expert-parallel."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(t, cfg)
    everywhere = (None, None)

    # the reference's fp32 logits of x.astype(f32) @ router.astype(f32): B2
    # sums in fp32 whatever the operands' type, so bf16 operands pass as
    # they are (the product of two bf16 numbers is exact in fp32)
    probs = local_kernel(                                      # (T, E)
        _contiguous(functools.partial(dense_softmax,
                                      out_dtype=torch.float32)),
        (x, p["router"]), ((BATCH, None), everywhere))
    gates, eids = local_kernel(functools.partial(_top_k, k=k), (probs,),
                               ((BATCH, None),), out_like=(0, 0))
    buf, flat_e, safe_pos, keep, f = local_kernel(
        functools.partial(_dispatch, e=e, cap=cap), (x, eids),
        (everywhere, everywhere), out_like=(0,) * 5)
    # expert-parallel buffer layout: E on the model axis, capacity rows on
    # the DP axes (the dispatch becomes the EP all-to-all)
    buf = shard_hint(buf, MODEL, BATCH, None)

    # batched expert products: plain large GEMMs, as in the reference
    ex = p["experts"]
    if cfg.mlp_gated:
        hdn = F.silu(torch.bmm(buf, ex["wg"])) * torch.bmm(buf, ex["wu"])
    else:
        hdn = F.gelu(torch.bmm(buf, ex["wu"]), approximate="tanh")
    out_buf = torch.bmm(hdn, ex["wd"])

    y = local_kernel(functools.partial(_combine, dtype=x.dtype),
                     (out_buf, flat_e, safe_pos, keep, gates),
                     ((None,) * 3, (None,), (None,), (None,), everywhere))

    # load-balance loss: E * sum_e fraction_routed(e) * mean_prob(e)
    aux = {"lb_loss": e * (f * probs.mean(dim=0)).sum(),
           "dropped_frac": 1.0 - keep.float().mean()}
    return y, aux
