"""Transformer building blocks of the dense family: norms, RoPE, attention,
MLP — the port of the reference's ``repro/models/lm/layers.py``.

Prefill attention is ``flash_attention`` (the signature of the reference's
``flash_attention_xla``): on a CUDA tensor it launches the hand-written
kernel B3, on a CPU tensor its plain version, which is the reference's
online-softmax loop.  Decode attention stays plain torch, as the reference
has no kernel for it.  The reference's MoE and cross-attention wait for
their families (ROADMAP A8); on one card the reference's ``shard_hint``
calls are the identity and are dropped (ROADMAP A10).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.models.lm.config import LMConfig

__all__ = ["NEG_INF", "apply_norm", "attention", "decode_attention",
           "flash_attention", "layernorm", "mlp", "rmsnorm", "rope"]


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


# ---------------------------------------------------------------------------
# Attention block (projections + rope + flash / cache paths)
# ---------------------------------------------------------------------------

def attention(x: torch.Tensor, p: Dict, cfg: LMConfig, *,
              positions: torch.Tensor, causal: bool = True, window: int = 0,
              kv_cache: Optional[Tuple] = None, cache_len=None):
    """x: (B, S, d).  Modes:
    * prefill: kv_cache None -> flash attention over x itself; returns
      (out, (k, v)) so prefill can seed a cache;
    * decode: kv_cache=(k, v) pre-updated with this token -> cache
      attention."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim

    def proj(name, heads):
        y = x @ p[f"w{name}"]
        if cfg.qkv_bias and f"b{name}" in p:
            y = y + p[f"b{name}"]
        return y.reshape(b, s, heads, hd)

    q = rope(proj("q", h), positions, cfg.rope_theta)
    key = rope(proj("k", kv), positions, cfg.rope_theta)
    val = proj("v", kv)

    qt = q.transpose(1, 2)                             # (B, H, S, hd)
    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        out = decode_attention(qt, k_cache, v_cache, cache_len)
        new_kv = (key.transpose(1, 2), val.transpose(1, 2))
    else:
        kt = key.transpose(1, 2).contiguous()
        vt = val.transpose(1, 2).contiguous()
        out = flash_attention(qt.contiguous(), kt, vt, causal=causal,
                              window=window, q_chunk=cfg.attn_q_chunk,
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
