"""Mamba-2 (SSD — state-space duality) layer, chunked: the port of the
reference's ``repro/models/lm/ssm.py``.

Within a chunk the recurrence is the masked quadratic form of
arXiv:2405.21060, computed by the kernel B4 (``kernels/ssd_chunk.py``: the
CUDA kernel on the card, its plain version on the CPU); across chunks it is
a linear state recurrence in torch.  Decode is the O(1)-state recurrent
step.  The reference's ``_segsum`` built the intra-chunk decay for its XLA
einsum; B4 takes the cumulative decays instead, so nothing here needs it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_intra
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.sharding import BATCH, local_kernel


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, H, P); dt: (B, T, H); a_log: (H,) [A = -exp(a_log)];
    b_mat, c_mat: (B, T, N) (single group, broadcast over heads).
    Returns (y (B, T, H, P), final_state (B, H, P, N))."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, t)
    pad = (-t) % q
    if pad:
        # dt=0 padding is exact: zero input contribution, unit decay
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    tp = t + pad
    nc = tp // q
    af = -torch.exp(a_log.float())                    # (H,) negative

    xd = (x * dt[..., None]).float()                  # dt-weighted inputs
    adt = dt.float() * af                             # (B, T, H) log decays

    xc = xd.reshape(bsz, nc, q, h, p)
    ac = adt.reshape(bsz, nc, q, h)
    bc = b_mat.float().reshape(bsz, nc, q, n)
    cc = c_mat.float().reshape(bsz, nc, q, n)
    cs = torch.cumsum(ac, dim=2)                      # (B, C, Q, H)

    # 1. intra-chunk: the masked quadratic form, through B4 in its layout
    #    (B*C, Q, N), (B*C, H, Q), (B*C, H, Q, P)
    y_diag = ssd_intra(
        cc.reshape(bsz * nc, q, n).contiguous(),
        bc.reshape(bsz * nc, q, n).contiguous(),
        cs.permute(0, 1, 3, 2).reshape(bsz * nc, h, q).contiguous(),
        xc.permute(0, 1, 3, 2, 4).reshape(bsz * nc, h, q, p).contiguous())
    y_diag = y_diag.reshape(bsz, nc, h, q, p).permute(0, 1, 3, 2, 4)

    # 2. per-chunk end states
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)   # (B, C, Q, H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bc, decay_to_end, xc)

    # 3. inter-chunk linear recurrence over the C axis
    chunk_decay = torch.exp(cs[:, :, -1, :])          # (B, C, H)
    s = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    starts = []                                       # state at chunk START
    for c in range(nc):
        starts.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_starts = torch.stack(starts, dim=1)             # (B, C, H, P, N)

    # 4. contribution of the carried-in state to each position
    decay_from_start = torch.exp(cs)                  # (B, C, Q, H)
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", cc, s_starts,
                         decay_from_start)

    y = (y_diag + y_off).reshape(bsz, tp, h, p)[:, :t]
    return y.to(x.dtype), s


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor,
                    state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent step.  x: (B, H, P); dt: (B, H); b,c: (B, N);
    state: (B, H, P, N)."""
    af = -torch.exp(a_log.float())
    dec = torch.exp(dt.float() * af)                  # (B, H)
    xd = (x * dt[..., None]).float()
    outer = torch.einsum("bhp,bn->bhpn", xd, b_mat.float())
    new_state = state * dec[:, :, None, None] + outer
    y = torch.einsum("bhpn,bn->bhp", new_state, c_mat.float())
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (the xBC short conv)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  conv_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, C); w: (K, C) depthwise.  Returns (y, new_state) where
    state carries the trailing K-1 positions for decode continuity."""
    k = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], k - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)            # (B, T+K-1, C)
    t = x.shape[1]
    y = xp[:, 0:t] * w[0][None, None]
    for i in range(1, k):
        y = y + xp[:, i:i + t] * w[i][None, None]
    new_state = xp[:, -(k - 1):] if k > 1 else conv_state
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba-2 layer
# ---------------------------------------------------------------------------

def mamba2_layer(x: torch.Tensor, p: Dict, cfg: LMConfig, *,
                 ssm_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None,
                 decode: bool = False):
    """x: (B, T, d) (T=1 for decode).  Returns (out, (ssm_state,
    conv_state))."""
    bsz, t, _ = x.shape
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = cfg.ssm_heads

    zxbcdt = x @ p["in_proj"]
    # torch.split takes sizes where the reference's jnp.split takes the
    # split points [di, 2*di + 2*n]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    xbc, new_conv = causal_conv1d(xbc, p["conv_w"], conv_state)
    xbc = F.silu(xbc)
    x_ssm, b_mat, c_mat = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    xh = x_ssm.reshape(bsz, t, nh, hd)
    # every batch row's SSD is its own: under a mesh each runs on its
    # shard of the batch (sharding.local_kernel), B4 on plain tensors
    rows = (BATCH, None, None, None)
    if decode:
        if ssm_state is None:
            ssm_state = torch.zeros((bsz, nh, hd, n), dtype=torch.float32,
                                    device=x.device)
        y, new_state = local_kernel(
            ssd_decode_step,
            (xh[:, 0], dt[:, 0], p["a_log"], b_mat[:, 0], c_mat[:, 0],
             ssm_state),
            (rows[:3], rows[:2], (None,), rows[:2], rows[:2], rows),
            out_like=(0, 5))
        y = y[:, None]
    else:
        args = (xh, dt, p["a_log"], b_mat, c_mat)
        specs = (rows, rows[:3], (None,), rows[:3], rows[:3])
        if ssm_state is not None:
            args, specs = args + (ssm_state,), specs + (rows,)

        def chunked(xh, dt, a_log, b_mat, c_mat, init_state=None):
            return ssd_chunked(xh, dt, a_log, b_mat, c_mat, cfg.ssm_chunk,
                               init_state=init_state)

        y, new_state = local_kernel(chunked, args, specs, out_like=(0, 0))
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(bsz, t, di)
    # gated RMSNorm (mamba2's norm_before_gate=False formulation)
    y = y * F.silu(z)
    var = y.float().square().mean(dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype) * p["norm_w"]
    return y @ p["out_proj"], (new_state, new_conv)
