"""Layout-aware layer implementations on torch tensors.

Every op here runs in whatever physical layout the planner assigned —
``NCHW`` or ``NCHW[x]c`` — without densifying back to the default layout.
Spatial dims sit at axes (2, 3) in both layouts, so pooling and padding
share code; channel-pointwise ops (batch-norm scale/shift) broadcast against
pre-blocked parameters the engine prepared at bind time (§3.2 weight
pre-transformation).  Blocked convolutions go through ``kernels/ops.py``
(the conv kernel, or the schedule's lowering); the rest are plain PyTorch
ops, as the reference left them to XLA.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.epilogue import EpilogueSpec, pool2d
from repro_torch.core.layout import Layout, relayout
from repro_torch.core.schedule import ConvSchedule
from repro_torch.kernels.ops import conv2d_block_blocked, conv2d_blocked


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

def conv2d_nchw_direct(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                       pad=0, groups: int = 1) -> torch.Tensor:
    """Unblocked direct conv — the Table 3 row-1 baseline template.  Same
    per-tap loop nest as the blocked plain version, over raw NCHW."""
    n, c, h, wd = x.shape
    k, c_per_g, kh, kw = w.shape
    ph, pw = (pad, pad) if isinstance(pad, int) else tuple(pad)
    xp = F.pad(x, (pw, pw, ph, ph))
    oh = (h + 2 * ph - kh) // stride + 1
    ow = (wd + 2 * pw - kw) // stride + 1
    kpg = k // groups
    outs = []
    for g in range(groups):
        xg = xp[:, g * c_per_g:(g + 1) * c_per_g]
        wg = w[g * kpg:(g + 1) * kpg]
        acc = torch.zeros((n, kpg, oh, ow), dtype=torch.float32,
                          device=x.device)
        for dh in range(kh):
            for dw in range(kw):
                patch = xg[:, :, dh:dh + oh * stride:stride,
                           dw:dw + ow * stride:stride]
                acc = acc + torch.einsum("nchw,kc->nkhw", patch.float(),
                                         wg[:, :, dh, dw].float())
        outs.append(acc)
    out = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return out.to(x.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           layout: Layout, *, stride: int = 1, pad=0,
           groups: int = 1, schedule: Optional[ConvSchedule] = None,
           use_kernel: bool = True, w_prelaid: bool = False
           ) -> torch.Tensor:
    """``w`` (and ``b``) arrive pre-transformed for ``layout``:
    KCRS for NCHW, KCRS[x]c[y]k for blocked (panel-major when the engine
    pre-laid a patch_gemm weight, ``w_prelaid``).  A blocked conv runs the
    conv kernel, or with ``use_kernel=False`` the schedule's lowering."""
    if layout.is_blocked:
        if groups != 1:
            raise ValueError("grouped convs run in NCHW")
        out = conv2d_blocked(x, w, stride=stride, pad=pad, schedule=schedule,
                             use_kernel=use_kernel, w_prelaid=w_prelaid)
    else:
        out = conv2d_nchw_direct(x, w, stride=stride, pad=pad, groups=groups)
    if b is not None:   # b pre-shaped (Ko, 1, 1, oc_bn) or (K, 1, 1)
        out = out + b[None]
    return out


def conv_block(x: torch.Tensor, w: torch.Tensor,
               scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
               residual: Optional[torch.Tensor], layout: Layout, *,
               stride: int = 1, pad=0, groups: int = 1, relu: bool = False,
               epilogue: Optional[EpilogueSpec] = None,
               out_buf: Optional[torch.Tensor] = None,
               schedule: Optional[ConvSchedule] = None,
               use_kernel: bool = True,
               w_prelaid: bool = False) -> torch.Tensor:
    """Fused CONV + composable epilogue (§3.1 operation fusion): per-channel
    affine (-> residual add) -> ReLU -> fused pooling, optionally stored at a
    channel offset into the shared concat buffer ``out_buf``.  ``w`` arrives
    pre-transformed for ``layout`` with the BN scale usually pre-folded in
    (then ``scale`` is None); ``scale``/``shift`` are pre-blocked
    per-channel vectors — ``(Ko, oc_bn)`` blocked, ``(C, 1, 1)`` in NCHW —
    and ``residual`` is in the conv's own output layout (conv resolution,
    pre-pool).  ``schedule``, ``use_kernel`` and ``w_prelaid`` as for
    ``conv2d``."""
    spec = (epilogue or EpilogueSpec()).with_relu(relu)
    if layout.is_blocked:
        if groups != 1:
            raise ValueError("grouped convs run in NCHW")
        return conv2d_block_blocked(
            x, w, scale, shift, residual, out_buf, stride=stride, pad=pad,
            epilogue=spec, schedule=schedule, use_kernel=use_kernel,
            w_prelaid=w_prelaid)
    out = conv2d_nchw_direct(x, w, stride=stride, pad=pad,
                             groups=groups).float()
    if scale is not None:
        out = out * scale[None]
    if shift is not None:
        out = out + shift[None]
    if residual is not None:
        out = out + residual.float()
    if spec.relu:
        out = torch.clamp_min(out, 0.0)
    if spec.pool is not None:
        out = spec.pool.apply(out)
    out = out.to(x.dtype)
    if spec.writes_concat:
        if out_buf is None:
            raise ValueError("concat-write epilogue needs out_buf")
        full = out_buf.clone()
        full[:, spec.concat_offset:spec.concat_offset + out.shape[1]] = out
        out = full
    return out


# ---------------------------------------------------------------------------
# Normalization / activations (inference-simplified, as TVM's passes do)
# ---------------------------------------------------------------------------

def batch_norm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               layout: Layout) -> torch.Tensor:
    """Inference BN folded to scale/shift; parameters pre-blocked:
    NCHW: (C, 1, 1);  NCHW[x]c: (C//x, 1, 1, x)."""
    return x * scale[None] + shift[None]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def softmax(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    if x.dim() == 2:
        return torch.softmax(x, dim=-1)
    dims = (1, 4) if layout.is_blocked else (1,)   # joint over (C//x, x)
    m = x.amax(dim=dims, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=dims, keepdim=True)


def l2_normalize(x: torch.Tensor, layout: Layout, eps: float = 1e-12
                 ) -> torch.Tensor:
    dims = (1, 4) if layout.is_blocked else (1,)
    sq = (x * x).sum(dim=dims, keepdim=True)
    return x * torch.rsqrt(sq + eps)


# ---------------------------------------------------------------------------
# Pooling — spatial axes are (2, 3) in both layouts
# ---------------------------------------------------------------------------

def max_pool(x, k, stride=None, pad=0, ceil_mode=False):
    return pool2d(x, k, stride or k, pad, ceil_mode, "max")


def avg_pool(x, k, stride=None, pad=0, ceil_mode=False):
    return pool2d(x, k, stride or k, pad, ceil_mode, "avg")


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=True)


# ---------------------------------------------------------------------------
# Structure ops
# ---------------------------------------------------------------------------

def add(*xs: torch.Tensor) -> torch.Tensor:
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def concat(xs: Sequence[torch.Tensor], layout: Layout) -> torch.Tensor:
    # channel concat: super-channel axis is 1 in NCHW, blocked, and 2-D
    return torch.cat(list(xs), dim=1)


def concat_alloc(xs: Sequence[torch.Tensor], offsets: Sequence[int],
                 total_channels: int, layout: Layout) -> torch.Tensor:
    """Seed the shared concat buffer for concat-aware fusion: allocate the
    full ``total_channels`` buffer and place the *pass-through* operands (the
    ones whose producers could not take a fused channel-offset write) at
    their channel offsets.  The fused conv_block producers then write their
    own slices into this buffer."""
    ref = xs[0]
    x = layout.block if layout.is_blocked else 1
    if total_channels % x:
        raise ValueError(f"{total_channels} channels do not block by {x}")
    buf = torch.zeros((ref.shape[0], total_channels // x) + ref.shape[2:],
                      dtype=ref.dtype, device=ref.device)
    for arr, off in zip(xs, offsets):
        if off % x:
            raise ValueError(f"offset {off} is not on a block of {x}")
        buf[:, off // x:off // x + arr.shape[1]] = arr
    return buf


def flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]
          ) -> torch.Tensor:
    out = x @ w
    return out + b[None] if b is not None else out


def layout_transform(x: torch.Tensor, src: Layout, dst: Layout
                     ) -> torch.Tensor:
    if x.dim() == 2:   # flattened tensors carry the default layout tag only
        return x
    return relayout(x, src, dst)
