"""Data layouts for feature maps and convolution kernels (NeoCPU §3.1/§3.2).

The paper's central data structure is the blocked feature-map layout
``NCHW[x]c`` — channel dimension split into ``C//x`` super-channels with an
innermost sub-channel block of size ``x`` — and the matching kernel layout
``KCRS[x]c[y]k``.

Layouts are values; ``relayout`` moves a torch tensor between them.  The
pipeline (``core/pipeline.py``) decides where those moves happen.  The
layout types and shape arithmetic are copies of the JAX reference's, so
plans cross between the two packages unchanged.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch


class LayoutKind(enum.Enum):
    NCHW = "NCHW"
    NHWC = "NHWC"
    NCHWc = "NCHWc"  # blocked: N, C//x, H, W, x


@dataclasses.dataclass(frozen=True, order=True)
class Layout:
    """A feature-map layout; ``block`` is the x in NCHW[x]c (0 = unblocked)."""

    kind: LayoutKind
    block: int = 0

    def __post_init__(self):
        if self.kind is LayoutKind.NCHWc and self.block <= 0:
            raise ValueError("NCHWc layout requires a positive channel block")
        if self.kind is not LayoutKind.NCHWc and self.block:
            raise ValueError(f"{self.kind} layout takes no block")

    @property
    def is_blocked(self) -> bool:
        return self.kind is LayoutKind.NCHWc

    def __str__(self) -> str:
        if self.is_blocked:
            return f"NCHW{self.block}c"
        return self.kind.value


NCHW = Layout(LayoutKind.NCHW)
NHWC = Layout(LayoutKind.NHWC)


def nchwc(block: int) -> Layout:
    return Layout(LayoutKind.NCHWc, block)


class LayoutCategory(enum.Enum):
    """NeoCPU §3.2 operation classification."""

    OBLIVIOUS = "oblivious"  # ReLU, Softmax, ElemwiseAdd, Concat (channel axis aware)
    TOLERANT = "tolerant"    # CONV, BatchNorm, Pooling — several layouts OK
    DEPENDENT = "dependent"  # Flatten, Reshape, Dense — one specific layout


# ---------------------------------------------------------------------------
# Shape bookkeeping
# ---------------------------------------------------------------------------

def blocked_shape(nchw_shape: Tuple[int, ...], layout: Layout) -> Tuple[int, ...]:
    """Physical shape of a logical NCHW tensor stored in ``layout``."""
    n, c, h, w = nchw_shape
    if layout.kind is LayoutKind.NCHW:
        return (n, c, h, w)
    if layout.kind is LayoutKind.NHWC:
        return (n, h, w, c)
    x = layout.block
    if c % x:
        raise ValueError(f"channels {c} not divisible by block {x}")
    return (n, c // x, h, w, x)


def logical_nchw_shape(shape: Tuple[int, ...], layout: Layout) -> Tuple[int, ...]:
    if layout.kind is LayoutKind.NCHW:
        return tuple(shape)
    if layout.kind is LayoutKind.NHWC:
        n, h, w, c = shape
        return (n, c, h, w)
    n, co, h, w, x = shape
    return (n, co * x, h, w)


# ---------------------------------------------------------------------------
# Relayout (the LayoutTransform node's compute)
# ---------------------------------------------------------------------------

def to_nchwc(x_nchw: torch.Tensor, block: int) -> torch.Tensor:
    n, c, h, w = x_nchw.shape
    if c % block:
        raise ValueError(f"channels {c} not divisible by block {block}")
    return x_nchw.reshape(n, c // block, block, h, w).permute(0, 1, 3, 4, 2) \
        .contiguous()


def from_nchwc(x_blocked: torch.Tensor) -> torch.Tensor:
    n, co, h, w, x = x_blocked.shape
    return x_blocked.permute(0, 1, 4, 2, 3).reshape(n, co * x, h, w) \
        .contiguous()


def relayout(arr: torch.Tensor, src: Layout, dst: Layout) -> torch.Tensor:
    """Move ``arr`` from layout ``src`` to ``dst`` (logical NCHW semantics).
    The result is contiguous in ``dst``: the conv kernel reads it raw."""
    if src == dst:
        return arr
    # normalize through NCHW
    if src.kind is LayoutKind.NCHW:
        as_nchw = arr
    elif src.kind is LayoutKind.NHWC:
        as_nchw = arr.permute(0, 3, 1, 2).contiguous()
    else:
        as_nchw = from_nchwc(arr)
    if dst.kind is LayoutKind.NCHW:
        return as_nchw
    if dst.kind is LayoutKind.NHWC:
        return as_nchw.permute(0, 2, 3, 1).contiguous()
    return to_nchwc(as_nchw, dst.block)


# ---------------------------------------------------------------------------
# Kernel (weight) layouts — pre-transformed at compile time (§3.2)
# ---------------------------------------------------------------------------

def kernel_to_kcrs_ck(w_kcrs: torch.Tensor, ic_bn: int,
                      oc_bn: int) -> torch.Tensor:
    """KCRS -> KCRS[ic_bn]c[oc_bn]k: (K//y, C//x, R, S, x, y)."""
    k, c, r, s = w_kcrs.shape
    if k % oc_bn or c % ic_bn:
        raise ValueError(
            f"kernel {tuple(w_kcrs.shape)} not divisible by ({ic_bn},{oc_bn})")
    w = w_kcrs.reshape(k // oc_bn, oc_bn, c // ic_bn, ic_bn, r, s)
    # (Ko, Ci, R, S, ic_bn, oc_bn)
    return w.permute(0, 2, 4, 5, 3, 1).contiguous()


def kernel_from_kcrs_ck(w_blocked: torch.Tensor) -> torch.Tensor:
    ko, ci, r, s, x, y = w_blocked.shape
    return w_blocked.permute(0, 5, 1, 4, 2, 3).reshape(ko * y, ci * x, r, s)


# ---------------------------------------------------------------------------
# Transform cost (bytes moved) — feeds the planner's edge costs
# ---------------------------------------------------------------------------

def transform_bytes(nchw_shape: Tuple[int, ...], src: Layout, dst: Layout,
                    dtype_bytes: int = 4) -> int:
    """Bytes read+written by a relayout; 0 when layouts match."""
    if src == dst:
        return 0
    return 2 * int(np.prod(nchw_shape)) * dtype_bytes


def candidate_blocks(channels: int, max_block: int = 128) -> list[int]:
    """All factors of ``channels`` up to ``max_block`` (paper §3.3.1 step 1),
    ordered as the reference orders them: multiples of 128 first, then 8,
    descending."""
    facs = [f for f in range(1, min(channels, max_block) + 1) if channels % f == 0]

    def pref(f: int):
        return (f % 128 != 0, f % 8 != 0, -f)

    return sorted(facs, key=pref)
