"""Composable conv_block epilogue spec (NeoCPU §3.1, extended).

The fused epilogue is a planned, costed, searched axis rather than a fixed
tail.  Two stages go beyond the paper's ``scale/shift -> residual -> ReLU``:

* **fused pooling** — a ``conv_block -> max_pool/avg_pool`` chain collapses:
  the pooling reduction runs on the fp32 conv values before they are
  stored, so the stem ``conv7x7 -> bn -> relu -> max_pool3x3s2`` becomes one
  kernel and the conv-resolution tensor never reaches device memory
  (the fused-downsampling epilogue of Georganas et al., 1808.05567).
* **concat-aware output placement** — DenseNet's ``concat(conv outs)`` fuses
  by giving each producing conv_block a channel-offset write into the shared
  concat buffer, eliminating the copy the standalone concat would do.

The spec is a frozen (hashable) dataclass.  The *presence* of the
affine/residual operands is conveyed by the tensors themselves (None or
not); the spec carries only the structural knobs the kernels specialize on.

Epilogue application order is fixed:

    acc = conv(x)                      # fp32 accumulator
    acc = acc * scale + shift          # absorbed BN (folded at bind time)
    acc = acc + residual               # ResNet tail, conv resolution
    acc = relu(acc)                    # before pooling, as in the zoo graphs
    acc = pool(acc)                    # spatial reduction on fp32 values
    out[.., off:off+C, ..] = acc       # channel-offset store (concat fusion)

The LM side adds the matmul-tail stages, applied to the fp32 accumulator
of a blocked matmul (``kernels/matmul_blocked.py``, B2), in this order:

    acc = acc * scale                  # e.g. 1/sqrt(head_dim)
    acc = mask(acc)                    # "causal": NEG_INF above the diagonal
    acc = softmax(acc, axis=-1)        # row softmax over the full N extent
    acc = relu(acc)

``pool2d``, ``PoolSpec``, ``EpilogueSpec``, ``apply_matmul_epilogue`` and
``fold_dequant_scale`` are the JAX reference's (``repro/core/epilogue.py``)
on torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30   # matches kernels.flash_attention.NEG_INF


def _pool_out_hw(h: int, w: int, k: int, stride: int, pad: int,
                 ceil_mode: bool) -> Tuple[int, int]:
    """The one copy of the pooled output-size arithmetic (floor/ceil)."""
    if ceil_mode:
        oh = -(-(h + 2 * pad - k) // stride) + 1
        ow = -(-(w + 2 * pad - k) // stride) + 1
    else:
        oh = (h + 2 * pad - k) // stride + 1
        ow = (w + 2 * pad - k) // stride + 1
    return oh, ow


def pool2d(x: torch.Tensor, k: int, stride: int, pad: int = 0,
           ceil_mode: bool = False, reducer: str = "max") -> torch.Tensor:
    """Window pooling over axes (2, 3) of an arbitrary-rank tensor — THE
    pooling implementation of the port's plain path: logical NCHW, blocked
    NCHW[x]c and the 5-D fp32 accumulator of the fused plain epilogue all
    reduce through this one body.  Padded taps are ``-inf`` for max and 0
    for avg; the avg divides by ``k*k`` whatever the padding, and ceil mode
    pads the far side so the last window fits, both as in the reference."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = _pool_out_hw(h, w, k, stride, pad, ceil_mode)
    if ceil_mode:
        eh = (oh - 1) * stride + k - h - pad
        ew = (ow - 1) * stride + k - w - pad
    else:
        eh, ew = pad, pad
    fill = float("-inf") if reducer == "max" else 0.0
    # F.pad lists widths from the last axis backwards: keep axes 4.. whole
    widths = [0, 0] * (x.dim() - 4) + [pad, max(ew, pad), pad, max(eh, pad)]
    xp = F.pad(x, widths, value=fill)
    acc = None
    for dh in range(k):
        for dw in range(k):
            patch = xp[:, :, dh:dh + oh * stride:stride,
                       dw:dw + ow * stride:stride]
            if acc is None:
                acc = patch
            elif reducer == "max":
                acc = torch.maximum(acc, patch)
            else:
                acc = acc + patch
    if reducer == "avg":
        acc = acc / (k * k)
    return acc.contiguous()


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """A pooling reduction fused into the conv epilogue."""

    kind: str                 # "max" | "avg"
    k: int
    stride: int
    pad: int = 0
    ceil_mode: bool = False

    def __post_init__(self):
        if self.kind not in ("max", "avg"):
            raise ValueError(f"pool kind {self.kind!r} not in ('max', 'avg')")

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        """Pooled spatial dims (matches ``pool2d``'s output)."""
        return _pool_out_hw(h, w, self.k, self.stride, self.pad,
                            self.ceil_mode)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Run this pooling reduction over axes (2, 3) of ``x``."""
        return pool2d(x, self.k, self.stride, self.pad, self.ceil_mode,
                      self.kind)


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Static structure of a conv_block's fused epilogue.

    ``concat_total`` > 0 means the block stores into a shared concat buffer
    of that many channels, at channel offset ``concat_offset`` — the kernel
    then receives the buffer and returns it with the block's slice written.

    The matmul-tail stages (``scale``, ``mask``, ``softmax``) belong to the
    blocked-matmul kernel and are mutually exclusive with pooling/concat,
    which are conv-side spatial stages.
    """

    relu: bool = False
    pool: Optional[PoolSpec] = None
    concat_offset: int = 0
    concat_total: int = 0
    scale: Optional[float] = None
    mask: str = "none"        # "none" | "causal"
    softmax: bool = False

    def __post_init__(self):
        if self.mask not in ("none", "causal"):
            raise ValueError(f"mask {self.mask!r} not in ('none', 'causal')")
        if self.has_matmul_tail and (self.pool is not None
                                     or self.concat_total > 0):
            raise ValueError(
                "matmul-tail stages (scale/mask/softmax) cannot combine "
                "with conv-side pooling or concat placement")
        if self.softmax and self.relu:
            raise ValueError("softmax and relu are mutually exclusive "
                             "epilogue tails")

    @property
    def has_matmul_tail(self) -> bool:
        return (self.scale is not None or self.mask != "none"
                or self.softmax)

    @property
    def writes_concat(self) -> bool:
        return self.concat_total > 0

    def with_relu(self, relu: bool) -> "EpilogueSpec":
        if relu and not self.relu:
            return dataclasses.replace(self, relu=True)
        return self

    def out_hw(self, oh: int, ow: int) -> Tuple[int, int]:
        """Stored spatial dims for a conv-resolution (oh, ow)."""
        return self.pool.out_hw(oh, ow) if self.pool is not None else (oh, ow)

    def out_channels(self, conv_channels: int) -> int:
        """Stored channel count (the concat buffer's, if fused)."""
        return self.concat_total if self.writes_concat else conv_channels


IDENTITY = EpilogueSpec()


def apply_matmul_epilogue(acc: torch.Tensor, spec: EpilogueSpec, *,
                          row0: int = 0, col0: int = 0,
                          n_valid: Optional[int] = None) -> torch.Tensor:
    """Apply a matmul-tail epilogue to an fp32 accumulator block.

    The one body of the port's plain path: ``matmul_plain`` runs it on each
    accumulator block, as the reference's Pallas kernel does at its last
    k-step, and the CUDA kernel of ``csrc/matmul_blocked.cu`` computes the
    same stages in the same order.  ``row0``/``col0`` locate the block in
    the logical (M, N) output (the causal mask needs absolute
    coordinates).  ``n_valid`` masks padded columns ``>= n_valid`` to
    NEG_INF before the softmax, so the exp-sum of a padded row matches the
    unpadded one; it is ignored without softmax (padded columns are sliced
    away anyway)."""
    bm, bn = acc.shape[-2], acc.shape[-1]
    if spec.scale is not None:
        acc = acc * spec.scale
    mask_cols = spec.softmax and n_valid is not None and n_valid < bn
    if spec.mask == "causal" or mask_cols:
        cols = col0 + torch.arange(bn, device=acc.device)
    if spec.mask == "causal":
        rows = row0 + torch.arange(bm, device=acc.device)
        acc = torch.where(rows[:, None] >= cols[None, :], acc, NEG_INF)
    if spec.softmax:
        if mask_cols:
            acc = torch.where(cols < n_valid, acc, NEG_INF)
        m = acc.amax(dim=-1, keepdim=True)
        p = torch.exp(acc - m)
        acc = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    if spec.relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc


def fold_dequant_scale(scale: Optional[torch.Tensor],
                       w_scale: Optional[torch.Tensor]
                       ) -> Optional[torch.Tensor]:
    """Fold a per-output-channel weight-dequantize scale into the epilogue's
    ``scale`` operand, exactly the way BN folding composes at bind time:
    scales multiply (the affine stage applies their product once), and an
    absent epilogue scale just becomes the dequant scale.  Shift is
    untouched: symmetric quantization has no zero-point."""
    if w_scale is None:
        return scale
    w_scale = torch.as_tensor(w_scale, dtype=torch.float32)
    if scale is None:
        return w_scale
    return scale * w_scale.to(scale.device)
