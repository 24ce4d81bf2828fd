"""Per-output-channel symmetric int8 weight quantization.

A copy of the JAX reference's ``repro/core/quantize.py``.  It stays numpy:
the engine quantizes once at bind time, on the host, so the int8 codes are
bit-identical to the reference's for the same weights.

The quantized template is just another point on the schedule axis
(``ConvSchedule.dtype == "int8"``): weights are quantized once at
``bind_params`` time, the int8 integer values flow through the same
blocked-layout transforms as fp32 weights, and the dequantize scale rides
the shared epilogue's per-channel ``scale`` operand exactly the way an
unfolded BN scale does.

Scheme (weight-only, a.k.a. W8): for output channel ``k``,

    scale[k] = max(|w[k]|) / 127
    q[k]     = round(w[k] / scale[k])  clipped to [-127, 127]  (int8)

so ``q[k] * scale[k]`` reconstructs ``w[k]`` to within ``scale[k] / 2``
per element.  Symmetric means zero maps to zero (no zero-point), which is
what lets the scale commute past the convolution and land in the
epilogue: ``conv(x, q) * scale == conv(x, q * scale)`` per channel.
All-zero channels get ``scale = 1`` so they round-trip exactly and never
divide by zero.

Activations stay fp32, and the int8 forms of ``kernels/ops.py`` upcast the
codes at the product, as the reference's do.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# int8 symmetric range: +-127 (the -128 code is unused so the range is
# symmetric and negation stays exact)
QMAX = 127


def quantize_per_channel(w: np.ndarray, axis: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize ``w`` to int8 with one symmetric scale per ``axis`` slice
    (axis 0 = output channels for KCRS conv weights and for ``(C,)``-major
    vectors alike).  Returns ``(q, scale)`` with ``q`` int8 of ``w``'s
    shape and ``scale`` float32 of shape ``(w.shape[axis],)``."""
    w = np.asarray(w, dtype=np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.max(np.abs(w), axis=reduce_axes) if reduce_axes \
        else np.abs(w)
    # all-zero channels: scale 1 keeps the round trip exact (0 * 1 == 0)
    scale = np.where(amax > 0.0, amax / QMAX, 1.0).astype(np.float32)
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -QMAX, QMAX)
    return q.astype(np.int8), scale


def dequantize_per_channel(q: np.ndarray, scale: np.ndarray, axis: int = 0
                           ) -> np.ndarray:
    """Inverse of :func:`quantize_per_channel`: ``q * scale`` broadcast
    along ``axis``."""
    q = np.asarray(q)
    shape = [1] * q.ndim
    shape[axis] = -1
    return (q.astype(np.float32)
            * np.asarray(scale, np.float32).reshape(shape))


def quantization_error_bound(scale: np.ndarray) -> np.ndarray:
    """Per-channel worst-case absolute reconstruction error: half a
    quantization step (the property the round-trip tests assert)."""
    return np.asarray(scale, np.float32) / 2.0
