"""Engine-facing entries: the convs on blocked tensors and the LM's fused
matmul tails.

The conv entries consume the NCHW[x]c / KCRS[x]c[y]k tensors the planner
produces and go through the one conv kernel (``kernels/conv2d_nchwc.py``,
B1): on a CUDA tensor its sm90 route, a 3xTF32 implicit GEMM on the tensor
cores (``csrc/conv2d_nchwc_sm90.cu``, which replaces the reference's
``conv2d_nchwc_pallas`` and is bound by its operations), on a CPU tensor
its plain version.  Like the reference's Pallas path, the port ignores the
schedule's ``variant`` and tile knobs; the reference's four XLA lowerings
and its int8 forms wait for ROADMAP A3.

``dense_softmax`` and ``attention_probs`` are the reference's LM-side
instantiations of the blocked matmul (``kernels/matmul_blocked.py``, B2):
the row softmax, and the attention tail before it, run on the fp32 sums
inside the kernel, so the logits never reach device memory as a separate
pass's input.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.epilogue import IDENTITY, EpilogueSpec
from repro_torch.core.layout import from_nchwc, kernel_to_kcrs_ck, to_nchwc
from repro_torch.core.schedule import ConvSchedule
from repro_torch.kernels.conv2d_nchwc import apply_epilogue_fp32, conv2d_nchwc
from repro_torch.kernels.matmul_blocked import MatmulSchedule, matmul_padded

__all__ = ["apply_epilogue_fp32", "attention_probs", "conv2d",
           "conv2d_block_blocked", "conv2d_blocked", "dense_softmax",
           "pad_blocked"]


def _pad_hw(pad) -> tuple:
    """Normalize an int-or-(ph, pw) padding spec."""
    return (pad, pad) if isinstance(pad, int) else tuple(pad)


def pad_blocked(x_blocked: torch.Tensor, pad) -> torch.Tensor:
    ph, pw = _pad_hw(pad)
    if ph == 0 and pw == 0:
        return x_blocked
    return F.pad(x_blocked, (0, 0, pw, pw, ph, ph))


def conv2d_blocked(x_blocked: torch.Tensor, w_blocked: torch.Tensor, *,
                   stride: int = 1, pad=0) -> torch.Tensor:
    """Plain blocked conv (no epilogue)."""
    return conv2d_nchwc(pad_blocked(x_blocked, pad), w_blocked, stride=stride)


def conv2d_block_blocked(x_blocked: torch.Tensor, w_blocked: torch.Tensor,
                         scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None,
                         residual: Optional[torch.Tensor] = None,
                         out_buf: Optional[torch.Tensor] = None, *,
                         stride: int = 1, pad=0, relu: bool = False,
                         epilogue: Optional[EpilogueSpec] = None
                         ) -> torch.Tensor:
    """Fused conv_block entry on blocked tensors.  ``scale`` and ``shift``
    are per-channel vectors pre-blocked to ``(Ko, oc_bn)``; ``residual``
    arrives in the conv's own NCHW[oc_bn]c output layout, and ``out_buf``
    (concat fusion) is the shared blocked buffer the epilogue spec's
    channel-offset store writes into."""
    spec = (epilogue or IDENTITY).with_relu(relu)
    return conv2d_nchwc(pad_blocked(x_blocked, pad), w_blocked, scale, shift,
                        residual, out_buf, stride=stride, epilogue=spec)


def conv2d(x_nchw: torch.Tensor, w_kcrs: torch.Tensor, *, stride: int = 1,
           pad=0, schedule: ConvSchedule) -> torch.Tensor:
    """Convenience NCHW->NCHW entry: blocks inputs, runs the kernel,
    unblocks.  The engine never uses this (it keeps tensors blocked)."""
    xb = to_nchwc(x_nchw, schedule.ic_bn)
    wb = kernel_to_kcrs_ck(w_kcrs, schedule.ic_bn, schedule.oc_bn)
    return from_nchwc(conv2d_blocked(xb, wb, stride=stride, pad=pad))


def dense_softmax(x: torch.Tensor, w: torch.Tensor, *,
                  schedule: Optional[MatmulSchedule] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``softmax(x @ w, axis=-1)`` with the row softmax fused into the
    matmul: the MoE router's instantiation (and the LM head's).  Any
    (M, K, N), through ``matmul_padded``; the sums are fp32 whatever the
    operands' type, the output in ``out_dtype`` (default ``x``'s type)."""
    return matmul_padded(x, w, schedule=schedule or MatmulSchedule(),
                         epilogue=EpilogueSpec(softmax=True),
                         out_dtype=out_dtype)


def attention_probs(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                    scale: Optional[float] = None,
                    schedule: Optional[MatmulSchedule] = None
                    ) -> torch.Tensor:
    """One head's attention probabilities ``softmax(mask(q @ k.T *
    scale))`` with the whole tail fused into the matmul.  ``q`` and ``k``
    are (S, D); ``scale`` defaults to ``1/sqrt(D)``."""
    d = q.shape[1]
    spec = EpilogueSpec(scale=scale if scale is not None else d ** -0.5,
                        mask="causal" if causal else "none", softmax=True)
    return matmul_padded(q, k.t().contiguous(),
                         schedule=schedule or MatmulSchedule(),
                         epilogue=spec)
