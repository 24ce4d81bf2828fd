"""Engine-facing entries: the convs on blocked tensors and the LM's fused
matmul tails.

The conv entries consume the NCHW[x]c / KCRS[x]c[y]k tensors the planner
produces and run on one of two paths, chosen by ``use_kernel``:

* ``use_kernel=True`` (the default): the one conv kernel
  (``kernels/conv2d_nchwc.py``, B1): on a CUDA tensor its sm90 route, a
  3xTF32 implicit GEMM on the tensor cores (``csrc/conv2d_nchwc_sm90.cu``,
  which replaces the reference's ``conv2d_nchwc_pallas``), on a CPU tensor
  its plain version.  Like the reference's Pallas path, it ignores the
  schedule's ``variant`` and tile knobs, and has no int8 instantiation.
* ``use_kernel=False``: the reference's four XLA lowerings of the same
  conv (``ConvSchedule.variant``: per_tap, tap_stack, scan, patch_gemm) as
  torch ops, and the int8-weight forms of tap_stack and patch_gemm, on
  whatever device the tensors are on (cuBLAS on the card).
  ``conv2d_lowered.calls`` counts the calls of each variant and dtype.

``use_kernel`` is the counterpart of the reference's ``use_pallas`` with
the default the other way round: the hand-written kernel is the port's
main path, the lowerings the reference's other engine path.

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
from repro_torch.core.schedule import INT8_VARIANTS, VARIANTS, ConvSchedule
from repro_torch.kernels.conv2d_nchwc import (_acc_per_tap,
                                              apply_epilogue_fp32,
                                              conv2d_nchwc, epilogue_store)
from repro_torch.kernels.matmul_blocked import MatmulSchedule, matmul_padded

__all__ = ["apply_epilogue_fp32", "attention_probs", "conv2d",
           "conv2d_block_blocked", "conv2d_blocked", "conv2d_lowered",
           "dense_softmax", "pad_blocked", "prelay_patch_gemm_weight"]


def _pad_hw(pad) -> tuple:
    """Normalize an int-or-(ph, pw) padding spec."""
    return (pad, pad) if isinstance(pad, int) else tuple(pad)


def pad_blocked(x_blocked: torch.Tensor, pad) -> torch.Tensor:
    ph, pw = _pad_hw(pad)
    if ph == 0 and pw == 0:
        return x_blocked
    return F.pad(x_blocked, (0, 0, pw, pw, ph, ph))


# ---------------------------------------------------------------------------
# The four lowerings of the blocked direct conv (the reference's
# kernels/ops.py).  Each maps the padded input and the blocked weight to
# the fp32 accumulator in (n, oh, ow, ko, oc) order; per_tap is the plain
# version's ``_acc_per_tap``.
# ---------------------------------------------------------------------------

def _taps(xp: torch.Tensor, kh: int, kw: int, stride: int, oh: int,
          ow: int) -> list:
    """The kh*kw strided input windows, tap-major."""
    return [xp[:, :, dh:dh + oh * stride:stride, dw:dw + ow * stride:stride]
            for dh in range(kh) for dw in range(kw)]


def _acc_tap_stack(xp, w_blocked, stride, oh, ow):
    """All kh*kw taps stacked into one tensor and the full kh*kw*ic_bn
    reduction done as a single contraction: the input is copied kh*kw
    times, the product's K grows from ic_bn to kh*kw*ic_bn."""
    ko, ci_w, kh, kw, ic_w, oc_bn = w_blocked.shape
    taps = torch.stack(_taps(xp, kh, kw, stride, oh, ow), dim=2)
    wt = w_blocked.reshape(ko, ci_w, kh * kw, ic_w, oc_bn)
    return torch.einsum("ncthwi,kctio->nhwko", taps.float(), wt.float())


def _acc_scan(xp, w_blocked, stride, oh, ow):
    """The taps one at a time, each tap's product added in place into one
    preallocated fp32 accumulator: the counterpart of the reference's
    ``lax.scan``, whose carry XLA aliases in place."""
    n = xp.shape[0]
    ko, ci_w, kh, kw, ic_w, oc_bn = w_blocked.shape
    # (t, ko, ci, ic, oc): one tap's weights a step
    wt = w_blocked.reshape(ko, ci_w, kh * kw, ic_w, oc_bn) \
                  .permute(2, 0, 1, 3, 4).float()
    acc = torch.zeros((n, oh, ow, ko, oc_bn), dtype=torch.float32,
                      device=xp.device)
    for tap, patch in enumerate(_taps(xp, kh, kw, stride, oh, ow)):
        acc.add_(torch.einsum("nchwi,kcio->nhwko", patch.float(), wt[tap]))
    return acc


def prelay_patch_gemm_weight(w_blocked: torch.Tensor) -> torch.Tensor:
    """Bind-time pre-layout for the patch_gemm lowering: the KCRS[x]c[y]k
    weight in panel-major ``(Ci, kh, kw, ic_bn, Ko, oc_bn)`` order, the
    transpose ``_acc_patch_gemm`` otherwise pays at run time; the reshape
    to the ``(kh*kw*cin, cout)`` product operand is then a view (§3.2:
    parameter layout is invariant, so transform it during compilation)."""
    return w_blocked.permute(1, 2, 3, 4, 0, 5).contiguous()


def _patch_gemm(xp, w_panel_major, stride, oh, ow):
    """Shared tail of both patch_gemm entries: ``w_panel_major`` is the
    weight already in (Ci, kh, kw, ic_bn, Ko, oc_bn) order."""
    n, ci = xp.shape[:2]
    ci_w, kh, kw, ic_w, ko, oc_bn = w_panel_major.shape
    taps = torch.stack(_taps(xp, kh, kw, stride, oh, ow), dim=-2)
    panel = taps.permute(0, 2, 3, 1, 4, 5).reshape(n * oh * ow, -1)
    wmat = w_panel_major.reshape(ci_w * kh * kw * ic_w, ko * oc_bn)
    out = torch.matmul(panel.float(), wmat.float())
    return out.reshape(n, oh, ow, ko, oc_bn)


def _acc_patch_gemm(xp, w_blocked, stride, oh, ow):
    """im2col: the strided patch panel flattened to one plain
    (n*oh*ow, kh*kw*cin) @ (kh*kw*cin, cout) product.  Pays the panel's
    copy but hands the backend one contiguous full-reduction matmul."""
    return _patch_gemm(xp, w_blocked.permute(1, 2, 3, 4, 0, 5), stride, oh,
                       ow)


_ACC_FNS = {"per_tap": _acc_per_tap, "tap_stack": _acc_tap_stack,
            "scan": _acc_scan, "patch_gemm": _acc_patch_gemm}


# int8 forms (ConvSchedule.dtype == "int8", weight-only W8): the weight
# arrives as int8 codes quantized per output channel at bind time
# (core/quantize.py), activations stay fp32, the codes are upcast at the
# product, and the per-channel dequantize scale is applied by the shared
# epilogue's ``scale`` operand, like a BN scale.

def _require_int8_weight(w: torch.Tensor, variant: str) -> None:
    if w.dtype != torch.int8:
        raise TypeError(
            f"dtype='int8' {variant} template expects an int8 weight "
            f"operand (quantized codes), got {w.dtype}")


def _acc_tap_stack_int8(xp, w_blocked, stride, oh, ow):
    _require_int8_weight(w_blocked, "tap_stack")
    return _acc_tap_stack(xp, w_blocked, stride, oh, ow)


def _acc_patch_gemm_int8(xp, w_blocked, stride, oh, ow):
    _require_int8_weight(w_blocked, "patch_gemm")
    return _acc_patch_gemm(xp, w_blocked, stride, oh, ow)


_ACC_FNS_INT8 = {"tap_stack": _acc_tap_stack_int8,
                 "patch_gemm": _acc_patch_gemm_int8}


def conv2d_lowered(x_blocked: torch.Tensor, w_blocked: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None,
                   out_buf: Optional[torch.Tensor] = None, *,
                   stride: int = 1, pad=0,
                   epilogue: Optional[EpilogueSpec] = None,
                   variant: str = "auto", w_prelaid: bool = False,
                   dtype: str = "fp32") -> torch.Tensor:
    """Blocked direct conv + the composable epilogue as torch ops, the
    counterpart of the reference's ``_conv2d_block_core``: the lowering
    ``variant`` (one of ``core.schedule.VARIANTS``, or ``"auto"``, resolved
    as ``ConvSchedule.resolved_variant`` does), then the shared epilogue
    ``pool(relu(acc * scale + shift + residual))`` and, for a concat write,
    the store at the channel offset into ``out_buf``.

    ``w_prelaid`` marks a weight that arrived panel-major from
    ``prelay_patch_gemm_weight`` (legal only for ``patch_gemm``).
    ``dtype="int8"`` selects the weight-quantized form of the variant
    (tap_stack and patch_gemm only): ``w_blocked`` holds int8 codes and
    ``scale`` must carry the per-channel dequantize scale."""
    spec = epilogue or IDENTITY
    xp = pad_blocked(x_blocked, pad)
    _, _, hp, wp, ic_bn = xp.shape
    if w_prelaid:
        if variant != "patch_gemm":
            raise ValueError(f"pre-laid panel weight requires patch_gemm, "
                             f"got {variant!r}")
        _, kh, kw, _, _, oc_bn = w_blocked.shape
    else:
        _, _, kh, kw, _, oc_bn = w_blocked.shape
    oh = (hp - kh) // stride + 1
    ow = (wp - kw) // stride + 1
    variant = ConvSchedule(ic_bn, oc_bn, 1,
                           variant=variant or "auto").resolved_variant()
    if variant not in _ACC_FNS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if dtype == "int8":
        if variant not in _ACC_FNS_INT8:
            raise ValueError(
                f"dtype 'int8' has no {variant!r} instantiation; int8 "
                f"variants are {tuple(_ACC_FNS_INT8)}")
        if scale is None:
            raise ValueError(
                "dtype 'int8' requires the per-channel dequantize scale "
                "in the epilogue's scale operand")
        if w_prelaid:
            _require_int8_weight(w_blocked, variant)
            acc = _patch_gemm(xp, w_blocked, stride, oh, ow)
        else:
            acc = _ACC_FNS_INT8[variant](xp, w_blocked, stride, oh, ow)
    elif dtype != "fp32":
        raise ValueError(f"dtype {dtype!r} not in ('fp32', 'int8')")
    elif w_prelaid:
        acc = _patch_gemm(xp, w_blocked, stride, oh, ow)
    else:
        acc = _ACC_FNS[variant](xp, w_blocked, stride, oh, ow)
    conv2d_lowered.calls[f"{variant}/{dtype}"] += 1
    return epilogue_store(acc, scale, shift, residual, out_buf, spec,
                          x_blocked.dtype)


conv2d_lowered.calls = {**{f"{v}/fp32": 0 for v in VARIANTS},
                        **{f"{v}/int8": 0 for v in INT8_VARIANTS}}


# ---------------------------------------------------------------------------
# Engine-facing entries
# ---------------------------------------------------------------------------

def _schedule_variant(schedule: Optional[ConvSchedule]) -> str:
    return schedule.variant if schedule is not None else "auto"


def _schedule_dtype(schedule: Optional[ConvSchedule]) -> str:
    return schedule.dtype if schedule is not None else "fp32"


def _check_kernel_call(schedule: Optional[ConvSchedule],
                       w_prelaid: bool) -> None:
    """What the kernel path refuses, as the reference's Pallas path
    asserts it: a pre-laid weight (B1 reads KCRS[x]c[y]k) and an int8
    schedule (B1 has no int8 instantiation)."""
    if w_prelaid:
        raise ValueError("the conv kernel consumes KCRS[x]c[y]k weights, "
                         "not a pre-laid panel")
    if _schedule_dtype(schedule) != "fp32":
        raise ValueError("the conv kernel has no int8 instantiation; int8 "
                         "schedules run with use_kernel=False")


def conv2d_blocked(x_blocked: torch.Tensor, w_blocked: torch.Tensor, *,
                   stride: int = 1, pad=0,
                   schedule: Optional[ConvSchedule] = None,
                   use_kernel: bool = True,
                   w_prelaid: bool = False) -> torch.Tensor:
    """Plain blocked conv (no epilogue).  ``use_kernel`` (default) runs the
    conv kernel, which ignores the schedule's variant; otherwise the
    schedule's ``variant`` and ``dtype`` pick the lowering."""
    if use_kernel:
        _check_kernel_call(schedule, w_prelaid)
        return conv2d_nchwc(pad_blocked(x_blocked, pad), w_blocked,
                            stride=stride)
    return conv2d_lowered(x_blocked, w_blocked, stride=stride, pad=pad,
                          variant=_schedule_variant(schedule),
                          w_prelaid=w_prelaid,
                          dtype=_schedule_dtype(schedule))


def conv2d_block_blocked(x_blocked: torch.Tensor, w_blocked: torch.Tensor,
                         scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None,
                         residual: Optional[torch.Tensor] = None,
                         out_buf: Optional[torch.Tensor] = None, *,
                         stride: int = 1, pad=0, relu: bool = False,
                         epilogue: Optional[EpilogueSpec] = None,
                         schedule: Optional[ConvSchedule] = None,
                         use_kernel: bool = True,
                         w_prelaid: bool = False) -> torch.Tensor:
    """Fused conv_block entry on blocked tensors.  ``scale`` and ``shift``
    are per-channel vectors pre-blocked to ``(Ko, oc_bn)``; ``residual``
    arrives in the conv's own NCHW[oc_bn]c output layout, and ``out_buf``
    (concat fusion) is the shared blocked buffer the epilogue spec's
    channel-offset store writes into.  ``use_kernel`` as for
    ``conv2d_blocked``."""
    spec = (epilogue or IDENTITY).with_relu(relu)
    if use_kernel:
        _check_kernel_call(schedule, w_prelaid)
        return conv2d_nchwc(pad_blocked(x_blocked, pad), w_blocked, scale,
                            shift, residual, out_buf, stride=stride,
                            epilogue=spec)
    return conv2d_lowered(x_blocked, w_blocked, scale, shift, residual,
                          out_buf, stride=stride, pad=pad, epilogue=spec,
                          variant=_schedule_variant(schedule),
                          w_prelaid=w_prelaid,
                          dtype=_schedule_dtype(schedule))


def conv2d(x_nchw: torch.Tensor, w_kcrs: torch.Tensor, *, stride: int = 1,
           pad=0, schedule: ConvSchedule,
           use_kernel: bool = True) -> torch.Tensor:
    """Convenience NCHW->NCHW entry: blocks inputs, runs the conv, unblocks.
    The engine never uses this (it keeps tensors blocked)."""
    xb = to_nchwc(x_nchw, schedule.ic_bn)
    wb = kernel_to_kcrs_ck(w_kcrs, schedule.ic_bn, schedule.oc_bn)
    return from_nchwc(conv2d_blocked(xb, wb, stride=stride, pad=pad,
                                     schedule=schedule,
                                     use_kernel=use_kernel))


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
