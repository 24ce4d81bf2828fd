"""Convolution schedule template (NeoCPU §3.1, Algorithm 1).

The paper's schedule tuple is ``(ic_bn, oc_bn, reg_n, unroll_ker)``; the
JAX reference renames ``reg_n`` to ``ow_bn`` and adds ``oh_bn`` (output rows
per block).  This module is a copy of the reference's, so plans and the
schedule database cross between the two packages unchanged.

The port's conv kernel (``kernels/conv2d_nchwc.py``) takes its layout from
``(ic_bn, oc_bn)`` and ignores ``ow_bn``, ``oh_bn``, ``unroll_ker`` and
``variant``, which are tile knobs of the reference's kernel; ``variant`` and
``dtype`` pick the torch-op lowering of ``kernels/ops.py`` when a conv runs
with ``use_kernel=False``.  The local search (``core/local_search.py``)
ranks candidate tuples per workload.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Tuple

from repro_torch.core.epilogue import EpilogueSpec, PoolSpec
from repro_torch.core.layout import candidate_blocks


@dataclasses.dataclass(frozen=True, order=True)
class ConvWorkload:
    """What the paper keys its schedule database on (§3.3.1): feature-map and
    kernel sizes define the workload, independent of which model it is in."""

    batch: int
    in_channels: int
    out_channels: int
    height: int
    width: int
    kh: int
    kw: int
    stride: int = 1
    pad: int = 0
    groups: int = 1
    dtype_bytes: int = 4
    pad_w: int = -1   # -1: same as pad (square padding, the common case)
    # fused-epilogue shape of the workload (§3.1): a conv_block carries its
    # absorbed BN / residual-add / ReLU into the schedule cost, so the local
    # search ranks schedules *with* their epilogue traffic included and the
    # database keys fused and plain instances separately.
    fused_bn: bool = False
    fused_relu: bool = False
    fused_residual: bool = False
    # fused pooling: "" = none, else "max"/"avg" with the pool geometry —
    # the stored output shrinks to the pooled tiling and the schedule's
    # output blocking must account for it (candidate_schedules).
    fused_pool: str = ""
    pool_k: int = 0
    pool_stride: int = 0
    pool_pad: int = 0
    pool_ceil: bool = False
    # concat-write: the block stores its channels at ``concat_offset`` into
    # a shared ``concat_total``-channel buffer (0 = none); oc_bn candidates
    # must divide both so the blocked offset store is legal.
    concat_offset: int = 0
    concat_total: int = 0
    # int8 eligibility: when True, ``candidate_schedules`` also enumerates
    # the quantized (dtype="int8") lowerings for this workload, so the
    # search weighs int8 against fp32 per workload and mixed-precision
    # plans fall out of the normal ranking.  Off by default — a quantized
    # schedule changes numerics, so it must be opted into per compile.
    quantize: bool = False

    @property
    def pw(self) -> int:
        return self.pad if self.pad_w < 0 else self.pad_w

    @property
    def out_hw(self) -> Tuple[int, int]:
        oh = (self.height + 2 * self.pad - self.kh) // self.stride + 1
        ow = (self.width + 2 * self.pw - self.kw) // self.stride + 1
        return oh, ow

    def epilogue_spec(self) -> EpilogueSpec:
        """The structural epilogue the kernels specialize on (BN scale/shift
        and residual presence travel as tensors, not in the spec)."""
        pool = PoolSpec(self.fused_pool, self.pool_k, self.pool_stride,
                        self.pool_pad, self.pool_ceil) \
            if self.fused_pool else None
        return EpilogueSpec(relu=self.fused_relu, pool=pool,
                            concat_offset=self.concat_offset,
                            concat_total=self.concat_total)

    @property
    def pooled_out_hw(self) -> Tuple[int, int]:
        """Spatial dims of the *stored* output (post fused pooling)."""
        oh, ow = self.out_hw
        if not self.fused_pool:
            return oh, ow
        return PoolSpec(self.fused_pool, self.pool_k, self.pool_stride,
                        self.pool_pad, self.pool_ceil).out_hw(oh, ow)

    @property
    def flops(self) -> int:
        oh, ow = self.out_hw
        return (2 * self.batch * self.out_channels * oh * ow
                * (self.in_channels // self.groups) * self.kh * self.kw)


# Conv lowering strategies — the template-variant axis of the schedule space.
# Each one is a different loop nest over the same blocked tensors (see
# kernels/ops.py for the instantiations):
#
#   per_tap    — unrolled loop over the kh*kw taps, one micro-GEMM each; the
#                fp32 accumulator materializes between taps.
#   tap_stack  — the kh*kw taps stacked into one tensor, the whole
#                kh*kw*ic_bn reduction done as a single contraction
#                (duplicates the input kh*kw times, but the micro-GEMM's K
#                dim grows from ic_bn to kh*kw*ic_bn — decisive when ic_bn
#                is sub-sublane, e.g. the RGB stem).
#   scan       — lax.scan over the taps carrying the accumulator, so the
#                partial sum stays loop-resident instead of round-tripping
#                through memory between taps (Georganas et al. 1808.05567).
#   patch_gemm — strided patch panels flattened to a single plain 2-D GEMM
#                over the full kh*kw*ic reduction (the im2col lowering of
#                Caffe con Troll, 1504.04343).
#
# "auto" defers the choice to the kernel's static heuristic (PR-1 behavior:
# tap_stack below sublane ic_bn, per_tap otherwise).
VARIANTS = ("per_tap", "tap_stack", "scan", "patch_gemm")

# Numeric-precision axis of the schedule space.  "int8" is weight-only
# quantization (W8: per-output-channel symmetric int8 weights bound at
# bind_params time, activations fp32, dequantize scale applied through the
# shared epilogue exactly like a BN scale) — a quantized template is just
# another point on the schedule axis, searched like any other.  Only the
# variants with an int8 instantiation in kernels/ops.py may carry it.
DTYPES = ("fp32", "int8")
INT8_VARIANTS = ("tap_stack", "patch_gemm")


@dataclasses.dataclass(frozen=True, order=True)
class ConvSchedule:
    """(ic_bn, oc_bn, reg_n→ow_bn, unroll_ker) + TPU's oh_bn block rows +
    the lowering ``variant`` (the §3.2 template picked per workload) + the
    numeric ``dtype`` ("fp32", or "int8" for the weight-quantized
    instantiation of the variant)."""

    ic_bn: int
    oc_bn: int
    ow_bn: int
    oh_bn: int = 1
    unroll_ker: bool = False
    variant: str = "auto"
    dtype: str = "fp32"

    def validate(self, wl: ConvWorkload) -> None:
        cin = wl.in_channels // wl.groups
        if cin % self.ic_bn:
            raise ValueError(f"ic_bn {self.ic_bn} !| {cin}")
        if wl.out_channels % self.oc_bn:
            raise ValueError(f"oc_bn {self.oc_bn} !| {wl.out_channels}")
        oh, ow = wl.out_hw
        if ow % self.ow_bn:
            raise ValueError(f"ow_bn {self.ow_bn} !| {ow}")
        if oh % self.oh_bn:
            raise ValueError(f"oh_bn {self.oh_bn} !| {oh}")
        if wl.concat_total and (wl.concat_offset % self.oc_bn
                                or wl.concat_total % self.oc_bn):
            raise ValueError(
                f"oc_bn {self.oc_bn} straddles the concat write "
                f"(offset {wl.concat_offset}, total {wl.concat_total})")
        if self.variant != "auto" and self.variant not in VARIANTS:
            raise ValueError(f"variant {self.variant!r} not in {VARIANTS}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {DTYPES}")
        if (self.dtype == "int8"
                and self.resolved_variant() not in INT8_VARIANTS):
            raise ValueError(
                f"dtype 'int8' has no {self.resolved_variant()!r} "
                f"instantiation; int8 variants are {INT8_VARIANTS}")

    def resolved_variant(self) -> str:
        """The concrete lowering ``auto`` defers to (PR-1's heuristic)."""
        if self.variant != "auto":
            return self.variant
        return "tap_stack" if self.ic_bn < 8 else "per_tap"


# paper §3.3.1 step 2: reg_n drawn from [32, 16, 8, 4, 2]; on TPU the
# sublane-aligned tiles are preferred so we extend with multiples of 8.
_OW_CANDIDATES = (128, 64, 32, 16, 8, 4, 2, 1)


def _channel_candidates(channels: int) -> List[int]:
    """Factor candidates for one channel axis: the paper's splits up to the
    128-lane block, plus the whole-channel "no split" point (ic_bn = C turns
    NCHW[x]c into NHWC, where the jnp instantiation's GEMM sees the full
    channel reduction — the measured winner for deep layers on CPU hosts)."""
    out = candidate_blocks(channels)
    if channels not in out:
        out = [channels] + out
    return out


def candidate_schedules(wl: ConvWorkload, max_candidates: int = 0,
                        ) -> List[ConvSchedule]:
    """Enumerate the search space of §3.3.1: all channel-factor splits ×
    ow blocking × unroll choice × lowering variant, deduped.

    ``max_candidates`` > 0 truncates the (ic-major) enumeration — only
    useful for tests; the full space is bounded (≤ 6*6*4*2*2*4 tuples) and
    a truncated one never reaches past the first couple of ic_bn
    candidates, which starves the (ic_bn, oc_bn) pair axis the global
    search needs."""
    oh, ow = wl.out_hw
    cin = wl.in_channels // wl.groups
    ics = _channel_candidates(cin)
    ocs = _channel_candidates(wl.out_channels)
    if wl.concat_total:
        # concat-write fusion: the blocked channel-offset store is legal only
        # when oc_bn divides the offset and the buffer's channel count (the
        # block boundary must not straddle the write).  oc_bn = 1 always
        # qualifies, so the filter can never empty the list.
        ocs = [f for f in ocs
               if wl.concat_offset % f == 0 and wl.concat_total % f == 0]
    ows = [f for f in _OW_CANDIDATES if ow % f == 0] or [1]
    if wl.fused_pool:
        # fused pooling reduces over the whole conv plane before the store,
        # so the output blocking collapses to whole-plane rows — the pooled
        # spatial tiling no longer matches the conv rows and partial-plane
        # blocks would straddle pooling windows.
        ohs = [oh]
    else:
        ohs = [f for f in (8, 4, 2, 1) if oh % f == 0] or [1]
    out: List[ConvSchedule] = []
    for ic_bn, oc_bn, ow_bn in itertools.product(ics[:6], ocs[:6], ows[:4]):
        for oh_bn in ohs[:2]:
            for unroll in (True, False):
                for variant in VARIANTS:
                    out.append(ConvSchedule(ic_bn, oc_bn, ow_bn, oh_bn,
                                            unroll, variant))
                    if wl.quantize and variant in INT8_VARIANTS:
                        out.append(ConvSchedule(ic_bn, oc_bn, ow_bn, oh_bn,
                                                unroll, variant,
                                                dtype="int8"))
    # stable unique, optional cap
    seen = set()
    uniq = []
    for s in out:
        if s not in seen:
            seen.add(s)
            uniq.append(s)
        if max_candidates and len(uniq) >= max_candidates:
            break
    return uniq


def layout_pairs(wl: ConvWorkload, schedules: List[ConvSchedule]
                 ) -> List[Tuple[int, int]]:
    """Distinct (ic_bn, oc_bn) pairs — the global search's per-CONV scheme
    axis (§3.3.2: 'each CONV has a number of candidate schemes specified by
    different (ic_bn, oc_bn) pairs')."""
    seen = set()
    pairs = []
    for s in schedules:
        key = (s.ic_bn, s.oc_bn)
        if key not in seen:
            seen.add(key)
            pairs.append(key)
    return pairs
