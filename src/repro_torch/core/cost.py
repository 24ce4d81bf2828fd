"""Roofline cost model for schedules, transforms, and collectives.

NeoCPU's local search *measures* wall time on the target; the port does too
(``core.local_search.guided_local_search`` on the card).  This analytical
roofline model, the reference's, prunes that search's candidates and breaks
its ties, and ranks schedules alone under ``tuning="roofline"``.  It is
priced on one ``MachineModel``.  The model is intentionally coarse — it only
has to *rank* schedules the way a real measurement would.

``MachineModel.h100()`` takes NVIDIA's published figures for one H100 SXM
(data sheet and Hopper white paper): fp32 outside the tensor cores, device
memory bandwidth, the shared memory one block can use, NVLink's
per-direction bandwidth, and its 132 SMs.  It prices a conv's product in
the tile of the port's conv kernel (B1, ``kernels/conv2d_nchwc.py``: 64 x
64 outputs, K in steps of 32), counts the tiles a wave of SMs holds, and
takes as a conv's working set the shared memory B1's launch stages.  The
fields' defaults are the reference's matrix unit (8 x 128 tiles, K in steps
of 8, one core) and its blocked loop nest's working set, so a
``MachineModel`` of the reference's four figures prices plans exactly as
the reference does.  ``MachineModel.from_device`` reads the SM count and
shared memory of the card at hand.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.analysis.roofline import HBM_BW, NVLINK_BW, PEAK_FP32
from repro_torch.core.layout import Layout, transform_bytes
from repro_torch.core.schedule import ConvSchedule, ConvWorkload

# The reference's matrix-unit tile: the defaults of ``MachineModel``'s tile
MXU_DIM = 128
SUBLANE = 8

# B1's launch (``kernels/conv2d_nchwc.py::_plan``), copied: blocks of a
# cluster along K at most, k tiles each block of a split keeps at least,
# pooled outputs a patch has along each axis, and the bytes of one staged
# tile row (BK fp32 values)
B1_CS_MAX = 8
B1_MIN_KT = 4
B1_POOL_PATCH = 8
B1_ROW_BYTES = 128
# and its wide route's (``wide_tile``, ``wide_smem_bytes``): rows of a
# block, its tile widths, the B stages of its ring, a tile's fixed work
B1_WIDE_BM = 128
B1_WIDE_BN = (128, 64)
B1_WIDE_STAGES = 6
B1_WIDE_TILE_COST = 32

WORKING_SETS = ("blocked_loop", "b1_launch")


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """The figures the roofline model prices a plan with."""

    peak_flops: float        # FLOP/s of the conv's arithmetic (fp32)
    mem_bw: float            # device-memory bytes/s
    link_bw: float           # bytes/s per direction of one inter-chip link
    fast_mem_bytes: int      # on-chip working-set budget of one conv block
    tile_m: int = SUBLANE    # rows of one product tile (M pads to it)
    tile_n: int = MXU_DIM    # columns of one product tile (N pads to it)
    tile_k: int = SUBLANE    # the reduction's step (K pads to it)
    cores: int = 1           # tiles one wave runs at once
    # what a conv stages in fast memory: the reference's blocked loop
    # nest (``conv_vmem_bytes``) or B1's launch (``b1_smem_bytes``)
    working_set: str = "blocked_loop"

    def __post_init__(self):
        if self.working_set not in WORKING_SETS:
            raise ValueError(f"working_set {self.working_set!r} not in "
                             f"{WORKING_SETS}")

    @classmethod
    def h100(cls) -> "MachineModel":
        return cls(peak_flops=PEAK_FP32, mem_bw=HBM_BW, link_bw=NVLINK_BW,
                   fast_mem_bytes=232_448, tile_m=64, tile_n=64, tile_k=32,
                   cores=132, working_set="b1_launch")

    @classmethod
    def from_device(cls, device) -> "MachineModel":
        """``h100()`` with the SM count and the shared memory a block may
        opt into read from ``torch.cuda.get_device_properties``."""
        import torch

        props = torch.cuda.get_device_properties(device)
        base = cls.h100()
        return dataclasses.replace(
            base, cores=props.multi_processor_count,
            fast_mem_bytes=getattr(props, "shared_memory_per_block_optin",
                                   base.fast_mem_bytes))


H100 = MachineModel.h100()
# The lowerings (``use_kernel=False``) run their products on cuBLAS, whose
# tile the port does not know: a session on them prices its convs on the
# reference's matrix-unit tile and blocked loop nest, at the H100's rates.
H100_LOWERINGS = dataclasses.replace(H100, tile_m=SUBLANE, tile_n=MXU_DIM,
                                     tile_k=SUBLANE, cores=1,
                                     working_set="blocked_loop")


def machine_for(use_kernel: bool) -> MachineModel:
    """The H100 model of a session's engine: B1's, or the lowerings'."""
    return H100 if use_kernel else H100_LOWERINGS


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    compute_s: float
    memory_s: float
    collective_s: float = 0.0

    @property
    def total_s(self) -> float:
        # compute and memory overlap (async copies); collectives may
        # overlap too but we charge them serially as the conservative bound.
        return max(self.compute_s, self.memory_s) + self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


# ---------------------------------------------------------------------------
# Conv schedule cost (feeds the local search)
# ---------------------------------------------------------------------------

def mxu_utilization(m: int, k: int, n: int,
                    machine: MachineModel = H100) -> float:
    """Fraction of matrix-unit work that is useful for an (m,k)@(k,n)
    micro-GEMM.  M and N pad to the machine's (tile_m, tile_n) tile, K to
    its step ``tile_k``: (8, 128) and 8 on the reference's matrix unit,
    (64, 64) and 32 in B1's wgmma tile on the H100."""
    um = m / _round_up(m, machine.tile_m)
    uk = k / _round_up(k, machine.tile_k)
    un = n / _round_up(n, machine.tile_n)
    return um * uk * un


def wave_utilization(wl: ConvWorkload, machine: MachineModel) -> float:
    """Fraction of the machine's cores the conv's output tiles keep busy:
    the (batch*oh*ow) x out_channels output in ``tile_m`` x ``tile_n``
    tiles, run ``cores`` at a time (the last wave part-full).  1.0 on one
    core."""
    oh, ow = wl.out_hw
    tiles = (-(-wl.batch * oh * ow // machine.tile_m)
             * -(-wl.out_channels // machine.tile_n))
    return tiles / (-(-tiles // machine.cores) * machine.cores)


def b1_wide_tile(m: int, ncols: int, cores: int) -> int:
    """B1's wide route's tile width for a GEMM of ``m`` rows and ``ncols``
    columns on ``cores`` SMs, or 0 (``kernels/conv2d_nchwc.py::wide_tile``,
    copied)."""
    tiles_m = -(-m // B1_WIDE_BM)
    best = None
    for bn in B1_WIDE_BN:
        if bn > 64 and ncols <= 64:
            continue
        tiles = tiles_m * -(-ncols // bn)
        cost = -(-tiles // cores) * (bn + B1_WIDE_TILE_COST)
        if best is None or cost < best[0]:
            best = (cost, bn, tiles)
    return best[1] if 2 * best[2] >= cores else 0


def b1_smem_bytes(wl: ConvWorkload, machine: MachineModel, ic_bn: int = 0,
                  oc_bn: int = 0) -> int:
    """The dynamic shared memory B1 stages for this conv, as its launch plan
    lays it out (``kernels/conv2d_nchwc.py::_plan`` and ``smem_bytes``):
    two stages of hi and lo A and B tiles, three int tables of the tile's
    rows, the k-offset table of one block's k tiles (K split over a cluster
    where the output tiles leave SMs idle), a pooled conv's patch of conv
    pixels (shrunk until it fits, as the launch does), and 1,024 bytes of
    slack.  An unpooled conv blocked with ``ic_bn % 32 == 0`` and
    ``oc_bn % 8 == 0`` whose grid fills the card takes the wide route
    (``wide_smem_bytes``): six stages of B's hi and lo, two barriers a
    stage, 1,024 bytes of slack.  B1 takes its tile from neither ic_bn nor
    oc_bn, only its route."""
    bm, bn, bk = machine.tile_m, machine.tile_n, machine.tile_k
    oh, ow = wl.out_hw
    kt = -(-(wl.in_channels // wl.groups) * wl.kh * wl.kw // bk)
    if (not wl.fused_pool and ic_bn and ic_bn % bk == 0 and oc_bn
            and oc_bn % 8 == 0):
        wide = b1_wide_tile(wl.batch * oh * ow, wl.out_channels,
                            machine.cores)
        if wide:
            return B1_WIDE_STAGES * (2 * wide * B1_ROW_BYTES + 16) + 1024

    def smem(kt_per: int, patch_rows: int) -> int:
        ring = 2 * (2 * bm * B1_ROW_BYTES + 2 * bn * B1_ROW_BYTES)
        table = -(-kt_per * bk * 4 // 16) * 16
        return ring + 3 * bm * 4 + table + patch_rows * (bn + 4) * 4 + 1024

    spec = wl.epilogue_spec()
    if spec.pool is not None:
        pool = spec.pool
        ph, pw = spec.out_hw(oh, ow)
        pph, ppw = min(B1_POOL_PATCH, ph), min(B1_POOL_PATCH, pw)

        def window(pp):
            return (pp - 1) * pool.stride + pool.k

        while (smem(kt, window(pph) * window(ppw)) > machine.fast_mem_bytes
               and (pph, ppw) != (1, 1)):
            if pph >= ppw:
                pph = max(1, pph // 2)
            else:
                ppw = max(1, ppw // 2)
        return smem(kt, window(pph) * window(ppw))
    tiles = (-(-wl.batch * oh * ow // bm)
             * -(-wl.out_channels // bn))
    cs = 1
    while (cs < B1_CS_MAX and tiles * cs * 2 <= machine.cores
           and kt >= 2 * cs * B1_MIN_KT):
        cs *= 2
    return smem(-(-kt // cs), 0)


def conv_vmem_bytes(wl: ConvWorkload, s: ConvSchedule) -> int:
    """Working set of one block of the reference's blocked loop nest: one
    (H_pad, W_pad, ic_bn) input slab, the (kh, kw, ic_bn, oc_bn) weight
    block, and the (oh_bn, OW, oc_bn) output block (fp32 accumulator)."""
    oh, ow = wl.out_hw
    h_pad = wl.height + 2 * wl.pad
    w_pad = wl.width + 2 * wl.pw
    b = wl.dtype_bytes
    inp = h_pad * w_pad * s.ic_bn * b
    ker = wl.kh * wl.kw * s.ic_bn * s.oc_bn * (1 if s.dtype == "int8" else b)
    outp = s.oh_bn * ow * s.oc_bn * 4  # fp32 accum
    return inp + ker + outp


def conv_schedule_cost(wl: ConvWorkload, s: ConvSchedule,
                       machine: MachineModel = H100) -> CostBreakdown:
    """Roofline estimate for one CONV executed under schedule ``s``.

    The lowering ``variant`` changes both terms:

    * compute — the stacked variants (tap_stack, patch_gemm) contract the
      full ``kh*kw*ic_bn`` reduction in one GEMM, so their K dim pads much
      better than per-tap micro-GEMMs when ``ic_bn`` is sub-sublane;
      patch_gemm additionally flattens M to ``n*oh*ow`` (no ow_bn padding).
    * memory — per_tap round-trips the fp32 accumulator between taps;
      tap_stack/patch_gemm materialize the input ``kh*kw`` times (write +
      GEMM read); scan carries the accumulator in the loop but copies a
      strided window per tap.

    The workload's fused-epilogue flags add the §3.1 epilogue traffic here,
    so the local search ranks schedules *with* their epilogue included
    (fused: only the residual read survives — everything else happens while
    the accumulator is still on chip).
    """
    oh, ow = wl.out_hw
    cin = wl.in_channels // wl.groups
    khkw = wl.kh * wl.kw
    variant = s.resolved_variant()
    if variant in ("tap_stack", "patch_gemm"):
        # one contraction over the stacked kh*kw*ic reduction
        util = mxu_utilization(
            wl.batch * oh * ow if variant == "patch_gemm" else s.ow_bn,
            khkw * s.ic_bn, s.oc_bn, machine)
    else:
        util = mxu_utilization(s.ow_bn, s.ic_bn, s.oc_bn, machine)
    # unrolling the (kh, kw) loops trims scalar-loop overhead; model it as a
    # small utilization bonus that decays for large kernels (paper: "in some
    # scenarios unrolling may increase the performance").  scan keeps the
    # tap loop rolled, so it forfeits the bonus.
    if s.unroll_ker and variant != "scan":
        util = min(1.0, util * (1.0 + 0.05 / max(1, khkw / 9)))
    compute_s = wl.flops / (machine.peak_flops * max(util, 1e-3)
                            * wave_utilization(wl, machine))

    b = wl.dtype_bytes
    # memory traffic under the blocked loop nest (n, oc_chunk, oh_blk, ic_chunk):
    # the input slab is re-read once per output-channel chunk; weights are
    # re-read once per batch element; the output is written once (+1 read per
    # extra input-channel pass for accumulation).
    oc_chunks = wl.out_channels // s.oc_bn
    ic_chunks = cin // s.ic_bn
    input_once = wl.batch * cin * wl.height * wl.width * b
    input_bytes = input_once * oc_chunks
    # dtype="int8" stores the weight as 1-byte quantization codes — 4x
    # denser weight traffic (the accumulator stays 4 bytes either way:
    # int32 and fp32 are the same width, so acc_bytes below is unchanged);
    # the per-channel dequant multiply rides the fused epilogue pass for
    # free, like a BN scale.
    wb = 1 if s.dtype == "int8" else b
    weight_bytes = (wl.out_channels * cin * wl.kh * wl.kw * wb) * wl.batch
    # stored output: the fused pooling reduction shrinks the final store to
    # the pooled tiling (the conv-resolution tensor is never stored); the
    # extra input-channel accumulation passes still run at conv resolution
    poh, pow_ = wl.pooled_out_hw
    output_bytes = (wl.batch * wl.out_channels * poh * pow_ * b
                    + wl.batch * wl.out_channels * oh * ow * b
                    * max(0, ic_chunks - 1))
    # variant-specific traffic (fp32 accumulator is 4 bytes/elem); one tap's
    # strided patch holds oh*ow spatial positions — input_once/stride^2 on
    # downsample convs, not the full-resolution slab
    acc_bytes = wl.batch * wl.out_channels * oh * ow * 4
    tap_once = wl.batch * cin * oh * ow * b
    if variant == "per_tap":
        # the accumulator materializes between taps: one read + one write
        # per extra tap
        variant_bytes = 2 * max(0, khkw - 1) * acc_bytes
    elif variant == "scan":
        # accumulator is loop-carried (aliased in place); each tap copies a
        # strided window of the input slab out of the padded tensor
        variant_bytes = 2 * khkw * tap_once
    elif variant == "tap_stack":
        # the stacked tap tensor is written once and read once by the GEMM
        variant_bytes = 2 * khkw * tap_once
    else:  # patch_gemm
        # stacked taps + the explicit panel transpose pass
        variant_bytes = 3 * khkw * tap_once
    epi_bytes = epilogue_bytes(
        (wl.batch, wl.out_channels, oh, ow), bn=wl.fused_bn,
        relu=wl.fused_relu, residual=wl.fused_residual, fused=True,
        dtype_bytes=b)
    memory_s = (input_bytes + weight_bytes + output_bytes + variant_bytes
                + epi_bytes) / machine.mem_bw

    # schedules whose working set spills fast memory pay a heavy penalty
    staged = (b1_smem_bytes(wl, machine, s.ic_bn, s.oc_bn)
              if machine.working_set == "b1_launch"
              else conv_vmem_bytes(wl, s))
    if staged > machine.fast_mem_bytes:
        memory_s *= 8.0
    return CostBreakdown(compute_s=compute_s, memory_s=memory_s)


# ---------------------------------------------------------------------------
# Epilogue cost (§3.1 operation fusion)
# ---------------------------------------------------------------------------

def epilogue_bytes(nchw_shape: Tuple[int, ...], *, bn: bool = False,
                   relu: bool = False, residual: bool = False,
                   pool_stride: int = 0, concat: bool = False,
                   scale: bool = False, mask: bool = False,
                   softmax: bool = False,
                   fused: bool = False, dtype_bytes: int = 4) -> int:
    """Device-memory traffic for a conv's elementwise/shallow epilogue.

    Unfused graphs dispatch BN / residual-add / ReLU as separate nodes, each
    round-tripping the full conv output through memory (read + write; the
    add also reads the residual operand); a standalone pooling node reads
    the conv output and writes the (stride²-smaller) pooled tensor, and a
    standalone concat copies this conv's slice into the concat buffer (read
    + write).  A fused ``conv_block`` applies the affine/ReLU while the
    output block is still on chip, pools the fp32 values
    before the store, and writes straight into the concat buffer — the only
    epilogue traffic left is the single residual read.  (The *smaller
    pooled store itself* is credited in ``conv_schedule_cost``'s output
    term, not here.)

    The matmul-tail stages price the same way (``nchw_shape`` is then the
    logical (M, N) logits shape, trailing dims 1): an unfused ``scale`` or
    ``mask`` is one elementwise pass (read + write), and an unfused row
    ``softmax`` is three passes over the logits (max-reduce read, exp read
    + write, normalize read + write ≈ 3x tensor — the reductions' scalar
    outputs are noise).  Fused, all three run on the accumulator-resident
    block and add zero memory traffic, which is exactly why the fused
    attention tail wins: the (S, S) logits tensor never materializes.

    Caveat on the fused concat credit: it models an in-place offset store.
    The port's conv kernel instead copies the non-owned buffer chunks
    through, so the realized win is smaller than predicted — compare
    measured columns, not predicted ones, for concat-fusion claims.
    """
    elems = 1
    for d in nchw_shape:
        elems *= int(d)
    tensor = elems * dtype_bytes
    if fused:
        return tensor if residual else 0
    total = 0
    if bn:
        total += 2 * tensor
    if residual:
        total += 3 * tensor
    if relu:
        total += 2 * tensor
    if pool_stride:
        total += tensor + tensor // (pool_stride * pool_stride)
    if concat:
        total += 2 * tensor
    if scale:
        total += 2 * tensor
    if mask:
        total += 2 * tensor
    if softmax:
        total += 3 * tensor
    return total


def epilogue_cost_s(nchw_shape: Tuple[int, ...], *, bn: bool = False,
                    relu: bool = False, residual: bool = False,
                    pool_stride: int = 0, concat: bool = False,
                    scale: bool = False, mask: bool = False,
                    softmax: bool = False,
                    fused: bool = False, dtype_bytes: int = 4,
                    machine: MachineModel = H100) -> float:
    return epilogue_bytes(nchw_shape, bn=bn, relu=relu, residual=residual,
                          pool_stride=pool_stride, concat=concat,
                          scale=scale, mask=mask, softmax=softmax,
                          fused=fused, dtype_bytes=dtype_bytes
                          ) / machine.mem_bw


# ---------------------------------------------------------------------------
# Layout-transform cost (graph-edge cost in the global search)
# ---------------------------------------------------------------------------

def transform_cost_s(nchw_shape: Tuple[int, ...], src: Layout, dst: Layout,
                     dtype_bytes: int = 4,
                     machine: MachineModel = H100) -> float:
    return transform_bytes(nchw_shape, src, dst, dtype_bytes) / machine.mem_bw


# ---------------------------------------------------------------------------
# Collective costs (ring algorithms over the machine's inter-chip links)
# ---------------------------------------------------------------------------

def all_gather_s(bytes_per_device: int, axis_size: int, links: int = 1,
                 machine: MachineModel = H100) -> float:
    """Ring all-gather: each device sends (axis-1)/axis of the gathered array."""
    if axis_size <= 1:
        return 0.0
    return bytes_per_device * (axis_size - 1) / (machine.link_bw * links)


def reduce_scatter_s(bytes_per_device: int, axis_size: int, links: int = 1,
                     machine: MachineModel = H100) -> float:
    if axis_size <= 1:
        return 0.0
    return bytes_per_device * (axis_size - 1) / axis_size / (
        machine.link_bw * links)


def all_reduce_s(bytes_per_device: int, axis_size: int, links: int = 1,
                 machine: MachineModel = H100) -> float:
    # ring all-reduce = reduce-scatter + all-gather
    return (reduce_scatter_s(bytes_per_device, axis_size, links, machine)
            + all_gather_s(bytes_per_device // max(1, axis_size), axis_size,
                           links, machine))


def all_to_all_s(bytes_per_device: int, axis_size: int, links: int = 1,
                 machine: MachineModel = H100) -> float:
    if axis_size <= 1:
        return 0.0
    return bytes_per_device * (axis_size - 1) / axis_size / (
        machine.link_bw * links)
