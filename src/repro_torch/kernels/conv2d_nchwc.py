"""Blocked convolution in NCHW[x]c with the fused conv_block epilogue (B1):
the hand-written CUDA kernel, its wrapper, and its plain PyTorch version.

The kernel (``csrc/conv2d_nchwc_sm90.cu``) replaces the JAX reference's
Pallas TPU kernel ``repro/kernels/conv2d_nchwc.py::conv2d_nchwc_pallas``
and takes the same tensors: the input pre-padded ``(N, Ci, Hp, Wp, ic_bn)``,
the weight ``(Ko, Ci, KH, KW, ic_bn, oc_bn)``, optional ``(Ko, oc_bn)``
scale/shift, an optional residual ``(N, Ko, OH, OW, oc_bn)`` at conv
resolution, and an optional concat buffer; it returns a new tensor.  The
route is chosen by shape before any launch (``_route``); it has one:

* ``sm90`` (every fp32 conv): an implicit GEMM on the tensor cores, tf32
  wgmma in 3xTF32 (each fp32 operand split into two tf32 parts, three
  products summed in fp32), K split across a thread-block cluster where the
  output tiles alone would leave the SMs idle, the pooled epilogue from a
  patch of conv values in shared memory.

Its operations bound it on the H100 (8.17 GFLOP per batch-1 ResNet-50
predict: 0.0496 ms at 495 TFLOP/s of TF32, three products each, or 0.124 ms
on the fp32 FMA units); the source's header says what its design does
about that.  ``launch_plan`` is the launch's plan (cluster
size, pooled patch, shared memory), computed here so the CPU tests reach
it.  It is built on first use by ``kernels/build.py`` (``nvcc`` for
``sm_90a``, a plain C entry loaded with ``ctypes``).  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.
``conv2d_nchwc.launches`` counts every launch,
``conv2d_nchwc.launches_by_route`` those of each route.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.core.epilogue import IDENTITY, EpilogueSpec
from repro_torch.kernels import build as _build

_POOL_KINDS = {None: 0, "max": 1, "avg": 2}


# ---------------------------------------------------------------------------
# Plain version: the reference's per-tap einsum loop nest + fp32 epilogue
# ---------------------------------------------------------------------------

def _acc_per_tap(xp: torch.Tensor, w_blocked: torch.Tensor, stride: int,
                 oh: int, ow: int) -> torch.Tensor:
    """Unrolled tap loop, one (M=hw, K=ic, N=oc) micro-GEMM per tap, into
    the fp32 accumulator in (n, oh, ow, ko, oc) order."""
    n = xp.shape[0]
    ko, _, kh, kw, _, oc_bn = w_blocked.shape
    acc = torch.zeros((n, oh, ow, ko, oc_bn), dtype=torch.float32,
                      device=xp.device)
    for dh in range(kh):
        for dw in range(kw):
            patch = xp[:, :, dh:dh + oh * stride:stride,
                       dw:dw + ow * stride:stride, :]
            acc = acc + torch.einsum("nchwi,kcio->nhwko", patch.float(),
                                     w_blocked[:, :, dh, dw].float())
    return acc


def apply_epilogue_fp32(acc: torch.Tensor, scale, shift, residual,
                        spec: EpilogueSpec) -> torch.Tensor:
    """The composable epilogue on the blocked fp32 accumulator
    ``(n, Ko, oh, ow, oc_bn)``, in the fixed order of ``core.epilogue``:
    affine -> residual -> ReLU -> pool."""
    if scale is not None:   # (Ko, oc_bn) per-channel affine
        acc = acc * scale.float()[None, :, None, None, :]
    if shift is not None:
        acc = acc + shift.float()[None, :, None, None, :]
    if residual is not None:
        acc = acc + residual.float()
    if spec.relu:
        acc = torch.clamp_min(acc, 0.0)
    if spec.pool is not None:
        acc = spec.pool.apply(acc)
    return acc


def conv2d_nchwc_plain(x_blocked: torch.Tensor, w_blocked: torch.Tensor,
                       scale: Optional[torch.Tensor] = None,
                       shift: Optional[torch.Tensor] = None,
                       residual: Optional[torch.Tensor] = None,
                       out_buf: Optional[torch.Tensor] = None, *,
                       stride: int = 1,
                       epilogue: Optional[EpilogueSpec] = None
                       ) -> torch.Tensor:
    """The kernel's function as plain PyTorch ops, on any device."""
    spec = epilogue or IDENTITY
    _, _, hp, wp, _ = x_blocked.shape
    _, _, kh, kw, _, _ = w_blocked.shape
    oh = (hp - kh) // stride + 1
    ow = (wp - kw) // stride + 1
    acc = _acc_per_tap(x_blocked, w_blocked, stride, oh, ow)
    return epilogue_store(acc, scale, shift, residual, out_buf, spec,
                          x_blocked.dtype)


def epilogue_store(acc: torch.Tensor, scale, shift, residual, out_buf,
                   spec: EpilogueSpec, dtype: torch.dtype) -> torch.Tensor:
    """The tail every plain conv shares, this plain version and the
    lowerings of ``kernels/ops.py``: the fp32 accumulator in (n, oh, ow,
    ko, oc) order back to the blocked order, the epilogue, the cast to
    ``dtype``, and for a concat write the buffer with this block's
    channels stored at its offset (§3.1 concat-aware placement)."""
    acc = acc.permute(0, 3, 1, 2, 4)                 # -> (n, ko, oh, ow, oc)
    out = apply_epilogue_fp32(acc, scale, shift, residual, spec)
    out = out.to(dtype).contiguous()
    if spec.writes_concat:
        ko, oc_bn = out.shape[1], out.shape[-1]
        if out_buf is None:
            raise ValueError("concat-write epilogue needs out_buf")
        if spec.concat_offset % oc_bn:
            raise ValueError(f"oc_bn {oc_bn} straddles the concat offset "
                             f"{spec.concat_offset}")
        off = spec.concat_offset // oc_bn
        full = out_buf.clone()
        full[:, off:off + ko] = out
        out = full
    return out


# ---------------------------------------------------------------------------
# The kernel: plan, build, load, launch
# ---------------------------------------------------------------------------

BM, BN, BK = 64, 64, 32      # a block's GEMM rows and columns (one wgmma);
                             # k per stage
CS_MAX = 8                   # blocks of a cluster along K (portable)
SMS = 132                    # the H100 SXM's SMs
MIN_KT = 4                   # k tiles each block of a split keeps at least
POOL_PATCH = 8               # pooled outputs a patch has along each axis
SMEM_MAX = 232448            # dynamic shared memory a block may use (bytes)
INT32_MAX = 2 ** 31 - 1      # the kernel's element offsets are 32-bit


def smem_bytes(kt_per: int, patch_rows: int) -> int:
    """The dynamic shared memory of a launch, as the kernel lays it out
    (``csrc/conv2d_nchwc_sm90.cu::smem_bytes``): two stages of A and B
    tiles, hi and lo, 128 bytes a row; three int tables of the tile's BM
    rows; the k-offset table of ``kt_per`` k tiles; the pooled patch of
    ``patch_rows`` conv pixels, ``BN + 4`` floats each; and 1,024 bytes of
    alignment slack."""
    ring = 2 * (2 * BM * 128 + 2 * BN * 128)
    table = -(-kt_per * BK * 4 // 16) * 16
    return ring + 3 * BM * 4 + table + patch_rows * (BN + 4) * 4 + 1024


def _conv_hw(x_shape, w_shape, stride: int):
    _, _, hp, wp, _ = x_shape
    _, _, kh, kw, _, _ = w_shape
    return (hp - kh) // stride + 1, (wp - kw) // stride + 1


def launch_plan(x_shape, w_shape, stride: int, spec: EpilogueSpec) -> dict:
    """A copy of ``_plan``'s plan for these shapes."""
    return dict(_plan(tuple(x_shape), tuple(w_shape), stride, spec))


@functools.lru_cache(maxsize=1024)
def _plan(x_shape: tuple, w_shape: tuple, stride: int,
          spec: EpilogueSpec) -> dict:
    """How the sm90 kernel splits one conv: ``vec`` (4: 16-byte loads of
    x, when ic_bn % 4 == 0),
    ``cs`` blocks of a cluster along K, the pooled patch ``pph`` x ``ppw``
    and its conv window ``ch`` x ``cw``, ``tiles_m`` row tiles (or
    patches), ``tiles_n``, ``kt_per`` k tiles a block, ``smem`` bytes, and
    for a pooled conv the ``recompute`` factor: conv values computed over
    the conv values of the layer (``mma_rows`` counts the wgmma rows)."""
    n, ci, _, _, icb = x_shape
    ko, _, kh, kw, _, ocb = w_shape
    oh, ow = _conv_hw(x_shape, w_shape, stride)
    ktot, ncols = ci * kh * kw * icb, ko * ocb
    kt = -(-ktot // BK)
    plan = {"vec": 4 if icb % 4 == 0 else 1, "pph": 0, "ppw": 0, "ch": 0,
            "cw": 0}
    pool = spec.pool
    if pool is not None:
        ph, pw = spec.out_hw(oh, ow)
        pph, ppw = min(POOL_PATCH, ph), min(POOL_PATCH, pw)

        def window(pp):
            return (pp - 1) * pool.stride + pool.k

        while smem_bytes(kt, window(pph) * window(ppw)) > SMEM_MAX:
            if pph == ppw == 1:
                raise ValueError(f"a {pool.k}x{pool.k} pool window does not "
                                 f"fit the kernel's shared memory")
            if pph >= ppw:
                pph = max(1, pph // 2)
            else:
                ppw = max(1, ppw // 2)
        ch, cw = window(pph), window(ppw)
        npr, npc = -(-ph // pph), -(-pw // ppw)

        def covered(p0, pp, size):   # conv rows of patch p0 in [0, size)
            lo = p0 * pp * pool.stride - pool.pad
            return max(0, min(size, lo + window(pp)) - max(0, lo))

        computed = sum(covered(i, pph, oh) for i in range(npr)) \
            * sum(covered(j, ppw, ow) for j in range(npc))
        plan.update(cs=1, pph=pph, ppw=ppw, ch=ch, cw=cw,
                    tiles_m=n * npr * npc, kt_per=kt,
                    smem=smem_bytes(kt, ch * cw),
                    recompute=computed / (oh * ow),
                    mma_rows=npr * npc * -(-ch * cw // BM) * BM / (oh * ow))
    else:
        tiles_m = -(-n * oh * ow // BM)
        tiles = tiles_m * -(-ncols // BN)
        cs = 1
        while cs < CS_MAX and tiles * cs * 2 <= SMS \
                and kt >= 2 * cs * MIN_KT:
            cs *= 2
        kt_per = -(-kt // cs)
        plan.update(cs=cs, tiles_m=tiles_m, kt_per=kt_per,
                    smem=smem_bytes(kt_per, 0))
    plan["tiles_n"] = -(-ncols // BN)
    return plan


def _route(x_shape, w_shape, stride: int, spec: EpilogueSpec,
           dtype: torch.dtype = torch.float32) -> str:
    """The kernel that takes this conv on the card: ``"sm90"`` for every
    fp32 conv whose launch plan fits the card.  Raises TypeError for
    another dtype and ValueError for a shape no route takes."""
    if dtype != torch.float32:
        raise TypeError(f"the conv kernel takes float32, got {dtype}")
    if spec.has_matmul_tail:
        raise ValueError("the conv kernel has no matmul-tail stages")
    plan = _plan(tuple(x_shape), tuple(w_shape), stride, spec)
    if plan["smem"] > SMEM_MAX or plan["tiles_m"] > 65535:
        raise ValueError(f"conv {tuple(x_shape)} * {tuple(w_shape)} does "
                         f"not fit the sm90 kernel's launch ({plan})")
    return "sm90"


def _launch_fn():
    return _build.entry("conv2d_nchwc_sm90", "conv2d_sm90_launch",
                        [ctypes.c_void_p] * 9)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if (t.device == device and t.dtype == torch.float32 and t.shape == shape
            and t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=1024)
def _geometry(x_shape: tuple, w_shape: tuple, stride: int,
              spec: EpilogueSpec) -> tuple:
    """Everything of a launch that its shapes fix, validated once per
    shape: the route, the plan, the output's, residual's, vectors' and
    concat buffer's shapes, and the kernel's 25 int arguments (the C
    entry's ``geo``) in a ctypes array, with its address."""
    if len(x_shape) != 5 or len(w_shape) != 6:
        raise ValueError(f"expected x (N, Ci, Hp, Wp, ic) and w "
                         f"(Ko, Ci, KH, KW, ic, oc); got {x_shape}, {w_shape}")
    n, ci, hp, wp, icb = x_shape
    ko, _, kh, kw, _, ocb = w_shape
    if (w_shape[1], w_shape[4]) != (ci, icb):
        raise ValueError(f"w has shape {w_shape}, expected "
                         f"{(ko, ci, kh, kw, icb, ocb)} for x {x_shape}")
    if stride < 1 or hp < kh or wp < kw:
        raise ValueError(f"stride {stride} or kernel ({kh}, {kw}) does not "
                         f"fit the padded input ({hp}, {wp})")
    oh, ow = _conv_hw(x_shape, w_shape, stride)
    ph, pw = spec.out_hw(oh, ow)
    out_chunks, off_chunks = ko, 0
    if spec.writes_concat:
        if spec.concat_offset % ocb or spec.concat_total % ocb:
            raise ValueError(f"oc_bn {ocb} straddles the concat write "
                             f"({spec.concat_offset} of {spec.concat_total})")
        out_chunks = spec.concat_total // ocb
        off_chunks = spec.concat_offset // ocb
        if off_chunks + ko > out_chunks:
            raise ValueError("concat write runs past the buffer")
    out_shape = (n, out_chunks, ph, pw, ocb)
    res_shape = (n, ko, oh, ow, ocb)
    for name, shape in (("x", x_shape), ("w", w_shape), ("out", out_shape),
                        ("residual", res_shape)):
        if math.prod(shape) > INT32_MAX:
            raise ValueError(f"{name} has {math.prod(shape)} elements, more "
                             f"than the kernel's 32-bit offsets reach")
    route = _route(x_shape, w_shape, stride, spec)
    plan = _plan(x_shape, w_shape, stride, spec)
    pool = spec.pool
    ints = (n, ci, hp, wp, icb, ko, kh, kw, ocb, stride, oh, ow,
            out_chunks, ph, pw, off_chunks, int(spec.relu),
            _POOL_KINDS[pool.kind if pool else None],
            pool.k if pool else 0, pool.stride if pool else 0,
            pool.pad if pool else 0,
            plan["vec"], plan["cs"], plan["pph"], plan["ppw"])
    geo = (ctypes.c_int * len(ints))(*ints)
    return (route, plan, torch.Size(out_shape), torch.Size(res_shape),
            torch.Size((ko, ocb)), geo, ctypes.addressof(geo))


def conv2d_nchwc(x_blocked: torch.Tensor, w_blocked: torch.Tensor,
                 scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 out_buf: Optional[torch.Tensor] = None, *,
                 stride: int = 1,
                 epilogue: Optional[EpilogueSpec] = None) -> torch.Tensor:
    """Blocked conv + fused epilogue.  ``x_blocked`` is already padded."""
    spec = epilogue or IDENTITY
    if spec.has_matmul_tail:
        raise ValueError("the conv kernel has no matmul-tail stages")
    if x_blocked.device.type == "cpu":
        return conv2d_nchwc_plain(x_blocked, w_blocked, scale, shift,
                                  residual, out_buf, stride=stride,
                                  epilogue=spec)
    if x_blocked.device.type != "cuda":
        raise ValueError(f"no conv kernel for device {x_blocked.device}")
    dev = x_blocked.device
    _check("x", x_blocked, x_blocked.shape, dev)
    route, plan, out_shape, res_shape, vec_shape, geo_ints, geo = _geometry(
        tuple(x_blocked.shape), tuple(w_blocked.shape), stride, spec)
    _check("w", w_blocked, w_blocked.shape, dev)
    for name, vec in (("scale", scale), ("shift", shift)):
        if vec is not None:
            _check(name, vec, vec_shape, dev)
    if residual is not None:
        _check("residual", residual, res_shape, dev)
    if spec.writes_concat:
        if out_buf is None:
            raise ValueError("concat-write epilogue needs out_buf")
        _check("out_buf", out_buf, out_shape, dev)
    if plan["vec"] == 4 and x_blocked.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for the kernel's "
                         "16-byte loads")
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    args = (ptr(x_blocked), ptr(w_blocked), ptr(scale), ptr(shift),
            ptr(residual), ptr(out_buf if spec.writes_concat else None),
            ptr(out), geo)
    if dev.index == torch.cuda.current_device():
        err = _launch_fn()(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = _launch_fn()(*args,
                               torch.cuda.current_stream().cuda_stream)
    del geo_ints                 # the ints at `geo` are read by the launch
    if err != 0:
        raise RuntimeError(f"conv2d_nchwc launch failed ({route}): "
                           f"cudaError_t {err}")
    conv2d_nchwc.launches += 1
    conv2d_nchwc.launches_by_route[route] += 1
    return out


conv2d_nchwc.launches = 0
conv2d_nchwc.launches_by_route = {"sm90": 0}
