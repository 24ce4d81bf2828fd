"""Blocked direct convolution in NCHW[x]c with the fused conv_block epilogue:
the hand-written CUDA kernel, its wrapper, and its plain PyTorch version.

The kernel (``csrc/conv2d_nchwc.cu``) replaces the JAX reference's Pallas
TPU kernel ``repro/kernels/conv2d_nchwc.py::conv2d_nchwc_pallas`` and takes
the same tensors: the input pre-padded ``(N, Ci, Hp, Wp, ic_bn)``, the
weight ``(Ko, Ci, KH, KW, ic_bn, oc_bn)``, optional ``(Ko, oc_bn)``
scale/shift, an optional residual ``(N, Ko, OH, OW, oc_bn)`` at conv
resolution, and an optional concat buffer.  The source's header says what
bounds it on the H100 and what its simple design gives up.

It is built on first use by ``kernels/build.py`` (``nvcc`` for ``sm_90a``,
a plain C entry loaded with ``ctypes``).  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
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
    ko, _, kh, kw, _, oc_bn = w_blocked.shape
    oh = (hp - kh) // stride + 1
    ow = (wp - kw) // stride + 1
    acc = _acc_per_tap(x_blocked, w_blocked, stride, oh, ow)
    acc = acc.permute(0, 3, 1, 2, 4)                 # -> (n, ko, oh, ow, oc)
    out = apply_epilogue_fp32(acc, scale, shift, residual, spec)
    out = out.to(x_blocked.dtype).contiguous()
    if spec.writes_concat:
        # §3.1 concat-aware placement: the buffer with this block's channels
        # written at its offset
        off = spec.concat_offset // oc_bn
        full = out_buf.clone()
        full[:, off:off + ko] = out
        out = full
    return out


# ---------------------------------------------------------------------------
# The kernel: build, load, launch
# ---------------------------------------------------------------------------

def _launch_fn():
    return _build.entry("conv2d_nchwc", "conv2d_nchwc_launch",
                        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 21
                        + [ctypes.c_void_p])


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def conv2d_nchwc(x_blocked: torch.Tensor, w_blocked: torch.Tensor,
                 scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 out_buf: Optional[torch.Tensor] = None, *,
                 stride: int = 1,
                 epilogue: Optional[EpilogueSpec] = None) -> torch.Tensor:
    """Blocked conv + fused epilogue.  ``x_blocked`` is already padded.
    ``conv2d_nchwc.launches`` counts the kernel's launches."""
    spec = epilogue or IDENTITY
    if spec.has_matmul_tail:
        raise ValueError("the conv kernel has no matmul-tail stages")
    if x_blocked.device.type == "cpu":
        return conv2d_nchwc_plain(x_blocked, w_blocked, scale, shift,
                                  residual, out_buf, stride=stride,
                                  epilogue=spec)
    if x_blocked.device.type != "cuda":
        raise ValueError(f"no conv kernel for device {x_blocked.device}")
    if x_blocked.dim() != 5 or w_blocked.dim() != 6:
        raise ValueError(f"expected x (N, Ci, Hp, Wp, ic) and w "
                         f"(Ko, Ci, KH, KW, ic, oc); got "
                         f"{tuple(x_blocked.shape)}, {tuple(w_blocked.shape)}")
    n, ci, hp, wp, icb = x_blocked.shape
    ko, _, kh, kw, _, ocb = w_blocked.shape
    if stride < 1 or hp < kh or wp < kw:
        raise ValueError(f"stride {stride} or kernel ({kh}, {kw}) does not "
                         f"fit the padded input ({hp}, {wp})")
    oh = (hp - kh) // stride + 1
    ow = (wp - kw) // stride + 1
    ph, pw = spec.out_hw(oh, ow)
    dev = x_blocked.device
    _check("x", x_blocked, x_blocked.shape, dev)
    _check("w", w_blocked, (ko, ci, kh, kw, icb, ocb), dev)
    for name, vec in (("scale", scale), ("shift", shift)):
        if vec is not None:
            _check(name, vec, (ko, ocb), dev)
    if residual is not None:
        _check("residual", residual, (n, ko, oh, ow, ocb), dev)
    out_chunks, off_chunks = ko, 0
    if spec.writes_concat:
        if out_buf is None:
            raise ValueError("concat-write epilogue needs out_buf")
        if spec.concat_offset % ocb or spec.concat_total % ocb:
            raise ValueError(f"oc_bn {ocb} straddles the concat write "
                             f"({spec.concat_offset} of {spec.concat_total})")
        out_chunks = spec.concat_total // ocb
        off_chunks = spec.concat_offset // ocb
        if off_chunks + ko > out_chunks:
            raise ValueError("concat write runs past the buffer")
        _check("out_buf", out_buf, (n, out_chunks, ph, pw, ocb), dev)
    out = torch.empty((n, out_chunks, ph, pw, ocb), dtype=torch.float32,
                      device=dev)
    pool = spec.pool

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launch_fn()(
            ptr(x_blocked), ptr(w_blocked), ptr(scale), ptr(shift),
            ptr(residual), ptr(out_buf if spec.writes_concat else None),
            ptr(out),
            n, ci, hp, wp, icb, ko, kh, kw, ocb, stride, oh, ow,
            out_chunks, ph, pw, off_chunks, int(spec.relu),
            _POOL_KINDS[pool.kind if pool else None],
            pool.k if pool else 0, pool.stride if pool else 0,
            pool.pad if pool else 0, stream)
    if err != 0:
        raise RuntimeError(f"conv2d_nchwc launch failed: cudaError_t {err}")
    conv2d_nchwc.launches += 1
    return out


conv2d_nchwc.launches = 0
