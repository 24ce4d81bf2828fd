"""The blocked matmul with its fused matmul tail (B2): three hand-written
CUDA kernels, their wrapper, and the plain PyTorch version.

The kernels replace the JAX reference's Pallas TPU kernel
``repro/kernels/matmul_blocked.py::matmul_pallas``: ``(M, K) @ (K, N)``
with fp32 accumulation and, on the fp32 sums, the tail of
``core/epilogue.py::apply_matmul_epilogue`` (scale, causal mask at absolute
coordinates, the ``n_valid`` column mask, row softmax, ReLU), the output
cast to ``out_dtype or a.dtype``.  They take the shape as it is, so on the
card ``matmul_padded`` pads nothing.  The route is chosen by shape and
dtype before any launch (``_route``), never after a failure:

* ``splitk`` (M < 64, the decode router; fp32 or bf16):
  ``csrc/matmul_splitk.cu``, K split across a cluster of up to 16 blocks
  whose partials are reduced in rank order through distributed shared
  memory; N * element size a multiple of 16, N <= 512, K <= 16,384;
* ``sm90`` (bf16, M >= 64, the prefill router):
  ``csrc/matmul_blocked_sm90.cu``, wgmma on the tensor cores fed by TMA, K split across a cluster of up to
  4 blocks; K and N multiples of 8, N <= 512;
* ``fma`` (everything else: fp32 at M >= 64, ragged or wide bf16):
  ``csrc/matmul_blocked.cu`` on the fp32 FMA units, any shape.

Each source's header says what bounds it on the H100 and how it splits the
work.  The splitk and sm90 kernels sum in a fixed order, so two launches on
the same inputs are bit-identical.

``matmul_plain`` keeps the reference's block structure: (bm, bk, bn)
blocks of ``MatmulSchedule``, fp32 accumulation across the k blocks, the
epilogue on each accumulator block at ``(i*bm, j*bn)``, and a softmax only
over a row held in one N-block.  A CPU or meta tensor takes it; a CUDA tensor
launches its route's kernel or raises.  ``matmul_blocked.launches`` counts
every launch, ``matmul_blocked.launches_by_route`` those of each route.

Training: where autograd records (grad enabled and ``a`` or ``b``
requiring it), ``matmul_padded`` with the tail that training uses (an
optional scale, then the row softmax: the MoE router's) runs through
``MatmulSoftmaxFn`` on every device, its forward the kernel on a CUDA
tensor and the plain version on the CPU, its backward
``matmul_softmax_backward`` in fp32 torch ops.  Any other tail (none, a
scale alone, the causal mask, ReLU), and ``matmul_blocked`` called
directly, raise ``NotImplementedError`` there rather than return an
output without a gradient.  ``matmul_blocked.backward_calls`` counts the backwards by the
route of their forward (``"plain"`` off the card).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.epilogue import (IDENTITY, EpilogueSpec,
                                       apply_matmul_epilogue)
from repro_torch.kernels import build as _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLITK_M = 64          # fewer rows than this take the split-K route
SPLITK_MAX_N = 512     # the finishing block's slots for a row
SPLITK_MAX_K = 16384   # 16 blocks x 1,024 rows of staged a
SM90_MAX_N = 512       # two consumer warpgroups x 256 columns


def _route(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The kernel that takes ``(m, k) @ (k, n)`` with ``dtype`` operands:
    ``"splitk"``, ``"sm90"`` or ``"fma"``.  Raises TypeError for a dtype
    that no route takes.  The bulk copies of splitk and the tensor maps of
    sm90 need 16-byte rows of b (and of a for sm90)."""
    if dtype not in _DTYPES:
        raise TypeError(f"a and b must share one of {list(_DTYPES)}; got "
                        f"{dtype}")
    elt = 2 if dtype == torch.bfloat16 else 4
    if m < SPLITK_M and n <= SPLITK_MAX_N and (n * elt) % 16 == 0 \
            and k <= SPLITK_MAX_K:
        return "splitk"
    if dtype == torch.bfloat16 and m >= SPLITK_M and k % 8 == 0 \
            and n % 8 == 0 and n <= SM90_MAX_N:
        return "sm90"
    return "fma"


@dataclasses.dataclass(frozen=True, order=True)
class MatmulSchedule:
    """The block triple of the reference's VMEM blocks, kept for the plain
    version; the CUDA kernel's tiles are its own."""

    bm: int = 128
    bk: int = 128
    bn: int = 128

    def validate(self, m: int, k: int, n: int) -> None:
        if m % self.bm or k % self.bk or n % self.bn:
            raise ValueError(f"{(m, k, n)} not divisible by {self}")

    @property
    def vmem_bytes(self) -> int:
        # a block + b block (bf16-or-fp32 ~4B worst case) + fp32 accumulator
        return 4 * (self.bm * self.bk + self.bk * self.bn
                    + self.bm * self.bn)


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 schedule: MatmulSchedule = MatmulSchedule(),
                 out_dtype: Optional[torch.dtype] = None,
                 epilogue: EpilogueSpec = IDENTITY,
                 n_valid: Optional[int] = None) -> torch.Tensor:
    """The reference's ``matmul_pallas`` as torch ops: the fp32 product
    summed over k blocks of ``bk`` in ascending order, then the epilogue on
    each (bm, bn) accumulator block.  A softmax needs ``bn == N``.  fp64
    operands sum in fp64 (``gradcheck``)."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    s = schedule
    s.validate(m, k, n)
    if epilogue.softmax and s.bn != n:
        raise ValueError(
            f"fused softmax needs the full row in one N-block: bn={s.bn} "
            f"!= n={n} (use matmul_padded, which widens bn to cover N)")
    acc_t = torch.promote_types(a.dtype, torch.float32)   # fp32, or fp64
    acc = torch.zeros((m, n), dtype=acc_t, device=a.device)
    for k0 in range(0, k, s.bk):
        acc += a[:, k0:k0 + s.bk].to(acc_t) @ b[k0:k0 + s.bk].to(acc_t)
    if epilogue != IDENTITY:
        for i in range(0, m, s.bm):
            for j in range(0, n, s.bn):
                acc[i:i + s.bm, j:j + s.bn] = apply_matmul_epilogue(
                    acc[i:i + s.bm, j:j + s.bn], epilogue, row0=i, col0=j,
                    n_valid=n_valid)
    return acc.to(out_dtype or a.dtype)


_TAIL_ARGS = [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4


def _launch_fn(route: str):
    if route == "splitk":
        return _build.entry("matmul_splitk", "matmul_splitk_launch",
                            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                            + _TAIL_ARGS + [ctypes.c_void_p])
    if route == "sm90":
        return _build.entry("matmul_blocked_sm90", "matmul_sm90_launch",
                            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                            + _TAIL_ARGS + [ctypes.c_void_p])
    return _build.entry("matmul_blocked", "matmul_blocked_launch",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                        + _TAIL_ARGS + [ctypes.c_void_p])


def cluster_size(route: str, m: int, k: int) -> int:
    """The blocks along K of one cluster of a ``route`` launch at (m, k)
    (builds the kernel on first use); 1 for fma, which has no clusters."""
    if route == "splitk":
        return int(_build.entry("matmul_splitk", "matmul_splitk_cluster",
                                [ctypes.c_int] * 2)(m, k))
    if route == "sm90":
        return int(_build.entry("matmul_blocked_sm90", "matmul_sm90_cluster",
                                [ctypes.c_int] * 2)(m, k))
    return 1


def sm90_smem_bytes(n: int) -> int:
    """The dynamic shared memory of an sm90 launch with ``n`` columns."""
    return int(_build.entry("matmul_blocked_sm90", "matmul_sm90_smem",
                            [ctypes.c_int])(n))


def matmul_softmax_backward(a: torch.Tensor, b: torch.Tensor,
                            p: torch.Tensor, dp: torch.Tensor,
                            scale: Optional[float]):
    """The gradients (da, db) of ``P = softmax(scale · a @ b)`` (rows)
    under the upstream gradient ``dp``, in a's and b's types: dZ = scale ·
    P ∘ (dP − rowsum(dP ∘ P)), da = dZ bᵀ, db = aᵀ dZ, fp32 inside (fp64
    for fp64 operands)."""
    acc_t = torch.promote_types(a.dtype, torch.float32)   # fp32, or fp64
    pf, dpf = p.to(acc_t), dp.to(acc_t)
    dz = pf * (dpf - (dpf * pf).sum(dim=-1, keepdim=True))
    if scale is not None:
        dz = dz * scale
    return ((dz @ b.to(acc_t).t()).to(a.dtype),
            (a.to(acc_t).t() @ dz).to(b.dtype))


class MatmulSoftmaxFn(torch.autograd.Function):
    """``matmul_padded``'s scale-then-softmax tail under autograd: the
    forward of ``matmul_padded`` (run with autograd off), the backward of
    ``matmul_softmax_backward``."""

    @staticmethod
    def forward(ctx, a, b, schedule, epilogue, out_dtype):
        out = matmul_padded(a, b, schedule=schedule, epilogue=epilogue,
                            out_dtype=out_dtype)
        ctx.save_for_backward(a, b, out)
        ctx.scale = epilogue.scale
        ctx.route = (_route(a.shape[0], a.shape[1], b.shape[1], a.dtype)
                     if a.device.type == "cuda" else "plain")
        return out

    @staticmethod
    def backward(ctx, dp):
        a, b, p = ctx.saved_tensors
        da, db = matmul_softmax_backward(a, b, p, dp, ctx.scale)
        _build.count_backward(matmul_blocked, ctx.route)
        return da, db, None, None, None


def _records(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether autograd records a matmul of ``a`` and ``b``."""
    return torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)


def _no_backward(epilogue: EpilogueSpec, n_valid: Optional[int]):
    raise NotImplementedError(
        f"no backward for the matmul tail {epilogue} (n_valid={n_valid}): "
        "training takes the scale-then-softmax tail of matmul_padded only")


def matmul_blocked(a: torch.Tensor, b: torch.Tensor, *,
                   schedule: MatmulSchedule = MatmulSchedule(),
                   out_dtype: Optional[torch.dtype] = None,
                   epilogue: EpilogueSpec = IDENTITY,
                   n_valid: Optional[int] = None) -> torch.Tensor:
    """``(M, K) @ (K, N)`` under ``epilogue``'s matmul tail; the signature
    of the reference's ``matmul_pallas``.  On a CPU or meta tensor this is
    ``matmul_plain`` with ``schedule``.  On a CUDA tensor it launches the
    kernel of ``_route``, which ignores ``schedule``: ``a`` and ``b``
    contiguous, one of float32 or bfloat16, ``out_dtype`` float32 or
    ``a``'s type, and 16-byte aligned for the splitk and sm90 routes.
    ``n_valid`` (softmax only) marks the first ``n_valid`` columns as real
    when N carries padding."""
    if _records(a, b):
        _no_backward(epilogue, n_valid)
    if a.device.type in _build.PLAIN_DEVICES:
        return matmul_plain(a, b, schedule=schedule, out_dtype=out_dtype,
                            epilogue=epilogue, n_valid=n_valid)
    if a.device.type != "cuda":
        raise ValueError(f"no matmul kernel for device {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected a (M, K) and b (K, N); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share one of {list(_DTYPES)}; got "
                        f"{a.dtype}, {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in (torch.float32, a.dtype):
        raise TypeError(f"out_dtype must be float32 or {a.dtype}, got "
                        f"{out_dtype}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    if n_valid is not None and not 1 <= n_valid <= n:
        raise ValueError(f"n_valid must lie in [1, N={n}], got {n_valid}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"dims {(m, k, n)} exceed the kernel's int range")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    route = _route(m, k, n, a.dtype)
    for name, t in (("a", a), ("b", b)):
        if route != "fma" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the "
                             f"{route} route")
    ep = epilogue
    tail = (int(ep.scale is not None),
            float(ep.scale) if ep.scale is not None else 1.0,
            int(ep.mask == "causal"), int(ep.softmax), int(ep.relu),
            n if n_valid is None else int(n_valid))
    dt, odt = _DTYPES[a.dtype], _DTYPES[out_dtype]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = _launch_fn(route)
        if route == "splitk":
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), dt, odt,
                     m, k, n, *tail, stream)
        elif route == "sm90":
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), odt, m, k,
                     n, *tail, stream)
        else:
            lg = out
            if ep.softmax and out_dtype != torch.float32:
                lg = torch.empty((m, n), dtype=torch.float32,
                                 device=a.device)
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                     lg.data_ptr(), dt, odt, m, k, n, *tail, stream)
    if err != 0:
        raise RuntimeError(f"matmul_blocked ({route}) launch failed: error "
                           f"{err} (a cudaError_t; 10000 + a CUresult of the "
                           "tensor-map encoder; 20000: no encoder)")
    _build.count_launch(matmul_blocked, route)
    return out


matmul_blocked.launches = 0
matmul_blocked.launches_by_route = {"splitk": 0, "sm90": 0, "fma": 0}
matmul_blocked.backward_calls = {"splitk": 0, "sm90": 0, "fma": 0,
                                 "plain": 0}


def pad_operands(a: torch.Tensor, b: torch.Tensor, schedule: MatmulSchedule,
                 epilogue: EpilogueSpec):
    """The reference ``matmul_padded``'s padding: M/K/N up to block
    multiples, ``bn`` widened to the padded N for a softmax (one N-block),
    and ``n_valid`` set where a softmax row carries padded columns.
    Returns ``(a_padded, b_padded, schedule, n_valid)``."""
    m, k = a.shape
    n = b.shape[1]
    s = schedule
    pm, pk, pn = (-m) % s.bm, (-k) % s.bk, (-n) % s.bn
    if epilogue.softmax:
        s = dataclasses.replace(s, bn=n + pn)      # one N-block, aligned
    ap = F.pad(a, (0, pk, 0, pm))
    bp = F.pad(b, (0, pn, 0, pk))
    return ap, bp, s, (n if (epilogue.softmax and pn) else None)


def matmul_padded(a: torch.Tensor, b: torch.Tensor, *,
                  schedule: MatmulSchedule = MatmulSchedule(),
                  epilogue: EpilogueSpec = IDENTITY,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Any (M, K, N) under the blocked template, output in ``out_dtype``
    (default ``a``'s type) — the wrapper the LM stack calls.  On a CPU
    tensor it pads as the reference does (``pad_operands``), runs the plain
    version and slices back.  On a CUDA tensor the kernel takes the shape
    as it is, so nothing is padded: its result equals the padded one, whose
    extra columns the ``n_valid`` mask keeps out of the softmax.  Where
    autograd records, through ``MatmulSoftmaxFn``."""
    if _records(a, b):
        if not epilogue.softmax or epilogue.mask != "none":
            _no_backward(epilogue, None)
        return MatmulSoftmaxFn.apply(a, b, schedule, epilogue, out_dtype)
    if a.device.type == "cuda":
        return matmul_blocked(a, b, epilogue=epilogue, out_dtype=out_dtype)
    m, n = a.shape[0], b.shape[1]
    ap, bp, s, n_valid = pad_operands(a, b, schedule, epilogue)
    out = matmul_blocked(ap, bp, schedule=s, epilogue=epilogue,
                         n_valid=n_valid, out_dtype=out_dtype)
    return out[:m, :n]
