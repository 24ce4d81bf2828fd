"""Forward attention with an online softmax (B3): two hand-written CUDA
kernels, their wrapper, and the plain PyTorch version.

The kernels replace the JAX reference's Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` and compute
what the reference's ``models/lm/layers.py::flash_attention_xla``
computes: q ``(B, Hq, S, D)``, k and v ``(B, Hkv, Sk, D)``, GQA through
the kv-head index ``h // (Hq / Hkv)``, scale ``1/sqrt(D)``, causal and
local-window masks on absolute positions from 0 (key j is seen by query i
where ``j < Sk``, ``i >= j`` if causal and ``i - j < window`` if
windowed), NEG_INF = -1e30, the denominator clamped at 1e-30, fp32 inside
and the output in q's type.  They take any S and any Sk >= 1: Sk != S is
cross-attention (whisper's decoder against its encoder), which the
reference computes with ``flash_attention_xla`` (its Pallas kernel asserts
Sk == S).  A window needs Sk >= S, so that every query row sees a key.
The route is chosen by dtype before any launch (``_route``):

* ``sm90`` (bf16, the serving path): ``csrc/flash_attention_sm90.cu``,
  wgmma on the tensor cores fed by TMA, any D that is a multiple of 16
  from 16 to 256;
* ``fma`` (fp32): ``csrc/flash_attention.cu`` on the fp32 FMA units,
  the same head dims.

Each source's header says what bounds it on the H100 and what its design
does about it.  A CPU or meta tensor takes the plain version; a CUDA tensor
launches its route's kernel or raises.  ``flash_attention.launches``
counts every launch, ``flash_attention.launches_by_route`` those of each
route.

Training: where autograd records (grad enabled and q, k or v requiring
it), ``flash_attention`` runs through ``FlashAttentionFn``, on every
device: its forward is the kernel on a CUDA tensor and the plain version on
the CPU, its backward ``flash_attention_backward``, the analytic gradient in
torch ops (fp32 inside), by chunks of query rows, from the saved q, k, v
and output.  The reference has no backward kernel either: its gradient is
XLA's autodiff of ``flash_attention_xla``.
``flash_attention.backward_calls`` counts the backwards by the route of
their forward (``"plain"`` off the card).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build

NEG_INF = -1e30
HEAD_DIMS = {"sm90": tuple(range(16, 257, 16)),
             "fma": tuple(range(16, 257, 16))}
_ROUTES = {torch.bfloat16: "sm90", torch.float32: "fma"}


def _route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes a ``dtype`` q, k, v of head dim ``d``:
    ``"sm90"`` or ``"fma"``.  Raises TypeError for a dtype that no route
    takes and ValueError for a head dim that its route cannot take."""
    route = _ROUTES.get(dtype)
    if route is None:
        raise TypeError(f"q, k, v must share one of {list(_ROUTES)}; got "
                        f"{dtype}")
    if d not in HEAD_DIMS[route]:
        raise ValueError(f"head dim {d} not in the {route} route's "
                         f"{HEAD_DIMS[route]}")
    return route


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_chunk: int = 1024,
                          kv_chunk: int = 1024) -> torch.Tensor:
    """The reference's online-softmax loop (``flash_attention_xla``) in
    torch: the same chunking, padding, masks and NEG_INF, every kv chunk
    visited in ascending order.  Memory O(S * chunk), not O(S^2).  fp32
inside (fp64 for fp64 inputs, as ``gradcheck`` needs)."""
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    cq = min(q_chunk, s)
    ckv = min(kv_chunk, sk)
    pad_q = (-s) % cq
    pad_k = (-sk) % ckv
    qp = F.pad(q, (0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, pad_k))
    nq, nk = (s + pad_q) // cq, (sk + pad_k) // ckv
    qs = qp.reshape(b, hkv, g, nq, cq, d)
    ks = kp.reshape(b, hkv, nk, ckv, d)
    vs = vp.reshape(b, hkv, nk, ckv, d)
    dev = q.device
    acc_t = torch.promote_types(q.dtype, torch.float32)   # fp32, or fp64
    outs = []
    for qi in range(nq):
        qblk = qs[:, :, :, qi].to(acc_t)                 # (B, Hkv, G, cq, D)
        q_pos = qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, hkv, g, cq), NEG_INF, dtype=acc_t,
                       device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=acc_t, device=dev)
        acc = torch.zeros((b, hkv, g, cq, d), dtype=acc_t, device=dev)
        for ki in range(nk):
            kblk = ks[:, :, ki].to(acc_t)
            vblk = vs[:, :, ki].to(acc_t)
            k_pos = ki * ckv + torch.arange(ckv, device=dev)
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kblk) * scale
            mask = (k_pos < sk)[None, :]
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window > 0:
                mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vblk)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.to(q.dtype))
    # (B, Hkv, G, nq, cq, D) -> (B, Hq, S, D)
    out = torch.stack(outs, dim=3).reshape(b, hq, s + pad_q, d)
    return out[:, :, :s]


# the route's source and C entry; both take (q, k, v, o, b, hq, hkv, s, sk,
# d, causal, window, stream)
_SOURCES = {"sm90": ("flash_attention_sm90", "flash_attention_sm90_launch"),
            "fma": ("flash_attention", "flash_attention_launch")}


def _launch_fn(route: str):
    return _build.entry(*_SOURCES[route], [ctypes.c_void_p] * 4
                        + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def sm90_smem_bytes(d: int) -> int:
    """The dynamic shared memory that the sm90 kernel's block asks for at
    head dim ``d`` (builds the kernel on first use)."""
    fn = _build.entry("flash_attention_sm90", "flash_attention_sm90_smem",
                      [ctypes.c_int])
    return int(fn(d))


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0, q_chunk: int = 1024):
    """The gradients (dq, dk, dv) of ``flash_attention``'s output ``o``
    under the upstream gradient ``do``, in q's, k's and v's types.  For
    each chunk of ``q_chunk`` query rows, in fp32: the masked scores and P
    = softmax with the forward's NEG_INF and 1e-30 clamp, dV += Pᵀ dO,
    dP = dO Vᵀ, dS = P ∘ (dP − rowsum(dO ∘ O)), dQ = dS K / √D and
    dK += dSᵀ Q / √D, each GQA group's Hq / Hkv heads summed into their kv
    head.  Keys that no row of the chunk sees (past its causal end, before
    its window) are left out: their P is exactly 0."""
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    acc_t = torch.promote_types(q.dtype, torch.float32)   # fp32, or fp64
    kf, vf = k.to(acc_t), v.to(acc_t)
    dk = torch.zeros((b, hkv, sk, d), dtype=acc_t, device=dev)
    dv = torch.zeros_like(dk)
    dq = torch.empty((b, hq, s, d), dtype=acc_t, device=dev)
    cq = max(1, min(q_chunk, s))
    for q0 in range(0, s, cq):
        q1 = min(q0 + cq, s)
        n = q1 - q0
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        k1 = min(sk, q1) if causal else sk
        qb = q[:, :, q0:q1].to(acc_t).reshape(b, hkv, g, n, d)
        ob = o[:, :, q0:q1].to(acc_t).reshape(b, hkv, g, n, d)
        dob = do[:, :, q0:q1].to(acc_t).reshape(b, hkv, g, n, d)
        kb, vb = kf[:, :, k0:k1], vf[:, :, k0:k1]
        q_pos = torch.arange(q0, q1, device=dev)[:, None]
        k_pos = torch.arange(k0, k1, device=dev)[None, :]
        mask = torch.ones((n, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window > 0:
            mask = mask & (q_pos - k_pos < window)
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
        sc = torch.where(mask, sc, NEG_INF)
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
        dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", p, dob)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vb)
        ds = p * (dp - (dob * ob).sum(dim=-1, keepdim=True))
        dq[:, :, q0:q1] = (torch.einsum("bhgqk,bhkd->bhgqd", ds, kb)
                           * scale).reshape(b, hq, n, d)
        dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward of ``_forward`` (the
    kernel on a CUDA tensor, the plain version on the CPU), the backward of
    ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        out, route = _forward(q, k, v, causal, window, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = (causal, window, q_chunk, route)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        causal, window, q_chunk, route = ctx.args
        dq, dk, dv = flash_attention_backward(q, k, v, out, do,
                                              causal=causal, window=window,
                                              q_chunk=q_chunk)
        _build.count_backward(flash_attention, route)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, Sk, D); Hq % Hkv == 0.  The
    signature of the reference's ``flash_attention_xla``: ``q_chunk`` and
    ``kv_chunk`` are the plain version's chunks and the kernel's tiles are
    its own.  Where autograd records, through ``FlashAttentionFn``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_chunk,
                                      kv_chunk)
    return _forward(q, k, v, causal, window, q_chunk, kv_chunk)[0]


def _forward(q, k, v, causal, window, q_chunk, kv_chunk):
    """The forward and its route: the plain version (``"plain"``) on a CPU
    or meta tensor, else the route's kernel."""
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_chunk=q_chunk,
                                     kv_chunk=kv_chunk), "plain"
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B, Hq, S, D), k and v (B, Hkv, Sk, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, sk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({b}, Hkv, Sk, {d})")
    if sk < 1:
        raise ValueError("k and v hold no position (Sk = 0)")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if q.dtype not in _ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_ROUTES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    route = _route(q.dtype, d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window > 0 and sk < s:
        raise ValueError(f"a window needs Sk >= S; got Sk={sk}, S={s}")
    out = torch.empty_like(q)
    if s == 0 or b == 0:
        return out, route
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launch_fn(route)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), b, hq, hkv, s, sk, d,
                                int(causal), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({route}) launch failed: "
                           f"error {err} (a cudaError_t; 10000 + a CUresult "
                           "of the tensor-map encoder; 20000: no encoder)")
    _build.count_launch(flash_attention, route)
    return out, route


flash_attention.launches = 0
flash_attention.launches_by_route = {"sm90": 0, "fma": 0}
flash_attention.backward_calls = {"sm90": 0, "fma": 0, "plain": 0}
