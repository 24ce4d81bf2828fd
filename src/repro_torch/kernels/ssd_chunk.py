"""The SSD intra-chunk block of Mamba-2 (B4): the hand-written CUDA kernel,
its wrapper, and its plain PyTorch version.

The kernel (``csrc/ssd_chunk.cu``) replaces the JAX reference's Pallas TPU
kernel ``repro/kernels/ssd_chunk.py::ssd_intra_pallas`` and keeps its
signature: ``cc, bc (BC, Q, N)`` shared across heads, ``acum (BC, H, Q)``
cumulative log decays, ``xd (BC, H, Q, P)``; it returns

    y[g, h, i] = sum_{j <= i} (cc[g, i] . bc[g, j]) exp(acum[g, h, i] -
                 acum[g, h, j]) xd[g, h, j]

in fp32.  The source's header says what bounds it on the H100 and how it
tiles the (Q, Q) block that the TPU kernel kept whole.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``ssd_intra.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build

MAX_P = 64


def ssd_intra_plain(cc: torch.Tensor, bc: torch.Tensor, acum: torch.Tensor,
                    xd: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's body as plain torch ops, batched over (BC, H):
    scores ``cc @ bc^T``, the lower-triangular decay ``exp(acum_i -
    acum_j)``, then ``(scores * decay) @ xd``, fp32 inside."""
    q = cc.shape[1]
    scores = cc.float() @ bc.float().transpose(-1, -2)      # (BC, Q, Q)
    diff = acum.float()[..., :, None] - acum.float()[..., None, :]
    lower = torch.ones((q, q), dtype=torch.bool, device=cc.device).tril()
    ell = torch.where(lower, torch.exp(diff), 0.0)          # (BC, H, Q, Q)
    return ((scores[:, None] * ell) @ xd.float()).to(xd.dtype)


def _launch_fn():
    return _build.entry("ssd_chunk", "ssd_intra_launch",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])


def ssd_intra(cc: torch.Tensor, bc: torch.Tensor, acum: torch.Tensor,
              xd: torch.Tensor) -> torch.Tensor:
    """cc, bc: (BC, Q, N); acum: (BC, H, Q); xd: (BC, H, Q, P), all fp32
    and contiguous on the card.  Returns y_diag (BC, H, Q, P)."""
    if cc.device.type == "cpu":
        return ssd_intra_plain(cc, bc, acum, xd)
    if cc.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {cc.device}")
    if cc.dim() != 3 or xd.dim() != 4:
        raise ValueError(f"expected cc, bc (BC, Q, N) and xd (BC, H, Q, P); "
                         f"got {tuple(cc.shape)}, {tuple(xd.shape)}")
    bcn, q, n = cc.shape
    _, h, _, p = xd.shape
    for name, t, shape in (("cc", cc, (bcn, q, n)), ("bc", bc, (bcn, q, n)),
                           ("acum", acum, (bcn, h, q)),
                           ("xd", xd, (bcn, h, q, p))):
        if t.device != cc.device:
            raise ValueError(f"{name} is on {t.device}, cc on {cc.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p > MAX_P:
        raise ValueError(f"head dim P={p} above the kernel's {MAX_P}")
    out = torch.empty_like(xd)
    if out.numel() == 0:
        return out
    with torch.cuda.device(cc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launch_fn()(cc.data_ptr(), bc.data_ptr(), acum.data_ptr(),
                           xd.data_ptr(), out.data_ptr(), bcn, h, q, n, p,
                           stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra launch failed: cudaError_t {err}")
    ssd_intra.launches += 1
    return out


ssd_intra.launches = 0
