"""Plain oracles for the port's kernels, written from the mathematical
definition (no ``torch.nn.functional.conv2d``), as the JAX reference's
``repro/kernels/ref.py`` is.  The matmul and attention oracles wait for
their kernels (ROADMAP B2, B3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.layout import from_nchwc, kernel_from_kcrs_ck, to_nchwc


def conv2d_nchw_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                    pad=0, groups: int = 1) -> torch.Tensor:
    """out[n,k,oh,ow] = sum_{c,kh,kw} x[n,c,oh*s+kh-p,ow*s+kw-p] * w[k,c,kh,kw]."""
    n, c, h, wdt = x.shape
    k, c_per_g, kh, kw = w.shape
    if c != c_per_g * groups:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)} with groups={groups}")
    ph, pw = (pad, pad) if isinstance(pad, int) else tuple(pad)
    xp = F.pad(x, (pw, pw, ph, ph))
    oh = (h + 2 * ph - kh) // stride + 1
    ow = (wdt + 2 * pw - kw) // stride + 1
    outs = []
    kpg = k // groups
    for g in range(groups):
        xg = xp[:, g * c_per_g:(g + 1) * c_per_g]
        wg = w[g * kpg:(g + 1) * kpg]
        acc = torch.zeros((n, kpg, oh, ow), dtype=torch.float32,
                          device=x.device)
        for dh in range(kh):
            for dw in range(kw):
                patch = xg[:, :, dh:dh + oh * stride:stride,
                           dw:dw + ow * stride:stride]
                acc = acc + torch.einsum("nchw,kc->nkhw", patch.float(),
                                         wg[:, :, dh, dw].float())
        outs.append(acc)
    return torch.cat(outs, dim=1).to(x.dtype)


def conv2d_nchwc_ref(x_blocked: torch.Tensor, w_blocked: torch.Tensor,
                     stride: int = 1, pad=0) -> torch.Tensor:
    """Blocked-layout oracle: unblock -> NCHW conv -> reblock."""
    oc_bn = w_blocked.shape[-1]
    x = from_nchwc(x_blocked)
    w = kernel_from_kcrs_ck(w_blocked)
    out = conv2d_nchw_ref(x, w, stride=stride, pad=pad)
    return to_nchwc(out, oc_bn)
