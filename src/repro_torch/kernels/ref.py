"""Plain oracles for the port's kernels, written from the mathematical
definition (no ``torch.nn.functional.conv2d``), as the JAX reference's
``repro/kernels/ref.py`` is.  The matmul oracle waits for its kernel
(ROADMAP B2).
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


# ---------------------------------------------------------------------------
# Attention (causal, GQA) — oracle for kernels/flash_attention.py
# ---------------------------------------------------------------------------

def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, S, D); k,v: (B, Hkv, S, D). Hq % Hkv == 0.
    ``window`` > 0 restricts attention to the last ``window`` positions."""
    b, hq, s, d = q.shape
    rep = hq // k.shape[1]
    kf = k.repeat_interleave(rep, dim=1).float()
    vf = v.repeat_interleave(rep, dim=1).float()
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kf)
    logits = logits / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    idx = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx[:, None] >= idx[None, :]
    if window > 0:
        mask &= idx[:, None] - idx[None, :] < window
    logits = torch.where(mask[None, None], logits, -torch.inf)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhst,bhtd->bhsd", p, vf).to(q.dtype)


# ---------------------------------------------------------------------------
# SSD intra-chunk block — oracle for kernels/ssd_chunk.py
# ---------------------------------------------------------------------------

def ssd_intra_ref(cc: torch.Tensor, bc: torch.Tensor, acum: torch.Tensor,
                  xd: torch.Tensor) -> torch.Tensor:
    """The same contraction as ssm.ssd_chunked's y_diag, as one einsum."""
    scores = torch.einsum("gin,gjn->gij", cc.float(), bc.float())
    diff = acum[..., :, None] - acum[..., None, :]    # (BC, H, Q, Q)
    q = acum.shape[-1]
    mask = torch.ones((q, q), dtype=torch.bool, device=acum.device).tril()
    ell = torch.where(mask, torch.exp(diff), 0.0)     # (BC, H, Q, Q)
    return torch.einsum("gij,ghij,ghjp->ghip", scores, ell,
                        xd.float()).to(xd.dtype)
