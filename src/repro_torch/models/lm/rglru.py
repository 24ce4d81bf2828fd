"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): the
port of the reference's ``repro/models/lm/rglru.py``.

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) with
a_t = exp(-c * softplus(lam) * r_t) is a diagonal linear recurrence.  The
reference computes it with ``jax.lax.associative_scan`` over time, which
torch lacks; here it is a log-depth doubling scan in torch ops, fp32
throughout: ceil(log2 T) steps, each combining every position with the
one ``2^k`` before it.  Decode is a single step.  The reference has no
TPU kernel for it, so these torch ops are the port (a hand-written scan
kernel is later work, ROADMAP B).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.ssm import causal_conv1d

_C = 8.0   # Griffin's fixed temperature on the recurrence gate


def _decay_and_input(x, i_gate, r_gate, lam):
    """a_t and the additive term b_t = sqrt(1 - a_t^2) * sigmoid(i_t) * x_t,
    in fp32, as the reference forms them."""
    log_a = -_C * F.softplus(lam.float()) * torch.sigmoid(r_gate.float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * torch.sigmoid(i_gate.float()) * x.float()
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t with h_{-1} = 0 along dim 1, by doubling:
    after the step of span s, (a_t, b_t) composes positions t - 2s + 1 ..
    t.  Each step reads the values of the one before, never its own.
    Works in place: ``a`` and ``b`` are overwritten, and ``b`` is
    returned as h."""
    t, s = a.shape[1], 1
    while s < t:
        carried = a[:, s:] * b[:, :-s]
        a_new = a[:, s:] * a[:, :-s]
        b[:, s:] += carried
        a[:, s:] = a_new
        s *= 2
    return b


def rg_lru(x: torch.Tensor, i_gate: torch.Tensor, r_gate: torch.Tensor,
           lam: torch.Tensor, h0: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, i_gate, r_gate: (B, T, W); lam: (W,).  Returns (h (B, T, W) in
    x's type, h_last (B, W) fp32)."""
    a, b = _decay_and_input(x, i_gate, r_gate, lam)
    if h0 is not None:
        # fold the carried-in state into the first step's additive term
        b[:, 0] += a[:, 0] * h0.float()
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(x: torch.Tensor, i_gate: torch.Tensor, r_gate: torch.Tensor,
                lam: torch.Tensor, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token step; all inputs (B, W).  Returns (h in x's type, h
    fp32)."""
    a, b = _decay_and_input(x, i_gate, r_gate, lam)
    h_new = a * h.float() + b
    return h_new.to(x.dtype), h_new


def recurrent_block(x: torch.Tensor, p: Dict, cfg: LMConfig, *,
                    lru_state: Optional[torch.Tensor] = None,
                    conv_state: Optional[torch.Tensor] = None,
                    decode: bool = False):
    """Griffin recurrent sublayer.  x: (B, T, d) -> (out, (lru, conv)
    states).  The gates come from one (W, 2W) product (``w_gates``, the
    ``fused_gates`` layout) or two (W, W) ones."""
    y = x @ p["wx"]                                     # (B, T, W)
    gate_branch = x @ p["wy"]                           # (B, T, W)
    y, new_conv = causal_conv1d(y, p["conv_w"], conv_state)
    if "w_gates" in p:
        gates = y @ p["w_gates"] + p["b_gates"]
        i_gate, r_gate = torch.chunk(gates, 2, dim=-1)
    else:
        i_gate = y @ p["w_in_gate"] + p["b_in_gate"]
        r_gate = y @ p["w_rec_gate"] + p["b_rec_gate"]
    if decode:
        h0 = lru_state if lru_state is not None else torch.zeros(
            (x.shape[0], cfg.lru_width), dtype=torch.float32,
            device=x.device)
        h, new_lru = rg_lru_step(y[:, 0], i_gate[:, 0], r_gate[:, 0],
                                 p["lam"], h0)
        h = h[:, None]
    else:
        h, new_lru = rg_lru(y, i_gate, r_gate, p["lam"], h0=lru_state)
    out = (h * F.gelu(gate_branch, approximate="tanh")) @ p["wo"]
    return out, (new_lru, new_conv)
