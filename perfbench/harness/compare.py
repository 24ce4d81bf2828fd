"""What decides ``correct``: every output the window produced, against the
plain reference's output for the same input.

The number compared is ``logprob_gap``: the widest gap, over every
compared image and class, between the log of the program's probability
and the log of the reference's, where the reference's is above 1e-30 (so
no class that fp32 rounds to nothing decides it).  It is the error of a
logit in nats, whatever the softmax's spread: a one-hot output hides an
error in its small probabilities, their logs do not.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from perfbench.reference import precision_mode

FLOOR = 1e-30
BLOCK = 32


@torch.no_grad()
def reference_outputs(ref, params, pool: Sequence[torch.Tensor], args: dict,
                      device: torch.device, precision: str = "fp32"
                      ) -> List[torch.Tensor]:
    """The reference's probabilities for each pool entry (its rows), run
    in blocks of at most ``BLOCK`` images on ``device``."""
    out = []
    with precision_mode(precision, device):
        for x in pool:
            rows = []
            for i in range(0, x.shape[0], BLOCK):
                xb = x[i:i + BLOCK].to(device)
                rows.append(ref.forward(params, xb, precision=precision,
                                        **args))
            out.append(torch.cat(rows))
    return out


@torch.no_grad()
def logprob_gap(outputs: List[Tuple[int, torch.Tensor]],
                reference: List[torch.Tensor]) -> float:
    """The widest |log p - log p_ref| over ``outputs`` (pool index, rows);
    infinite where an output is not finite or no output was compared."""
    if not outputs:
        return math.inf
    worst = 0.0
    by_pool: Dict[int, List[torch.Tensor]] = {}
    for k, y in outputs:
        by_pool.setdefault(k, []).append(y)
    for k, ys in by_pool.items():
        ref = reference[k]
        mask = ref > FLOOR
        log_ref = torch.log(torch.where(mask, ref, torch.ones_like(ref)))
        for i in range(0, len(ys), BLOCK):
            y = torch.stack(ys[i:i + BLOCK]).to(ref.device, torch.float32)
            if not bool(torch.isfinite(y).all()):
                return math.inf
            gap = (torch.log(y.clamp_min(1e-45)) - log_ref).abs()
            worst = max(worst, float(gap[:, mask].max()))
    return worst
