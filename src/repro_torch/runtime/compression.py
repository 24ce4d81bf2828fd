"""Gradient compression for the data-parallel all-reduce: int8 codes with
error feedback — the port of the reference's
``repro/runtime/compression.py``.

Each gradient leaf is quantized to int8 with one fp32 scale a leaf, and the
quantization residual is carried to the next step (error feedback), which
keeps SGD and Adam converging.  The codes and the scale are the
reference's: ``round`` is half to even in both packages.  On one card there
is no reduction to shrink; ``launch/train.py --compress-grads`` runs the
round trip all the same, as the reference's single-host run does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


def quantize_leaf(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g + carried error -> (int8 codes, scale, new error)."""
    target = g.float() + err
    scale = torch.clamp_min(target.abs().max(), 1e-12) / 127.0
    codes = torch.clamp(torch.round(target / scale), -127, 127).to(
        torch.int8)
    deq = codes.float() * scale
    return codes, scale, target - deq


def dequantize_leaf(codes: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    return codes.float() * scale


def init_error(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_grads(grads, err_state):
    """Returns (the gradients after the int8 round trip, in fp32; the new
    error state)."""
    outs = tree_map(quantize_leaf, grads, err_state)
    deq = tree_map(lambda _, o: dequantize_leaf(o[0], o[1]), grads, outs)
    new_err = tree_map(lambda _, o: o[2], grads, outs)
    return deq, new_err


def compression_ratio(grads) -> float:
    """The bytes of the gradients in their own type over those of their
    int8 codes and one fp32 scale a leaf."""
    leaves = tree_leaves(grads)
    native = sum(g.numel() * g.element_size() for g in leaves)
    coded = sum(g.numel() * 1 + 4 for g in leaves)
    return native / coded
