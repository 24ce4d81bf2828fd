"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes of a network counted from its plain reference on the ``meta``
device (shapes only: nothing is allocated or computed).

The counter is a copy of the idea of the program's meta-device counter
(``analysis/flops.py``), kept here so that the program may change and the
yardstick may not.  It counts the products alone: a convolution at
2 x output elements x (Cin / groups x kh x kw), a matmul at 2 x M x N x K.
A conv's bytes are its input and weights read once and its output written
once (fp32), whatever the kernel that runs it reads again or fuses; so the
counts depend on the network's shapes only, never on the program's plan.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM data sheet (dense, no sparsity), at its 700 W limit; copied from
# the program's ``analysis/roofline.py``
PEAK_TF32 = 495e12           # FLOP/s on the tensor cores: no fp32-accurate
                             # product runs faster, so no share passes 100%
HBM_BW = 3.35e12             # bytes/s of device memory

_aten = torch.ops.aten


class ProductCounter(TorchDispatchMode):
    """Records each convolution and matmul dispatched while active:
    ``{"op", "flops", "bytes"}`` in ``ops``."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[Dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet is _aten.convolution:
            x, w = args[0], args[1]
            flops = 2 * out.numel() * (w.numel() // w.shape[0])
            nbytes = (x.numel() + w.numel() + out.numel()) * 4
            self.ops.append({"op": "conv", "flops": flops, "bytes": nbytes})
        elif packet in (_aten.mm, _aten.addmm):
            a, b = (args[1], args[2]) if packet is _aten.addmm else args[:2]
            flops = 2 * out.numel() * a.shape[-1]
            nbytes = (a.numel() + b.numel() + out.numel()) * 4
            self.ops.append({"op": "dense", "flops": flops,
                             "bytes": nbytes})
        return out


def count_products(reference, specs, batch: int, image: int,
                   args: dict) -> List[Dict]:
    """The products of one forward of ``reference`` at ``batch`` images of
    ``image`` pixels, counted on the meta device."""
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    for node, key, shape, _init in specs:
        params.setdefault(node, {})[key] = torch.empty(shape, device="meta")
    x = torch.empty((batch, 3, image, image), device="meta")
    with ProductCounter() as counter:
        reference.forward(params, x, **args)
    return counter.ops


def ideal_s(op: Dict) -> float:
    """The least time the card could take for ``op``: the larger of its
    operations at the TF32 peak and its bytes at the memory's rate."""
    return max(op["flops"] / PEAK_TF32, op["bytes"] / HBM_BW)


class Costs:
    """The counts a cell's readers use, per bucket (batch size)."""

    def __init__(self, reference, specs, image: int, args: dict) -> None:
        self._count = lambda b: count_products(reference, specs, b, image,
                                               args)
        self._cache: Dict[int, List[Dict]] = {}

    def ops(self, batch: int) -> List[Dict]:
        if batch not in self._cache:
            self._cache[batch] = self._count(batch)
        return self._cache[batch]

    def flops_per_image(self) -> float:
        return sum(op["flops"] for op in self.ops(1))

    def conv_ideal_s(self, batch: int) -> float:
        """Σ of ``ideal_s`` over the convs of one forward at ``batch``."""
        return math.fsum(ideal_s(op) for op in self.ops(batch)
                         if op["op"] == "conv")
