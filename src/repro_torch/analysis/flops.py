"""Exact structural FLOP counting from the aten ops a function runs — the
port of the reference's ``repro/analysis/flops.py``.

The reference walks the traced jaxpr and multiplies a ``scan`` body by its
static length.  The port runs the function eagerly under a
``TorchDispatchMode`` that sees every aten op it dispatches, on the
``meta`` device: tensors there carry shapes and types but no storage, so a
model at full width costs no memory and no arithmetic (the kernel wrappers
take their plain versions on meta, which launch and allocate nothing).  A
Python loop runs each trip, so each trip is counted as it runs — the
counterpart of the reference's rule for ``scan``.  Backward ops run under
the mode inside ``torch.autograd.grad``, and the recomputes of
``torch.utils.checkpoint`` during the backward pass, so both are counted
and the "useful FLOPs ratio" sees checkpointing waste.

FLOPs counted: the products (``mm``, ``bmm``, ``addmm``, ``baddbmm``:
``linear``, ``matmul`` and ``einsum`` reach aten as these) at
2·batch·M·N·K, a convolution at 2 · output elements · (Cin/groups · kh ·
kw), every other op at one FLOP per output element (the reference's rule
for its elementwise and reduction primitives).  Ops that compute nothing
cost nothing: views (an output that aliases its input: ``view``,
``select``, ``slice``, ``transpose``, ``expand``, ``detach``, ...; a
Python loop's ``for w in W`` selects each trip's weights by a view) and
uninitialised allocations (``empty*``).  Bytes are counted per op as operands + results for the
"heavy" data-movers (the
reference's ``HEAVY_BYTES_PRIMS`` mapped to their aten names: products,
convolutions, gathers, scatters, sorts, cumulative sums, flips, concats,
pads, and the copies that materialise a permute, transpose or reshape) —
the perfect-elementwise-fusion assumption of standard roofline practice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

__all__ = ["HEAVY_BYTES_OPS", "CostCounter", "count_costs"]

_aten = torch.ops.aten

_PRODUCTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
# uninitialised allocations, which compute nothing
_EMPTY = {_aten.empty, _aten.empty_like, _aten.empty_strided,
          _aten.new_empty, _aten.new_empty_strided}

# the reference's HEAVY_BYTES_PRIMS by their aten names: dot_general and
# conv_general_dilated (the products and convolutions above), gather and
# take (gather, index, index_select, embedding), scatter, scatter-add
# (scatter*, index_put, index_add, index_copy, slice_scatter,
# select_scatter), dynamic_update_slice (a write into a slice: copy_),
# sort and argsort (sort, topk), cumsum and cumlogsumexp, rev (flip,
# roll), concatenate (cat, stack), pad (constant_pad_nd), and transpose
# and reshape where they copy (clone: a view copies nothing)
HEAVY_BYTES_OPS = {
    "gather", "index", "index_select", "embedding", "take",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "index_put_",
    "index_add", "index_add_", "index_copy", "slice_scatter",
    "select_scatter", "copy_", "sort", "topk", "cumsum", "cumprod",
    "logcumsumexp", "flip", "roll", "cat", "stack", "constant_pad_nd",
    "clone",
}


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _mm_flops(packet, args, out) -> int:
    """2·batch·M·N·K: the output's elements times 2K, K the contracted
    length (the left operand's last dim)."""
    a = args[1] if packet in (_aten.addmm, _aten.baddbmm) else args[0]
    return 2 * _numel(out) * a.shape[-1]


def _conv_flops(args, out) -> int:
    """2 × output elements × (Cin/groups × kh × kw): everything in the
    kernel but its output-feature dim contracts per output element."""
    w = args[1]
    return 2 * _numel(out) * (w.numel() // w.shape[0])


class CostCounter(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active: ``flops``,
    ``heavy_bytes``, and ``product_flops``, the share of ``flops`` in the
    products and convolutions."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.heavy_bytes = 0
        self.product_flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet in _EMPTY:
            return out
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        product = packet in _PRODUCTS or packet is _aten.convolution
        if product:
            f = (_mm_flops(packet, args, outs[0]) if packet in _PRODUCTS
                 else _conv_flops(args, outs[0]))
            self.flops += f
            self.product_flops += f
        else:
            self.flops += sum(_numel(t) for t in outs)
        if product or packet.__name__ in HEAVY_BYTES_OPS:
            ins = tree_flatten((args, kwargs))[0]
            self.heavy_bytes += sum(_nbytes(t) for t in ins)
            self.heavy_bytes += sum(_nbytes(t) for t in outs)
        return out


def _to_meta(x: Any) -> Any:
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return x.to("meta")
    return x


def count_costs(fn, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` on the ``meta`` device and count its
    aten ops: ``{"flops", "heavy_bytes"}``.  Every tensor in ``args`` and
    ``kwargs`` (nested in lists, tuples and dicts too) moves to meta first,
    so full widths cost no memory; tensors ``fn`` makes must be made on
    meta as well (``init_params(cfg, 0, "meta")``)."""
    args, kwargs = tree_map(_to_meta, (args, kwargs))
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return {"flops": int(counter.flops),
            "heavy_bytes": int(counter.heavy_bytes)}
