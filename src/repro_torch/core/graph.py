"""Computation-graph IR (NeoCPU §2.2, §3.2).

A model is a DAG of named nodes.  Each node is an operation with typed
attributes; edges carry logical-NCHW tensors whose *physical* layout is decided
by the planner.  This IR is deliberately small: it exists so the layout passes
(transform elimination, global scheme search) have something graph-shaped to
rewrite, exactly as NeoCPU adds passes to the TVM graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.epilogue import PoolSpec
from repro_torch.core.layout import LayoutCategory

# op name -> layout category (paper §3.2's three classes)
OP_CATEGORY: Dict[str, LayoutCategory] = {
    "conv2d": LayoutCategory.TOLERANT,
    # fused CONV -> BN -> ReLU (-> add) epilogue produced by core.fusion;
    # layout-tolerant *as a unit* (§3.1 fusion before §3.3 layout planning)
    "conv_block": LayoutCategory.TOLERANT,
    "batch_norm": LayoutCategory.TOLERANT,
    "max_pool": LayoutCategory.TOLERANT,
    "avg_pool": LayoutCategory.TOLERANT,
    "global_avg_pool": LayoutCategory.TOLERANT,
    "relu": LayoutCategory.OBLIVIOUS,
    "softmax": LayoutCategory.OBLIVIOUS,  # over channel axis; planner keeps axis
    "add": LayoutCategory.OBLIVIOUS,      # but requires *matching* input layouts
    "concat": LayoutCategory.OBLIVIOUS,   # channel concat requires matching blocks
    # concat-fusion buffer seed (core.fusion.fuse_concat_writes): allocates
    # the shared concat buffer and places the pass-through operands
    "concat_alloc": LayoutCategory.OBLIVIOUS,
    "flatten": LayoutCategory.DEPENDENT,
    "reshape": LayoutCategory.DEPENDENT,
    "dense": LayoutCategory.DEPENDENT,
    "input": LayoutCategory.DEPENDENT,
    "layout_transform": LayoutCategory.DEPENDENT,
    "l2_normalize": LayoutCategory.OBLIVIOUS,
    "multibox_head": LayoutCategory.DEPENDENT,
}

# ops whose multiple inputs must agree on one layout (§3.3.2: Elementwise_Add
# "could not be omitted since it requires the layout of its two inputs to be
# the same"); concat along channels likewise requires equal channel blocks.
MULTI_INPUT_SAME_LAYOUT = {"add", "concat", "concat_alloc"}


@dataclasses.dataclass
class Node:
    name: str
    op: str
    inputs: List[str] = dataclasses.field(default_factory=list)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # logical NCHW output shape, filled by shape inference
    shape: Optional[Tuple[int, ...]] = None

    @property
    def category(self) -> LayoutCategory:
        return OP_CATEGORY[self.op]


class Graph:
    """A small append-only DAG with topological iteration."""

    def __init__(self) -> None:
        self.nodes: Dict[str, Node] = {}
        self.outputs: List[str] = []

    # -- construction ------------------------------------------------------
    def add(self, name: str, op: str, inputs: Sequence[str] = (),
            **attrs: Any) -> str:
        if name in self.nodes:
            raise ValueError(f"duplicate node {name!r}")
        for i in inputs:
            if i not in self.nodes:
                raise ValueError(f"node {name!r} references unknown input {i!r}")
        if op not in OP_CATEGORY:
            raise ValueError(f"unknown op {op!r}")
        self.nodes[name] = Node(name=name, op=op, inputs=list(inputs), attrs=attrs)
        return name

    def mark_output(self, name: str) -> None:
        if name not in self.nodes:
            raise ValueError(f"unknown output {name!r}")
        self.outputs.append(name)

    # -- traversal ----------------------------------------------------------
    def topo_order(self) -> List[Node]:
        order: List[Node] = []
        seen: Dict[str, int] = {}  # 0=visiting, 1=done

        def visit(name: str) -> None:
            state = seen.get(name)
            if state == 1:
                return
            if state == 0:
                raise ValueError(f"cycle through {name!r}")
            seen[name] = 0
            for i in self.nodes[name].inputs:
                visit(i)
            seen[name] = 1
            order.append(self.nodes[name])

        for name in self.nodes:  # insertion order keeps rewrites stable
            visit(name)
        return order

    def successors(self) -> Dict[str, List[str]]:
        succ: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for node in self.nodes.values():
            for i in node.inputs:
                succ[i].append(node.name)
        return succ

    def conv_nodes(self) -> List[Node]:
        """All schedulable convolutions — plain and fused (conv_block)."""
        return [n for n in self.topo_order()
                if n.op in ("conv2d", "conv_block")]

    # -- shape inference -----------------------------------------------------
    def infer_shapes(self, input_shapes: Dict[str, Tuple[int, ...]]) -> None:
        for node in self.topo_order():
            node.shape = _infer_one(self, node, input_shapes)

    def __repr__(self) -> str:
        return f"Graph({len(self.nodes)} nodes, outputs={self.outputs})"


def _conv_out_hw(h: int, w: int, kh: int, kw: int, stride: int, pad: int,
                 dilation: int = 1, pad_w: int = -1) -> Tuple[int, int]:
    if pad_w < 0:
        pad_w = pad
    eff_kh = (kh - 1) * dilation + 1
    eff_kw = (kw - 1) * dilation + 1
    return ((h + 2 * pad - eff_kh) // stride + 1,
            (w + 2 * pad_w - eff_kw) // stride + 1)


def _infer_one(g: Graph, node: Node, input_shapes) -> Tuple[int, ...]:
    ins = [g.nodes[i].shape for i in node.inputs]
    a = node.attrs
    if node.op == "input":
        return tuple(input_shapes[node.name])
    if node.op in ("conv2d", "conv_block"):
        # conv_block: inputs[0] is data; an optional residual input has the
        # conv's own output shape, and a concat-fused block's last input is
        # the shared buffer — neither changes shape inference of the conv
        n, c, h, w = ins[0]
        oh, ow = _conv_out_hw(h, w, a["kh"], a["kw"], a.get("stride", 1),
                              a.get("pad", 0), a.get("dilation", 1),
                              a.get("pad_w", -1))
        groups = a.get("groups", 1)
        assert c == a["in_channels"], (node.name, c, a["in_channels"])
        del groups
        if a.get("pool_kind"):          # fused pooling epilogue
            oh, ow = PoolSpec(
                a["pool_kind"], a["pool_k"], a["pool_stride"],
                a.get("pool_pad", 0),
                bool(a.get("pool_ceil", False))).out_hw(oh, ow)
        channels = a["out_channels"]
        if a.get("concat_into"):        # the block's tensor IS the buffer
            channels = a["concat_total"]
        return (n, channels, oh, ow)
    if node.op == "concat_alloc":
        n, _, h, w = ins[0]
        return (n, a["total_channels"], h, w)
    if node.op in ("max_pool", "avg_pool"):
        n, c, h, w = ins[0]
        oh, ow = _conv_out_hw(h, w, a["k"], a["k"], a.get("stride", a["k"]),
                              a.get("pad", 0))
        if a.get("ceil_mode"):
            # recompute with ceil division
            k, s, p = a["k"], a.get("stride", a["k"]), a.get("pad", 0)
            oh = -(-(h + 2 * p - k) // s) + 1
            ow = -(-(w + 2 * p - k) // s) + 1
        return (n, c, oh, ow)
    if node.op == "global_avg_pool":
        n, c, _, _ = ins[0]
        return (n, c, 1, 1)
    if node.op in ("relu", "batch_norm", "softmax", "l2_normalize"):
        return ins[0]
    if node.op == "add":
        assert all(s == ins[0] for s in ins), f"add shape mismatch {ins}"
        return ins[0]
    if node.op == "concat":
        if len(ins[0]) == 2:  # flattened heads (SSD): concat along features
            return (ins[0][0], sum(s[1] for s in ins))
        n, _, h, w = ins[0]
        return (n, sum(s[1] for s in ins), h, w)
    if node.op == "flatten":
        n = ins[0][0]
        total = 1
        for d in ins[0][1:]:
            total *= d
        return (n, total)
    if node.op == "reshape":
        return tuple(a["shape"])
    if node.op == "dense":
        return (ins[0][0], a["units"])
    if node.op == "layout_transform":
        return ins[0]
    if node.op == "multibox_head":
        # SSD head: flattened box/class predictions
        return (ins[0][0], a["num_outputs"])
    raise NotImplementedError(node.op)
