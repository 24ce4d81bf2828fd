"""Layout-transformation elimination (NeoCPU §3.2).

Takes a computation graph plus a per-CONV scheme assignment and rewrites the
graph so that:

* every CONV consumes ``NCHW[ic_bn]c`` and produces ``NCHW[oc_bn]c``;
* layout-oblivious and layout-tolerant ops pass the blocked layout through;
* explicit ``layout_transform`` nodes are inserted *only* at category
  boundaries (graph input, layout-dependent ops, scheme mismatches between
  neighbouring CONVs, multi-input ops whose operands disagree);
* multi-input ops (add, concat) fix the layout of their first input and
  convert the others to it (§3.3.2's Elementwise_Add rule).

Weight pre-transformation (§3.2: "the layout of the model parameters ... is
invariant so can be pre-transformed during the compilation") happens in the
engine when parameters are bound, driven by the schedules recorded here.

The pass also implements the *ablation modes* of Table 3:
``around_each_conv=True`` reproduces row 2 (each CONV transforms in and out,
as a library-backed framework would); the default reproduces rows 3-4.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.graph import Graph, MULTI_INPUT_SAME_LAYOUT, Node
from repro_torch.core.layout import (Layout, LayoutCategory, NCHW, nchwc,
                               transform_bytes)
from repro_torch.core.schedule import ConvSchedule


@dataclasses.dataclass
class PlannedGraph:
    graph: Graph                      # rewritten, includes layout_transform nodes
    layouts: Dict[str, Layout]        # node name -> output layout
    schedules: Dict[str, ConvSchedule]  # conv node name -> schedule
    n_transforms: int                 # runtime transforms inserted
    transform_bytes_total: int        # data moved by them (per inference)


class _Rewriter:
    def __init__(self, src: Graph, schedules: Dict[str, ConvSchedule],
                 around_each_conv: bool) -> None:
        self.src = src
        self.schedules = schedules
        self.around = around_each_conv
        self.out = Graph()
        self.layout: Dict[str, Layout] = {}   # new-graph node -> layout
        self.mapped: Dict[str, str] = {}      # old name -> new name
        self.n_transforms = 0
        self.bytes_moved = 0
        self._uid = 0

    # -- helpers -------------------------------------------------------------
    def _fresh(self, base: str) -> str:
        self._uid += 1
        return f"{base}__lt{self._uid}"

    def _ensure(self, name: str, want: Layout) -> str:
        """Return a node producing ``name``'s tensor in layout ``want``,
        inserting a layout_transform if necessary."""
        have = self.layout[name]
        if have == want:
            return name
        shape = self.out.nodes[name].shape
        t = self.out.add(self._fresh(name), "layout_transform", [name],
                         src_layout=have, dst_layout=want)
        self.out.nodes[t].shape = shape
        self.layout[t] = want
        self.n_transforms += 1
        self.bytes_moved += transform_bytes(shape, have, want)
        return t

    def _emit(self, node: Node, inputs: List[str], layout: Layout) -> str:
        new = self.out.add(node.name, node.op, inputs, **dict(node.attrs))
        self.out.nodes[new].shape = node.shape
        self.layout[new] = layout
        self.mapped[node.name] = new
        return new

    # -- the pass ------------------------------------------------------------
    def run(self) -> PlannedGraph:
        for node in self.src.topo_order():
            ins = [self.mapped[i] for i in node.inputs]
            if node.op == "input":
                self._emit(node, [], NCHW)
            elif node.op in ("conv2d", "conv_block"):
                self._rewrite_conv(node, ins)
            elif node.op in MULTI_INPUT_SAME_LAYOUT:
                self._rewrite_multi(node, ins)
            elif node.category is LayoutCategory.DEPENDENT:
                ins = [self._ensure(i, NCHW) for i in ins]
                self._emit(node, ins, NCHW)
            else:  # oblivious / tolerant single-input: pass layout through
                lay = self.layout[ins[0]] if ins else NCHW
                self._emit(node, ins, lay)
        for o in self.src.outputs:
            # model boundary is NCHW (paper: "we still have NCHW input and
            # output for the network")
            final = self._ensure(self.mapped[o], NCHW)
            self.out.mark_output(final)
        return PlannedGraph(graph=self.out, layouts=self.layout,
                            schedules=dict(self.schedules),
                            n_transforms=self.n_transforms,
                            transform_bytes_total=self.bytes_moved)

    def _rewrite_conv(self, node: Node, ins: List[str]) -> None:
        # handles conv2d and the fused conv_block; a conv_block's extra
        # inputs (the residual, and the shared concat buffer under
        # concat-write fusion) are consumed in the conv's *output* layout,
        # because the fused add / offset store happen after the channel
        # contraction
        sched = self.schedules.get(node.name)
        if sched is None:  # NCHW-baseline mode: no blocking at all
            ins = [self._ensure(i, NCHW) for i in ins]
            self._emit(node, ins, NCHW)
            return
        want_in = nchwc(sched.ic_bn)
        want_out = nchwc(sched.oc_bn)
        if self.around:
            # Table 3 row 2: transform in, compute blocked, transform out
            data = self._ensure(self._ensure(ins[0], NCHW), want_in)
        else:
            data = self._ensure(ins[0], want_in)
        new_ins = [data] + [self._ensure(i, want_out) for i in ins[1:]]
        new = self._emit(node, new_ins, want_out)
        if self.around:
            back = self._ensure(new, NCHW)
            self.mapped[node.name] = back

    def _rewrite_multi(self, node: Node, ins: List[str]) -> None:
        # §3.3.2: fix the layout of the first input, convert the rest to it.
        target = self.layout[ins[0]]
        if node.op == "concat" and target.is_blocked:
            # channel-concat in NCHW[x]c needs every operand's channel count
            # divisible by x; otherwise fall back to NCHW for this node.
            chans = [self.src.nodes[i].shape[1] for i in node.inputs]
            lays = [self.layout[i] for i in ins]
            ok = all(c % target.block == 0 for c in chans)
            if not ok:
                target = NCHW
        if node.op == "concat_alloc" and target.is_blocked:
            # the buffer seed additionally needs every pass-through offset
            # and the buffer's own channel count on block boundaries
            a = node.attrs
            chans = [self.src.nodes[i].shape[1] for i in node.inputs]
            ok = (a["total_channels"] % target.block == 0
                  and all(c % target.block == 0 for c in chans)
                  and all(o % target.block == 0 for o in a["offsets"]))
            if not ok:
                target = NCHW
        ins = [self._ensure(i, target) for i in ins]
        self._emit(node, ins, target)


def eliminate_transforms(graph: Graph,
                         schedules: Dict[str, ConvSchedule],
                         around_each_conv: bool = False) -> PlannedGraph:
    """Rewrite ``graph`` under the given per-CONV schedules.  ``graph`` must
    have shapes inferred.  An empty ``schedules`` dict produces the pure-NCHW
    baseline graph (no blocking, no transforms)."""
    return _Rewriter(graph, schedules, around_each_conv).run()
