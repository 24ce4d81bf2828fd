"""Graph-level operation fusion (NeoCPU §3.1).

The first graph optimization the paper applies before any layout planning:
CONV followed by cheap elementwise post-processing should execute in one
pass, so the BN scale/shift, residual add and ReLU happen while the conv's
output is still in registers instead of round-tripping each intermediate
through device memory.

This pass pattern-matches the epilogue shapes the CNN zoo produces

    conv2d [+bias] -> batch_norm -> relu                 (plain unit)
    conv2d [+bias] [-> batch_norm] -> add(residual) -> relu   (ResNet tail)
    conv2d ... -> max_pool/avg_pool             (stem / transition tails)

plus every prefix of them (``conv -> bn``, ``conv -> relu``,
``conv -> add``, ``conv -> pool``), and collapses each chain into a single
``conv_block`` node that carries the conv attributes plus an epilogue
description:

    bn_from   name of the absorbed batch_norm (its scale/shift fold into
              the conv at bind time — §3.2 weight pre-transformation)
    relu      apply max(x, 0) before the final store
    pool_*    fused pooling reduction (kind/k/stride/pad/ceil): runs over
              the fp32 accumulator tile before it is stored, so the stem
              ``conv7x7 -> bn -> relu -> max_pool3x3s2`` is one kernel
    inputs    [data] or [data, residual]; the residual is consumed in the
              conv's *output* layout, which the planner turns into a
              layout coupling exactly like Elementwise_Add (§3.3.2)

Fusion legality is the classic sole-consumer rule: a node is absorbed only
if the chain tensor feeding it has no other consumer and is not a graph
output — a conv feeding two consumers keeps its intermediate materialized
and must not fuse past the fan-out.

A second phase (``fuse_concat_writes``) rewrites DenseNet-style
``concat(conv_block outs)``: each producing conv_block whose sole consumer
is the concat gets a channel-offset write into the shared concat buffer
(attrs ``concat_into``/``concat_offset``/``concat_total``; the buffer rides
in as the block's last input), a ``concat_alloc`` node seeds the buffer
with the pass-through operands, and the standalone concat copy disappears.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.graph import Graph, Node


@dataclasses.dataclass
class FusedChain:
    """One matched conv epilogue chain (all names refer to the source graph)."""

    conv: str
    bn: Optional[str] = None
    residual: Optional[str] = None     # producer of the second add input
    relu: bool = False
    pool: Optional[str] = None         # absorbed pooling node
    absorbed: List[str] = dataclasses.field(default_factory=list)

    @property
    def tail(self) -> str:
        """Last absorbed node — the tensor the block's consumers see."""
        return self.absorbed[-1]


@dataclasses.dataclass
class FusionReport:
    n_blocks: int                       # conv_block nodes emitted
    n_absorbed: int                     # bn/relu/add/pool nodes removed
    chains: Dict[str, FusedChain]       # conv name -> its chain
    n_concat_fused: int = 0             # concat copies turned into writes
    n_pool_fused: int = 0               # pooling nodes fused into epilogues


def _sole_consumer(graph: Graph, succ: Dict[str, List[str]],
                   outputs: Set[str], name: str) -> Optional[Node]:
    """The unique consumer of ``name``, or None if the tensor must stay
    materialized (fan-out > 1, or it is a model output)."""
    if name in outputs:
        return None
    consumers = succ[name]
    if len(consumers) != 1:
        return None
    return graph.nodes[consumers[0]]


def _match_chain(graph: Graph, succ: Dict[str, List[str]], outputs: Set[str],
                 conv: Node, taken: Set[str]) -> Optional[FusedChain]:
    """Greedy longest match of conv -> [bn] -> [add] -> [relu]."""
    chain = FusedChain(conv=conv.name)
    tail = conv.name

    def absorb(node: Node) -> str:
        chain.absorbed.append(node.name)
        return node.name

    nxt = _sole_consumer(graph, succ, outputs, tail)
    if nxt is not None and nxt.op == "batch_norm" and nxt.name not in taken:
        chain.bn = nxt.name
        tail = absorb(nxt)
        nxt = _sole_consumer(graph, succ, outputs, tail)
    if (nxt is not None and nxt.op == "add" and nxt.name not in taken
            and len(nxt.inputs) == 2 and tail in nxt.inputs):
        others = [i for i in nxt.inputs if i != tail]
        # x + x (both operands the chain tensor) cannot become a residual
        if len(others) == 1 and others[0] not in chain.absorbed:
            chain.residual = others[0]
            tail = absorb(nxt)
            nxt = _sole_consumer(graph, succ, outputs, tail)
    if nxt is not None and nxt.op == "relu" and nxt.name not in taken:
        chain.relu = True
        tail = absorb(nxt)
        nxt = _sole_consumer(graph, succ, outputs, tail)
    if (nxt is not None and nxt.op in ("max_pool", "avg_pool")
            and nxt.name not in taken):
        # fused pooling: the reduction runs over the fp32 accumulator tile
        # before the store (stem conv->bn->relu->max_pool is one kernel)
        chain.pool = nxt.name
        absorb(nxt)
    return chain if chain.absorbed else None


def fuse_graph(graph: Graph) -> Tuple[Graph, FusionReport]:
    """Both fusion phases composed: epilogue chains, then concat writes.
    Kept as the one-call form; the pass pipeline (``core.pipeline``) runs
    ``fuse_epilogues`` and ``fuse_concat_writes`` as separate passes."""
    fused, report = fuse_epilogues(graph)
    fused, n_concat = fuse_concat_writes(fused)
    report.n_concat_fused = n_concat
    return fused, report


def fuse_epilogues(graph: Graph) -> Tuple[Graph, FusionReport]:
    """Phase 1 only: rewrite ``graph`` with every matched epilogue chain
    collapsed into a ``conv_block`` node named after its conv (so conv
    parameters bind under the same key; the absorbed BN's name is kept in
    ``bn_from``)."""
    succ = graph.successors()
    outputs = set(graph.outputs)
    taken: Set[str] = set()             # absorbed epilogue nodes
    chains: Dict[str, FusedChain] = {}
    for node in graph.topo_order():
        if node.op != "conv2d" or node.attrs.get("groups", 1) != 1:
            continue
        chain = _match_chain(graph, succ, outputs, node, taken)
        if chain is not None:
            chains[node.name] = chain
            taken.update(chain.absorbed)

    tail_of = {c.tail: c for c in chains.values()}
    fused = Graph()
    mapped: Dict[str, str] = {}
    for node in graph.topo_order():
        chain = tail_of.get(node.name)
        if chain is not None:
            # the block is emitted at its *tail's* topo position so the
            # residual producer (an input of the absorbed add) already exists
            conv = graph.nodes[chain.conv]
            attrs = dict(conv.attrs)
            attrs.update(bn_from=chain.bn, relu=chain.relu,
                         fused_from=tuple(chain.absorbed))
            if chain.pool is not None:
                p = graph.nodes[chain.pool]
                attrs.update(
                    pool_kind="max" if p.op == "max_pool" else "avg",
                    pool_k=p.attrs["k"],
                    pool_stride=p.attrs.get("stride", p.attrs["k"]),
                    pool_pad=p.attrs.get("pad", 0),
                    pool_ceil=bool(p.attrs.get("ceil_mode", False)))
            inputs = [mapped[conv.inputs[0]]]
            if chain.residual is not None:
                inputs.append(mapped[chain.residual])
            fused.add(conv.name, "conv_block", inputs, **attrs)
            # a fused pool changes the block's output shape to the tail's
            fused.nodes[conv.name].shape = graph.nodes[chain.tail].shape
            for name in (chain.conv, *chain.absorbed):
                mapped[name] = conv.name
        elif node.name in taken or node.name in chains:
            continue                    # emitted with its chain's tail
        else:
            fused.add(node.name, node.op,
                      [mapped[i] for i in node.inputs], **dict(node.attrs))
            fused.nodes[node.name].shape = node.shape
            mapped[node.name] = node.name
    for o in graph.outputs:
        fused.mark_output(mapped[o])
    report = FusionReport(
        n_blocks=len(chains),
        n_absorbed=sum(len(c.absorbed) for c in chains.values()),
        chains=chains,
        n_pool_fused=sum(1 for c in chains.values() if c.pool is not None))
    return fused, report


# ---------------------------------------------------------------------------
# Phase 2: concat-aware output placement (DenseNet)
# ---------------------------------------------------------------------------

def _concat_plan(graph: Graph, succ: Dict[str, List[str]],
                 outputs: Set[str], node: Node):
    """Partition a channel-concat's operands into fused writers (conv_blocks
    solely consumed by this concat) and pass-through operands, with channel
    offsets.  Returns None when nothing can fuse."""
    if node.op != "concat" or node.shape is None or len(node.shape) != 4:
        return None
    offsets: List[int] = []
    off = 0
    for i in node.inputs:
        offsets.append(off)
        off += graph.nodes[i].shape[1]
    writers: List[Tuple[str, int]] = []       # (conv name, channel offset)
    passthrough: List[Tuple[str, int]] = []
    seen: Set[str] = set()
    for i, o in zip(node.inputs, offsets):
        producer = graph.nodes[i]
        # plain conv2d producers qualify too — DenseNet's pre-activation
        # layers put bn/relu *before* the conv, so the tensor feeding the
        # concat is a bare conv; it becomes a conv_block whose only
        # epilogue stage is the channel-offset store
        fusible = (producer.op in ("conv2d", "conv_block")
                   and producer.attrs.get("groups", 1) == 1
                   and i not in seen                  # concat(x, x) keeps x
                   and i not in outputs
                   and len(succ[i]) == 1
                   and "concat_into" not in producer.attrs)
        seen.add(i)
        if fusible:
            writers.append((i, o))
        else:
            passthrough.append((i, o))
    if not writers:
        return None
    if not passthrough:
        # the alloc seed derives batch/spatial/dtype from an operand, so
        # keep one operand materialized (its copy is the buffer init)
        passthrough.append(writers.pop(0))
        if not writers:
            return None
    return writers, passthrough, node.shape[1]


def fuse_concat_writes(graph: Graph) -> Tuple[Graph, int]:
    """Rewrite each fusible ``concat`` into a ``concat_alloc`` seed (the
    pass-through operands placed at their offsets) plus a chain of writer
    conv_blocks, each storing its channels at its offset into the shared
    buffer — the §3.1 copy-elimination for DenseNet fan-ins.  The writer
    blocks are re-emitted at the concat's topo position, threaded on the
    buffer, and the last writer's tensor *is* the concat result."""
    succ = graph.successors()
    outputs = set(graph.outputs)
    plans: Dict[str, tuple] = {}
    deferred: Set[str] = set()          # writer convs re-emitted at the cat
    for node in graph.topo_order():
        plan = _concat_plan(graph, succ, outputs, node)
        if plan is not None:
            plans[node.name] = plan
            deferred.update(name for name, _ in plan[0])
    if not plans:
        return graph, 0

    out = Graph()
    mapped: Dict[str, str] = {}
    for node in graph.topo_order():
        if node.name in deferred:
            continue                    # emitted with its concat below
        if node.name in plans:
            writers, passthrough, total = plans[node.name]
            buf = f"{node.name}__alloc"
            out.add(buf, "concat_alloc",
                    [mapped[i] for i, _ in passthrough],
                    offsets=tuple(o for _, o in passthrough),
                    total_channels=total)
            out.nodes[buf].shape = node.shape
            for conv_name, off in writers:
                conv = graph.nodes[conv_name]
                attrs = dict(conv.attrs)
                attrs.update(concat_into=True, concat_offset=off,
                             concat_total=total)
                out.add(conv_name, "conv_block",
                        [mapped[i] for i in conv.inputs] + [buf],
                        **attrs)
                out.nodes[conv_name].shape = node.shape
                mapped[conv_name] = conv_name
                buf = conv_name         # next writer threads on this buffer
            mapped[node.name] = buf     # the last writer IS the concat
        else:
            out.add(node.name, node.op,
                    [mapped[i] for i in node.inputs], **dict(node.attrs))
            out.nodes[node.name].shape = node.shape
            mapped[node.name] = node.name
    for o in graph.outputs:
        out.mark_output(mapped[o])
    return out, len(plans)
