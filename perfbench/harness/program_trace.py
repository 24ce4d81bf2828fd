"""The second traced take of a ``--trace 1`` run: the program's own spans
(``repro_torch.trace``) on the device trace's clock.

After the first traced span (``profiling.TracedSpan``, unchanged), a run of
a cell whose program records spans takes a second span of the same loop
with the program's tracer on, into a recorder of the take's own.  The
profiler again records the device alone.  The program's clock is tied to
the trace's by the last ``CALS`` of the span's lead launches but one, each
read between two readings of that clock (``trace.bracketed_leads``,
``trace.tie``: about a microsecond wide on the H100's host).  Then each
device operation (kernel, copy, memset) goes to the innermost program span
of the same thread that was open when its runtime call began, by
correlation id (``trace.assign``); and the device's idle gaps are cut by
the ``predict`` spans and the node spans of each predict.

The take is not whole, and is taken again as the first is (``retaken``),
where the first take's checks fail, where a device operation launched
inside a ``predict`` span is attributed to no node, where a B1 kernel is
attributed to anything but a conv node, or where the program dropped a
span.

No file of the harness opens this take yet: ``cell._drive`` would open it
after the first take (a ``ProgramSpan`` in place of ``loops``' own
``TracedSpan``) and keep ``summary`` under ``traced["program"]``, where
the readers ``conv_roofline``, ``ops_device_ms`` and ``walk_idle_ms`` and
the notes line would find it.  What is read today is set-up:
``setup_program_s`` reads the process's own recorder, whose cold spans the
program keeps whatever the switch says.  A program without
``repro_torch.trace`` (an older commit) records nothing, and the readers
read nothing.
"""
from __future__ import annotations

import bisect
import statistics
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from perfbench.harness.profiling import (B1_KERNEL, HostSpans, TracedSpan,
                                         TraceNotWhole, read_trace,
                                         union_ns)

CONV_OPS = ("conv_block", "conv2d")
TOP_NODES = 10


def available() -> bool:
    """Whether the program under test records spans."""
    try:
        from repro_torch import trace
    except ImportError:
        return False
    return all(hasattr(trace, f) for f in ("Recorder", "tracing", "assign",
                                           "tie", "bracketed_leads"))


class ProgramSpan(TracedSpan):
    """A traced span with the program's tracer on: opens like
    ``TracedSpan`` (the same leads; the last ``trace.CALS`` before the one
    that ties the host spans' clock are bracketed by readings of the
    program's clock), records into a fresh ``trace.Recorder``, and
    ``close`` returns the first take's reading with the program's under
    ``"program"``."""

    def __init__(self, b1_counter, spans: HostSpans, lead: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        from repro_torch import trace

        self._trace = trace
        self._rec = trace.Recorder()
        self._b1 = b1_counter
        self.spans = spans
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        for _ in range(lead - trace.CALS - 1):
            torch.cuda._sleep(0)
        self.cals = trace.bracketed_leads(trace.CALS)
        self.cal = time.time_ns()
        torch.cuda._sleep(0)
        self.t0 = time.time_ns()
        self.b1_start = self._b1()
        trace.tracing(self._rec)
        spans.on = True

    def close(self) -> Dict:
        self.t1 = time.time_ns()
        b1_counted = self._b1() - self.b1_start
        self.spans.on = False
        self._trace.tracing(None)
        torch.cuda.synchronize()
        self.prof.stop()
        got = read_trace(self.prof, self.cal, self.t0, self.t1, b1_counted,
                         self.spans.spans)
        rec, trace = self._rec, self._trace
        events = trace.read_events(self.prof)
        leads = trace.lead_launches(events)
        lo, hi = window(leads, self.cal, self.t0, self.t1)
        got["program"] = attribute(
            events, rec.spans(), program_shift(leads, self.cals), lo, hi,
            trace.aliases(rec.threads), dropped=rec.dropped)
        got["program"]["counters"] = {
            "nodes_walked": rec.counters["nodes_walked"],
            "spans_dropped": rec.dropped}
        return got


def window(leads, cal: int, t0: int, t1: int) -> Tuple[int, int]:
    """The span's bounds on the trace's clock, by the first take's tie
    of ``time.time_ns`` to it (the last of the lead launches ``leads``)."""
    if not leads:
        raise TraceNotWhole("the trace holds no launch of its lead kernels")
    shift = leads[-1].start - cal
    return t0 + shift, t1 + shift


def program_shift(leads, cals: Sequence[Tuple[int, int]]
                  ) -> Tuple[int, int]:
    """(offset, width) from the program's clock to the trace's, from the
    lead launches ``leads`` before the last and their readings ``cals``
    (``trace.tie``)."""
    from repro_torch import trace

    try:
        return trace.tie(leads[:-1], cals)
    except ValueError as e:
        raise TraceNotWhole(str(e)) from None


def attribute(events, rows, tie: Tuple[int, int],
              lo: int, hi: int, ids: Dict[int, int],
              dropped: int = 0) -> Dict:
    """The program's take: each device operation in [lo, hi] attributed
    to a span of ``rows`` (on the program's clock; ``tie`` the offset to
    the trace's and its width; ``ids`` the threads' ``aliases``); per
    node the card's seconds; the idle time inside each predict, by node.
    Raises ``TraceNotWhole`` where the program ``dropped`` spans in the
    take, a launch inside a predict has no node, or a B1 kernel has no
    conv node."""
    from repro_torch import trace

    if dropped:
        raise TraceNotWhole(f"the program dropped {dropped} spans")
    offset, width = tie
    owned, by_index = trace.assign(events, rows, offset, ids)
    node_s: Dict[str, float] = {}
    node_op: Dict[str, str] = {}
    pad_s = outside_s = 0.0
    clipped = []
    orphans = b1_astray = b1_kernels = 0
    for e, row in owned:
        a, b = max(e.start, lo), min(e.end, hi)
        if b <= a:
            continue
        clipped.append((a, b))
        sec = (b - a) / 1e9
        node = row
        if row is not None and row.kind == "pad":
            node = by_index.get(row.parent)
            pad_s += sec
        is_b1 = B1_KERNEL in e.name
        b1_kernels += is_b1
        if node is None or node.kind in ("predict", "pad"):
            orphans += node is not None
            b1_astray += is_b1
            outside_s += sec
            continue
        if is_b1 and (node.kind not in CONV_OPS or row is not node):
            b1_astray += 1
        node_s[node.name] = node_s.get(node.name, 0.0) + sec
        node_op[node.name] = node.kind
    if orphans or b1_astray:
        raise TraceNotWhole(
            f"the program's take is not whole: {orphans} device operations "
            f"launched in a predict outside every node, {b1_astray} of "
            f"{b1_kernels} B1 kernels outside a conv node")
    predicts = [r for r in rows if r.kind == "predict" and r.end]
    if not predicts:
        raise TraceNotWhole("the program's take holds no predict span")
    batches: Dict[int, int] = {}
    for r in predicts:
        batches[r.arg] = batches.get(r.arg, 0) + 1
    idle_s, idle_by_node = _walk_idle(rows, predicts, clipped, offset, lo,
                                      hi)
    conv_s = sum(s for n, s in node_s.items() if node_op[n] in CONV_OPS)
    n = len(predicts)
    top = sorted(node_s.items(), key=lambda kv: -kv[1])[:TOP_NODES]
    return {
        "predicts": len(predicts),
        "batches": batches,
        "conv_s": conv_s,
        "pad_s": pad_s,
        "ops_s": sum(node_s.values()) - conv_s,
        "outside_s": outside_s,
        "walk_idle_s": idle_s,
        "top_nodes_ms": [[name, node_op[name], s * 1e3 / n]
                         for name, s in top],
        "walk_idle_ms_by_node": {k: v * 1e3 / n for k, v in sorted(
            idle_by_node.items(), key=lambda kv: -kv[1])[:TOP_NODES]},
        "spans": len(rows),
        "clock_tie_ns": width,
    }


def _walk_idle(rows, predicts, intervals, offset: int, lo: int, hi: int
               ) -> Tuple[float, Dict[str, float]]:
    """Seconds the card was idle while a ``predict`` span was open, in all
    and by the node span of that predict open then (a node ends where the
    next begins: ``between nodes`` is the predict's own steps before its
    first node and after its last)."""
    _busy, gaps = union_ns(intervals)
    if intervals:
        gaps = ([(lo, min(a for a, _ in intervals))] + gaps
                + [(max(b for _, b in intervals), hi)])
    else:
        gaps = [(lo, hi)]
    gaps = [(a, b) for a, b in gaps if b > a]
    starts = [a for a, _ in gaps]
    children: Dict[int, list] = {}          # a predict's nodes
    for r in rows:
        if r.kind not in ("predict", "pad") and r.predict >= 0:
            children.setdefault(r.predict, []).append(
                (r.start + offset, r.end + offset, r.name))
    total = 0
    by_node: Dict[str, float] = {}
    for p in predicts:
        a, b = p.start + offset, p.end + offset
        k = max(0, bisect.bisect_right(starts, a) - 1)
        kids = sorted(children.get(p.index, []))    # siblings: disjoint
        kid_starts = [c[0] for c in kids]
        while k < len(gaps) and gaps[k][0] < b:
            x, y = max(gaps[k][0], a), min(gaps[k][1], b)
            k += 1
            if y <= x:
                continue
            total += y - x
            inside = 0
            j = bisect.bisect_left(kid_starts, y) - 1
            while j >= 0 and kids[j][1] > x:
                cx, cy = max(x, kids[j][0]), min(y, kids[j][1])
                if cy > cx:
                    name = kids[j][2]
                    by_node[name] = by_node.get(name, 0.0) + (cy - cx) / 1e9
                    inside += cy - cx
                j -= 1
            if y - x > inside:
                by_node["between nodes"] = by_node.get(
                    "between nodes", 0.0) + (y - x - inside) / 1e9
    return total / 1e9, by_node


def setup_seconds() -> Optional[float]:
    """Seconds in the program's cold spans ``compile`` and
    ``kernel.load``, each counted once (a load inside a compile is part of
    it); None where the process recorded none."""
    if not available():
        return None
    from repro_torch import trace

    rows = trace.recorder().spans()
    by_index = {r.index: r for r in rows}
    kinds = ("compile", "kernel.load")
    total, found = 0, False
    for r in rows:
        if r.kind not in kinds or not r.end:
            continue
        up = by_index.get(r.parent)
        while up is not None and up.kind not in kinds:
            up = by_index.get(up.parent)
        if up is None:
            total += r.end - r.start
            found = True
    return total / 1e9 if found else None


def counters() -> Dict[str, int]:
    """The process's cold counters."""
    from repro_torch import trace

    c = trace.recorder().counters
    return {k: c[k] for k in ("plans_built", "kernels_built",
                              "kernels_loaded")}


def node_shapes(session, buckets: Sequence[int]) -> Dict[str, str]:
    """Each node of the largest bucket's plan: a conv as ``C x H x W >
    K x P x Q, kh x kw / stride``, another node as its output shape."""
    graph = session.plan_for(max(buckets)).planned.graph
    out = {}
    for n in graph.topo_order():
        shape = "x".join(str(d) for d in (n.shape or ())[1:])
        if n.op in CONV_OPS and n.inputs:
            src = graph.nodes[n.inputs[0]].shape or ()
            a = n.attrs
            shape = (f"{'x'.join(str(d) for d in src[1:])}>{shape} "
                     f"{a.get('kh')}x{a.get('kw')}/{a.get('stride', 1)}")
        out[n.name] = shape
    return out


def setup_split() -> Dict:
    """The cold spans' record of set-up (``trace.setup_split``): seconds
    by kind, each plan's passes, each kernel library's load and build."""
    from repro_torch import trace

    return trace.setup_split()


def summary(first, second, session, buckets: Sequence[int]) -> Dict:
    """What the readers and the notes line take from the second take
    (``second``, a ``loops.Window``), beside the first (``first``): the
    program's reading, the cold spans' seconds and their split, the
    counters, the top nodes with their shapes, and the cost of the tracer
    (take 2 minus take 1: host ms a predict from ``predict`` to its
    return, and the idle share in points)."""
    got = dict(second.trace["program"])
    shapes = node_shapes(session, buckets)
    got["top_nodes_ms"] = [[name, op, shapes.get(name, ""), ms]
                           for name, op, ms in got["top_nodes_ms"]]
    got["setup_program_s"] = setup_seconds()
    got["counters"] = {**counters(), **got.get("counters", {})}
    got["setup_split"] = setup_split()

    def idle(t):
        return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

    got["on_cost"] = {
        "host_ms_per_predict": statistics.fmean(second.enqueue_ms)
        - statistics.fmean(first.enqueue_ms),
        "idle_share_points": idle(second.trace) - idle(first.trace),
    }
    return got


# -- readers: three of the second take, one of set-up (perfbench/metrics/) --

def _program(run) -> Optional[Dict]:
    t = run.trace
    p = t.get("program") if t else None
    return p if p and p.get("predicts") else None


def conv_roofline(run) -> Optional[float]:
    """The ideal time of the network's convs (``costs.Costs``) for every
    predict of the second take, over the card's time in every operation
    attributed to conv nodes and their ``pad`` spans, whatever its
    kernel's name."""
    p = _program(run)
    if not p or p["conv_s"] <= 0:
        return None
    ideal = sum(n * run.costs.conv_ideal_s(int(bucket))
                for bucket, n in p["batches"].items())
    return 100.0 * ideal / p["conv_s"]


def ops_device_ms(run) -> Optional[float]:
    """The card's ms a predict in operations attributed to the nodes that
    are not convs (relayouts, pools, flatten, dense, relu, softmax)."""
    p = _program(run)
    return None if not p else p["ops_s"] * 1e3 / p["predicts"]


def walk_idle_ms(run) -> Optional[float]:
    """The card's idle ms a predict while its ``predict`` span was open:
    the host walking slower than the card runs."""
    p = _program(run)
    return None if not p else p["walk_idle_s"] * 1e3 / p["predicts"]


def setup_program_s(run) -> Optional[float]:
    """Seconds of set-up in the program's cold ``compile`` and
    ``kernel.load`` spans, from the process's recorder, in a run that
    completed images (the run's set-up is the process's)."""
    return setup_seconds() if run.window.images else None
