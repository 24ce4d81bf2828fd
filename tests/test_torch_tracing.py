"""The program's spans and counters (``repro_torch/trace.py``): hot spans
under the switch, one clock reading a node, cold spans always and their
record of set-up, the cap, a window's own recorder, threads."""
from __future__ import annotations

import ctypes
import ctypes.util
import math
import threading

import pytest
import torch

from repro_torch.core.graph import Graph
from repro_torch import trace
from repro_torch.engine import compile
from repro_torch.kernels import build

CONV_OPS = ("conv_block", "conv2d")


def _net(batch=2):
    """Two convs, one padded (3x3) and one not (1x1), a BN, a ReLU and a
    classifier."""
    g = Graph()
    g.add("in", "input")
    g.add("c1", "conv2d", ["in"], in_channels=3, out_channels=16, kh=3,
          kw=3, stride=1, pad=1)
    g.add("bn1", "batch_norm", ["c1"])
    g.add("r1", "relu", ["bn1"])
    g.add("c2", "conv2d", ["r1"], in_channels=16, out_channels=16, kh=1,
          kw=1, stride=1, pad=0)
    g.add("gap", "global_avg_pool", ["c2"])
    g.add("fl", "flatten", ["gap"])
    g.add("fc", "dense", ["fl"], units=10)
    g.mark_output("fc")
    return g, {"in": (batch, 3, 8, 8)}


@pytest.fixture
def rec():
    with trace.use(trace.Recorder(cap=4096)) as r:
        trace.tracing(None)
        yield r
    trace.tracing(None)


@pytest.fixture(scope="module")
def session():
    g, shapes = _net()
    return compile(g, shapes, device="cpu")


def _x(batch=2):
    return torch.randn(batch, 3, 8, 8, generator=torch.Generator()
                       .manual_seed(0))


def _padded_convs(model) -> int:
    p = model.plan.planned
    return sum(1 for n in p.graph.topo_order() if n.op in CONV_OPS
               and (n.attrs.get("pad", 0) or n.attrs.get("pad_w", -1) > 0))


def test_switch_off_records_nothing_and_reads_no_clock(rec, session,
                                                       monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "now_ns",
                        lambda: calls.append(1) or 0)
    for name in ("open", "close", "count", "walk"):
        monkeypatch.setattr(rec, name, lambda *a, _n=name: calls.append(_n))
    off = session.predict(_x())
    assert calls == [] and rec.issued == 0
    assert rec.counters["nodes_walked"] == 0
    monkeypatch.undo()
    trace.tracing(rec)
    on = session.predict(_x())
    trace.tracing(None)
    assert rec.issued > 0
    assert torch.equal(off, on)                       # bit-identical


def test_one_predict_records_its_nodes_and_pads(rec, session):
    model = session.specialize(2)
    trace.tracing(rec)
    session.predict(_x())
    trace.tracing(None)
    spans = rec.spans()
    predicts = [s for s in spans if s.kind == "predict"]
    assert len(predicts) == 1
    p = predicts[0]
    assert p.parent == -1 and p.predict == p.index and p.arg == 2
    walked = [n for n in model.plan.planned.graph.topo_order()
              if n.op != "input"]
    nodes = [s for s in spans if s.kind not in ("predict", "pad")]
    assert [(s.name, s.kind) for s in nodes] == [(n.name, n.op)
                                                  for n in walked]
    assert all(s.parent == p.index and s.predict == p.index for s in nodes)
    pads = [s for s in spans if s.kind == "pad"]
    assert len(pads) == _padded_convs(model) >= 1
    by_index = {s.index: s for s in spans}
    for s in pads:
        assert by_index[s.parent].kind in CONV_OPS
        assert s.predict == p.index
        assert by_index[s.parent].start <= s.start <= s.end \
            <= by_index[s.parent].end
    assert all(p.start <= s.start <= s.end <= p.end for s in spans)
    assert rec.counters["nodes_walked"] == len(nodes)
    assert rec.dropped == 0


def test_a_walk_reads_the_clock_once_a_node(rec, session, monkeypatch):
    model = session.specialize(2)
    clock = iter(range(1, 10_000))
    monkeypatch.setattr(trace, "now_ns", lambda: next(clock))
    trace.tracing(rec)
    session.predict(_x())
    trace.tracing(None)
    spans = rec.spans()
    nodes = [s for s in spans if s.kind not in ("predict", "pad")]
    pads = [s for s in spans if s.kind == "pad"]
    # two readings for the predict and each pad, one a node and one more
    assert next(clock) - 1 == 2 + 2 * len(pads) + len(nodes) + 1
    assert all(a.end == b.start for a, b in zip(nodes, nodes[1:]))
    assert len(nodes) == len([n for n in model._topo if n.op != "input"])


def test_a_window_records_into_its_own_recorder(rec, session):
    window = trace.Recorder(cap=4096)
    session.specialize(2)
    trace.tracing(window)
    assert trace.active() is window and trace.recorder() is rec
    session.predict(_x())
    g, shapes = _net()
    compile(g, shapes, device="cpu")                 # cold: the process's
    trace.tracing(None)
    kinds = {s.kind for s in window.spans()}
    assert "predict" in kinds and "compile" not in kinds
    assert [s.kind for s in rec.spans()] == ["compile", "specialize",
                                             "plan", "bind"]
    assert window.counters["nodes_walked"] > 0 == rec.counters["nodes_walked"]


def test_a_walk_past_the_cap_is_dropped_whole(session):
    model = session.specialize(2)
    n = len([x for x in model._topo if x.op != "input"])
    r = trace.Recorder(cap=n)                        # the predict fits
    trace.tracing(r)
    try:
        session.predict(_x())
    finally:
        trace.tracing(None)
    kinds = [s.kind for s in r.spans()]
    assert kinds[0] == "predict"
    assert not set(kinds) - {"predict", "pad"}       # no node recorded
    assert r.dropped >= n and r.counters["nodes_walked"] == 0


def test_a_sharded_call_records_one_predict(rec):
    g, shapes = _net(batch=4)
    s = compile(g, shapes, devices=2, device="cpu")
    first = rec.issued
    trace.tracing(rec)
    s.predict(_x(4))
    trace.tracing(None)
    spans = rec.spans(first)
    predicts = [x for x in spans if x.kind == "predict"]
    assert len(predicts) == 1 and predicts[0].arg == 4
    walked = [n for n in s.specialize(4).plan.planned.graph.topo_order()
              if n.op != "input"]
    nodes = [x for x in spans if x.kind not in ("predict", "pad")]
    assert len(nodes) == 2 * len(walked)
    assert all(x.parent == predicts[0].index for x in nodes)


def test_cold_spans_are_recorded_with_tracing_off(rec):
    g, shapes = _net()
    s = compile(g, shapes, device="cpu")
    spans = rec.spans()
    kinds = [x.kind for x in spans]
    assert kinds == ["compile", "specialize", "plan", "bind"]
    comp, spec_, plan, bind = spans
    assert spec_.parent == comp.index and spec_.arg == 2
    assert plan.parent == bind.parent == spec_.index
    assert all(x.end >= x.start > 0 for x in spans)
    report = s.plan_for(2).report
    assert rec.notes[plan.index]["passes"] == [(r.name, r.seconds)
                                               for r in report.passes]
    assert rec.counters["plans_built"] == 1
    s.specialize(2)                                   # a hit: no span
    assert rec.issued == 4 and rec.counters["plans_built"] == 1
    s.specialize(4)
    assert [x.kind for x in rec.spans(4)] == ["specialize", "plan", "bind"]
    assert rec.counters["plans_built"] == 2
    split = trace.setup_split(rec)
    assert [p["bucket"] for p in split["plans"]] == [2, 4]
    assert split["plans"][0]["passes"] == [(r.name, r.seconds)
                                           for r in report.passes]
    rows = rec.spans()
    for kind in trace.COLD:
        want = sum(x.end - x.start for x in rows if x.kind == kind) / 1e9
        assert split["seconds"][kind] == pytest.approx(want)
    assert split["seconds"]["specialize"] >= split["seconds"]["plan"] > 0
    assert split["kernel_loads"] == []


# The plan's work between the convs at batch 32 under B1's machine model,
# as the fusion pass leaves it: densenet-121's 58 dense layers each seed a
# concat buffer (``concat_alloc``) that their 3x3 conv stores into at an
# offset, and each of its 62 pre-activations on a concatenation (58 layers'
# first BN-ReLU, 3 transitions', the head's) stays a standalone BN and ReLU.
BETWEEN_CONVS = {
    "densenet-121": {"relayouts": 67, "eltwise_nodes": 124,
                     "concat_seeds": 58, "concat_writes": 58},
    "resnet-50": {"relayouts": 4, "eltwise_nodes": 0, "concat_seeds": 0,
                  "concat_writes": 0},
}


@pytest.mark.parametrize("model", sorted(BETWEEN_CONVS))
def test_plan_note_counts_the_work_between_convs(rec, model):
    """Every ``specialize``'s ``plan`` span is noted with the executed
    graph's relayouts, standalone BN and ReLU, concat seeds and concat
    writes, and their bytes: each node's output read and written once in
    fp32."""
    s = compile(model, (32, 3, 224, 224), device="cpu", eager=False)
    s.specialize(32)
    s.specialize(1)
    plans = [x for x in rec.spans() if x.kind == "plan"]
    assert len(plans) == 2
    notes = [rec.notes[p.index] for p in plans]
    assert all("passes" in n and "relayout_bytes" in n for n in notes)
    note = notes[0]
    assert {k: note[k] for k in BETWEEN_CONVS[model]} == BETWEEN_CONVS[model]
    graph = s.plan_for(32).planned.graph
    for op, key in (("layout_transform", "relayout_bytes"),
                    ("concat_alloc", "concat_seed_bytes")):
        nodes = [n for n in graph.topo_order() if n.op == op]
        assert note[key] == sum(8 * math.prod(n.shape) for n in nodes)
    eltwise = [n for n in graph.topo_order()
               if n.op in ("batch_norm", "relu")]
    assert note["eltwise_bytes"] == sum(8 * math.prod(n.shape)
                                        for n in eltwise)


def test_kernel_load_is_a_cold_span(rec, monkeypatch):
    libc = ctypes.util.find_library("c") or "libc.so.6"
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build",
                        lambda name: {"path": libc, "seconds": 1.5,
                                      "ptxas": ""})
    fn = build.entry("probe", "abs", [ctypes.c_int])
    assert fn(-3) == 3
    build.entry("probe", "labs", [ctypes.c_long])     # loaded: no span
    (load,) = rec.spans()
    assert (load.kind, load.name, load.parent) == ("kernel.load", "probe",
                                                   -1)
    assert rec.notes[load.index] == {"built": True, "seconds": 1.5}
    assert rec.counters["kernels_loaded"] == 1
    assert rec.counters["kernels_built"] == 1
    monkeypatch.setattr(build, "build",
                        lambda name: {"path": libc, "seconds": 0.0,
                                      "ptxas": ""})
    build.entry("other", "abs", [ctypes.c_int])
    assert rec.notes[1] == {"built": False, "seconds": 0.0}
    assert rec.counters["kernels_loaded"] == 2
    assert rec.counters["kernels_built"] == 1
    loads = trace.setup_split(rec)["kernel_loads"]
    assert [(x["kernel"], x["built"], x["seconds"]) for x in loads] == [
        ("probe", True, 1.5), ("other", False, 0.0)]
    assert all(x["s"] >= 0 for x in loads)


def test_the_cap_counts_dropped_spans():
    r = trace.Recorder(cap=4)
    a = r.intern("a")
    kept = [r.open(a, a) for _ in range(6)]
    for i in reversed(kept):
        r.close(i)
    assert kept[4:] == [-1, -1]
    assert r.issued == 6 and r.dropped == 2 and len(r.spans()) == 4
    assert [s.parent for s in r.spans()] == [-1, 0, 1, 2]
    b = r.open(a, a)                                   # the nest unwound
    assert b == -1 and r.dropped == 3


def test_spans_of_two_threads_carry_their_own_ids(rec):
    a = rec.intern("a")
    ready = threading.Barrier(2)
    got = {}

    def work(tag):
        outer = rec.open(a, a)
        ready.wait(timeout=10)
        inner = rec.open(a, a)
        ready.wait(timeout=10)
        rec.close(inner)
        rec.close(outer)
        got[tag] = (threading.get_native_id(), outer, inner)
        assert rec.threads[threading.get_native_id()] == \
            threading.get_ident()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    by_index = {s.index: s for s in rec.spans()}
    for ident, outer, inner in got.values():
        assert by_index[outer].tid == by_index[inner].tid == ident
        assert by_index[inner].parent == outer
        assert by_index[outer].parent == -1
    assert got[0][0] != got[1][0]


def test_tracing_switch_and_use_restore():
    outer = trace.recorder()
    r, window = trace.Recorder(cap=8), trace.Recorder(cap=8)
    with trace.use(r):
        assert trace.recorder() is r and trace.active() is None
        trace.tracing(window)
        assert trace.active() is window and trace.recorder() is r
        trace.tracing(None)
    assert trace.recorder() is outer and trace.active() is None
