"""The second traced take on synthetic traces: the program's clock tied to
the trace's, each device operation attributed to the innermost span of its
launch's thread, the idle gaps cut by predicts and nodes, the three ways
a take is not whole, its readers, and the reader of the program's set-up."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench.harness import program_trace as pt
from perfbench.harness import spec
from perfbench.harness.profiling import TraceNotWhole
from repro_torch import trace

OFF = 7_000_000_000_000          # the trace's clock minus the program's
TID_A, TID_B = 118, 131          # two threads' native ids
IDS = trace.aliases({TID_A: 0x7FCC5564C300, TID_B: 0x7FC8E31FF6C0})
B1 = "void (anonymous namespace)::conv_sm90_kernel<4, false>(Params)"


def _span(i, name, kind, start, end, parent, predict, tid=TID_A, arg=0):
    return trace.Span(i, name, kind, start, end, parent, predict, tid,
                          arg)


ROWS = [
    _span(0, "predict", "predict", 1000, 9000, -1, 0, arg=1),
    _span(1, "c1", "conv_block", 1100, 4000, 0, 0),
    _span(2, "pad", "pad", 1200, 1500, 1, 0),
    _span(3, "fc", "dense", 4100, 6000, 0, 0),
    _span(4, "prob", "softmax", 6100, 8800, 0, 0),
    _span(5, "predict", "predict", 2000, 7000, -1, 5, tid=TID_B, arg=1),
    _span(6, "c9", "conv2d", 2100, 6900, 5, 5, tid=TID_B),
]


def _launch(corr, t, name, a, b, tid=TID_A):
    """A runtime call at ``t`` (program clock) on thread ``tid`` and its
    device operation over [a, b] (trace clock, less ``OFF``).  The first
    thread's calls carry the low 32 bits of its ``get_ident()``, as in a
    trace of the device alone; the second's its native id."""
    thread = trace.thread32(0x7FCC5564C300) if tid == TID_A else tid
    return [trace.Event("cudaLaunchKernel", t + OFF, t + OFF + 50, corr, False,
                     thread),
            trace.Event(name, a + OFF, b + OFF, corr, True, 7)]


def _events(*extra):
    return (_launch(1, 1300, "elementwise_kernel (pad)", 1000, 1500)
            + _launch(2, 1600, B1, 1500, 3000)
            + _launch(3, 4200, "gemvx::kernel", 5000, 6000)
            + _launch(4, 6200, "softmax_warp_forward", 6000, 8000)
            + _launch(5, 400, "Memcpy HtoD (Pinned -> Device)", 500, 1000)
            + _launch(6, 2500, B1, 1200, 2800, tid=TID_B)
            + _launch(7, 2500, "vectorized_elementwise_kernel", 1000, 2000)
            + [e for group in extra for e in group])


def _read(events, rows=ROWS, **kw):
    return pt.attribute(events, rows, (OFF, 0), OFF, 10_000 + OFF, IDS,
                        **kw)


def test_each_operation_goes_to_the_innermost_span_of_its_thread():
    got = _read(_events())
    assert got["predicts"] == 2 and got["batches"] == {1: 2}
    ns = 1e-9
    assert got["conv_s"] == pytest.approx((500 + 1500 + 1000 + 1600) * ns)
    assert got["pad_s"] == pytest.approx(500 * ns)
    assert got["ops_s"] == pytest.approx((1000 + 2000) * ns)
    assert got["outside_s"] == pytest.approx(500 * ns)
    top = {name: (op, ms) for name, op, ms in got["top_nodes_ms"]}
    assert top["c1"] == ("conv_block", pytest.approx(3000e-6 / 2))
    assert top["c9"] == ("conv2d", pytest.approx(1600e-6 / 2))
    assert top["prob"][0] == "softmax"


def test_idle_gaps_are_cut_by_predicts_and_nodes():
    got = _read(_events())
    # busy [500, 3000] and [5000, 8000]: the gaps in the predicts are
    # [3000, 5000] in both, and [8000, 9000] in the first thread's
    assert got["walk_idle_s"] == pytest.approx(5000e-9)
    by_node = got["walk_idle_ms_by_node"]
    ms = 1e-6 / 2                                   # a ns a predict, in ms
    assert by_node["c9"] == pytest.approx(2000 * ms)
    assert by_node["c1"] == pytest.approx(1000 * ms)
    assert by_node["fc"] == pytest.approx(900 * ms)
    assert by_node["prob"] == pytest.approx(800 * ms)
    assert by_node["between nodes"] == pytest.approx(300 * ms)


def test_the_program_clock_ties_to_the_trace_from_both_sides():
    leads = []
    cals = []
    for k in range(trace.CALS + 1):
        a = 100_000 + 10_000 * k                    # program clock
        start = a + OFF + 300 + (k % 3) * 200       # the launch, later
        leads += [trace.Event("cudaLaunchKernel", start, start + 400,
                           900 + k, False, 1),
                  trace.Event("at::cuda::spin_kernel", start + 500,
                           start + 600, 900 + k, True, 7)]
        cals.append((a, start + 400 + 250 - OFF))   # read after the call
    leads = trace.lead_launches(leads)
    offset, width = pt.program_shift(leads, cals[:-1])
    # the launch began 300 ns after the first reading at best and ended
    # 250 ns before the second at best: the offset lies in [OFF - 250,
    # OFF + 300]
    assert (offset, width) == (OFF + 25, 550)
    with pytest.raises(TraceNotWhole):
        pt.program_shift(leads[:20], cals[:-1])      # leads lost
    swapped = [(b, a) for a, b in cals[:-1]]
    with pytest.raises(TraceNotWhole):
        pt.program_shift(leads, swapped)             # no offset fits


def test_a_launch_in_a_predict_outside_every_node_is_not_whole():
    with pytest.raises(TraceNotWhole, match="1 device operations"):
        _read(_events(_launch(8, 4050, "elementwise", 8000, 8100)))


@pytest.mark.parametrize("t, tid", [(4200, TID_A),   # a dense node
                                    (1300, TID_A),   # a pad span
                                    (9500, TID_A),   # outside every span
                                    (6950, TID_B)])  # a predict, no node
def test_a_b1_kernel_outside_a_conv_node_is_not_whole(t, tid):
    with pytest.raises(TraceNotWhole, match="B1 kernels outside"):
        _read(_events(_launch(8, t, B1, 8000, 8100, tid=tid)))


def test_a_dropped_span_is_not_whole():
    _read(_events(), dropped=0)
    with pytest.raises(TraceNotWhole, match="dropped 3 spans"):
        _read(_events(), dropped=3)


def test_a_take_with_no_predict_is_not_whole():
    with pytest.raises(TraceNotWhole, match="no predict"):
        _read(_launch(5, 400, "Memcpy", 500, 1000), rows=[])


def test_setup_seconds_count_each_cold_span_once():
    r = trace.Recorder(cap=16)
    ids = {k: r.intern(k) for k in ("compile", "kernel.load", "bind")}
    with trace.use(r):
        outer = r.open(ids["compile"], ids["compile"])
        bind = r.open(ids["bind"], ids["bind"])
        load = r.open(ids["kernel.load"], ids["kernel.load"])
        for i in (load, bind, outer):
            r.close(i)
        alone = r.open(ids["kernel.load"], ids["kernel.load"])
        r.close(alone)
        r.count("kernels_loaded", 2)
        rows = {s.index: s for s in r.spans()}
        want = sum(rows[i].end - rows[i].start for i in (outer, alone))
        assert pt.setup_seconds() == pytest.approx(want / 1e9)
        assert pt.counters() == {"plans_built": 0, "kernels_built": 0,
                                 "kernels_loaded": 2}
        split = pt.setup_split()
        loads = [rows[i].end - rows[i].start for i in (load, alone)]
        assert split["seconds"]["kernel.load"] == pytest.approx(
            sum(loads) / 1e9)
        assert [x["s"] for x in split["kernel_loads"]] == pytest.approx(
            [x / 1e9 for x in loads])


def _run(program, images=0):
    costs = SimpleNamespace(conv_ideal_s=lambda b: 1e-6 * b)
    return SimpleNamespace(trace={"program": program}, costs=costs,
                           window=SimpleNamespace(enqueue_ms=[],
                                                  images=images,
                                                  seconds=0.0,
                                                  serving=None))


def test_summary_and_the_readers_of_the_second_take(monkeypatch):
    got = _read(_events())
    first = SimpleNamespace(enqueue_ms=[1.0, 1.2],
                            trace={"busy_s": 1.8, "window_s": 2.0})
    second = SimpleNamespace(enqueue_ms=[1.3, 1.3],
                             trace={"busy_s": 1.7, "window_s": 2.0,
                                    "program": got})
    session = SimpleNamespace(plan_for=lambda b: SimpleNamespace(
        planned=SimpleNamespace(graph=SimpleNamespace(
            topo_order=lambda: [], nodes={}))))
    monkeypatch.setattr(pt, "setup_seconds", lambda: 1.25)
    monkeypatch.setattr(pt, "counters", lambda: {"plans_built": 1})
    split = {"seconds": {"compile": 1.0}, "plans": [], "kernel_loads": []}
    monkeypatch.setattr(pt, "setup_split", lambda: split)
    got["counters"] = {"nodes_walked": 7, "spans_dropped": 0}
    p = pt.summary(first, second, session, [1])
    assert p["counters"] == {"plans_built": 1, "nodes_walked": 7,
                             "spans_dropped": 0}
    assert p["setup_split"] is split
    assert p["on_cost"]["host_ms_per_predict"] == pytest.approx(0.2)
    assert p["on_cost"]["idle_share_points"] == pytest.approx(5.0)
    assert p["setup_program_s"] == 1.25
    assert all(len(row) == 4 for row in p["top_nodes_ms"])
    want = {pt.conv_roofline: 100.0 * 2e-6 / 4600e-9,
            pt.ops_device_ms: 3000e-6 / 2, pt.walk_idle_ms: 5000e-6 / 2}
    run = _run(p)
    for read, value in want.items():
        assert read(run) == pytest.approx(value), read.__name__
        assert read(_run(None)) is None


@pytest.mark.parametrize("cell", ["offline", "single"])
def test_setup_program_s_reads_the_process_cold_spans(cell):
    read = spec.metric_reader(f"setup.program_s.{cell}")
    r = trace.Recorder(cap=8)
    with trace.use(r):
        assert read(_run(None, images=32)) is None     # nothing compiled
        compile_ = r.intern("compile")
        i = r.open(compile_, compile_)
        r.close(i)
        s = r.spans()[0]
        assert read(_run(None, images=32)) == pytest.approx(
            (s.end - s.start) / 1e9)
        assert read(_run(None)) is None                 # no image done


def test_node_shapes_name_a_conv_by_its_geometry():
    from repro_torch.core.graph import Graph
    from repro_torch.engine import compile

    g = Graph()
    g.add("in", "input")
    g.add("c1", "conv2d", ["in"], in_channels=3, out_channels=8, kh=3, kw=3,
          stride=2, pad=1)
    g.add("fl", "flatten", ["c1"])
    g.mark_output("fl")
    s = compile(g, {"in": (1, 3, 8, 8)}, device="cpu")
    shapes = pt.node_shapes(s, [1])
    assert shapes["c1"] == "3x8x8>8x4x4 3x3/2"
    assert shapes["fl"] == "128"
