"""The yardstick's small parts: the traffic generator, the interval
arithmetic of the trace, the draws, the gap, the result line's JSON."""
from __future__ import annotations

import json
import math

import pytest
import torch

from perfbench.harness import compare
from perfbench.harness.output import finite, loaded_forbidden
from perfbench.harness.profiling import _Spans, union_ns
from perfbench.harness.weights import draw_params, generator
from perfbench.traffic.generator import arrivals, synth_trace

MIX = {"kind": "uniform", "max_rows": 1, "arrivals": "stratified"}


def test_stratified_arrivals_are_one_set_in_seeded_orders():
    a = arrivals(MIX, 1000.0, 2.0, 5)
    b = arrivals(MIX, 1000.0, 2.0, 2**31 + 5)
    assert len(a) == len(b) == 2000
    assert a == arrivals(MIX, 1000.0, 2.0, 5) and a != b
    gaps = lambda ts: sorted(round(y - x, 12) for (x, _), (y, _)
                             in zip(ts, ts[1:]))
    ga, gb = gaps(a), gaps(b)
    assert len(set(ga) ^ set(gb)) <= 4          # one set, but for the first
    assert a[0][0] == 0.0 and a[-1][0] < 2.0
    assert all(rows == 1 for _, rows in a)


def test_synth_trace_is_the_programs():
    from repro_torch.engine.traffic import synth_trace as program

    for kind in ("uniform", "bursty", "diurnal", "heavytail"):
        ours = synth_trace(kind, n=50, seed=3, mean_rate=200.0, max_rows=8)
        theirs = program(kind, n=50, seed=3, mean_rate=200.0, max_rows=8)
        assert ours == [(r.t, r.rows) for r in theirs]


def test_union_and_gaps():
    total, gaps = union_ns([(0, 10), (5, 12), (20, 30), (29, 31), (40, 41)])
    assert total == 12 + 11 + 1
    assert gaps == [(12, 20), (31, 40)]


def test_span_lookup_takes_the_latest_begun():
    s = _Spans([("predict", 0, 100), ("wait", 50, 80), ("d2h", 120, 130)])
    assert [s.at(t) for t in (10, 60, 90, 110, 125, 200)] == [
        "predict", "wait", "predict", "none", "d2h", "none"]


def test_draws_repeat_from_the_seed():
    specs = [("c", "w", (8, 4, 3, 3), "he"), ("c_bn", "scale", (8,),
                                                "bn_scale"),
             ("c_bn", "shift", (8,), "bn_shift"), ("fc", "b", (5,), "zero")]
    dist = {"bias_std": 0.01, "bn_shift_std": 0.1, "bn_scale": [0.5, 1.5]}
    cpu = torch.device("cpu")
    p = draw_params(specs, dist, generator(2**31 + 9, cpu), cpu)
    q = draw_params(specs, dist, generator(2**31 + 9, cpu), cpu)
    assert all(torch.equal(p[n][k], q[n][k]) for n, k, _, _ in specs)
    assert 0.5 <= float(p["c_bn"]["scale"].min()) <= 1.5
    assert float(p["c"]["w"].std()) == pytest.approx(math.sqrt(2 / 36),
                                                     rel=0.3)
    assert not p["fc"]["b"].any()


def test_logprob_gap():
    ref = torch.softmax(torch.randn(3, 10), -1)
    assert compare.logprob_gap([(0, ref.clone())], [ref]) == 0.0
    bumped = ref.clone()
    bumped[1, 4] *= math.exp(0.01)
    assert compare.logprob_gap([(0, ref), (0, bumped)], [ref]) == \
        pytest.approx(0.01, rel=1e-3)
    nan = ref.clone()
    nan[0, 0] = float("nan")
    assert compare.logprob_gap([(0, nan)], [ref]) == math.inf
    assert compare.logprob_gap([], [ref]) == math.inf


def test_result_line_is_json():
    line = json.dumps(finite({"a": [math.inf, 1.5], "b": math.nan}))
    assert json.loads(line) == {"a": [None, 1.5], "b": None}


def test_forbidden_modules_by_whole_top_level_name():
    assert loaded_forbidden({"repro_torch.engine": 1, "jaxtyping": 1,
                             "numpy": 1}) == []
    assert loaded_forbidden({"repro.engine": 1, "jax": 1, "flax.nn": 1,
                             "repro_torch": 1}) == ["flax.nn", "jax",
                                                    "repro.engine"]


LEAD = [("cuda_runtime", "cudaLaunchKernel", 90, 91, 1, False),
        ("kernel", "spin_kernel", 95, 96, 1, True)]


def _span(events, b1_counted, monkeypatch):
    from perfbench.harness import profiling

    monkeypatch.setattr(profiling, "_events", lambda prof: LEAD + events)
    return profiling.read_trace(None, cal=90, t0=100, t1=200,
                                b1_counted=b1_counted,
                                spans=[("predict", 100, 150),
                                       ("wait", 150, 200)])


def test_trace_reading(monkeypatch):
    events = [
        ("cuda_runtime", "cudaLaunchKernelExC", 110, 112, 2, False),
        ("kernel", "conv_sm90_kernel<4>", 115, 135, 2, True),
        ("cuda_runtime", "cudaLaunchKernel", 120, 121, 3, False),
        ("kernel", "relu", 130, 140, 3, True),
        ("gpu_memcpy", "Memcpy HtoD", 160, 170, 4, True),
    ]
    t = _span(events, 1, monkeypatch)
    assert t["window_s"] == 100e-9 and t["busy_s"] == 35e-9
    assert t["b1_kernels"] == 1 and t["launches_checked"] == 2
    assert t["device_s_by_name"]["conv_sm90_kernel<4>"] == 20e-9
    assert t["idle_by_span_s"] == {"predict": 15e-9, "wait": 50e-9}
    assert t["idle_gaps"][0] == ["wait", 30e-9]


@pytest.mark.parametrize("lost", ["kernel", "b1"])
def test_trace_that_lost_a_launch_fails(lost, monkeypatch):
    events = [("cuda_runtime", "cudaLaunchKernelExC", 110, 112, 2, False),
              ("kernel", "conv_sm90_kernel<4>", 115, 135, 2, True),
              ("cuda_runtime", "cudaLaunchKernel", 120, 121, 3, False)]
    if lost == "kernel":
        counted = 1                    # the launch of correlation 3 lost
    else:
        events.append(("kernel", "relu", 130, 140, 3, True))
        counted = 2                    # B1 counted two, the trace holds one
    with pytest.raises(RuntimeError, match="not whole"):
        _span(events, counted, monkeypatch)
