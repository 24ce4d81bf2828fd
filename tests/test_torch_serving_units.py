"""Port parity: the serving stack's pure-Python parts, against the
reference exactly, on the same seeded numpy streams.

``P2Quantile`` and ``StreamingQuantiles`` (every marker and every
quantile equal, float for float), ``synth_trace`` for each of
``TRACE_KINDS`` (the same ``TraceRequest`` list), ``priority_rank``,
``choose_shed_victim`` for each of ``SHED_POLICIES``,
``RetryPolicy.backoff_s``, ``HeartbeatMonitor``, ``StragglerMitigator``
and ``FaultInjector``'s matching and budgets, each driven through one
scripted sequence in both packages.  Then the invariants of the
reference's ``tests/test_telemetry.py`` (quantiles),
``tests/test_traffic.py`` (priorities, traces),
``tests/test_supervision.py``, ``tests/test_request_rank.py`` and
``tests/test_serving_props.py`` (the batch policy's packing, with
hypothesis) on the port alone, the pinning helpers of ``launch/cpu.py``,
and the kernels' launch counters bumped from 8 threads.  Nothing here
compiles a session.
"""
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.engine import faults as r_faults
from repro.engine import supervision as r_sup
from repro.engine import telemetry as r_tel
from repro.engine import traffic as r_traffic
from repro_torch.engine import (DEFAULT_PRIORITY, PRIORITY_CLASSES,
                                SHED_POLICIES, TRACE_KINDS, DelayBatch,
                                DynamicBatchPolicy, FailBatch, FaultInjector,
                                HeartbeatMonitor, InjectedPredictError,
                                InjectedWorkerCrash, KillWorker, P2Quantile,
                                RetryPolicy, StragglerMitigator,
                                StragglerPolicy, StreamingQuantiles,
                                choose_shed_victim, nearest_bucket,
                                priority_rank, synth_trace)
from repro_torch.engine import faults as t_faults
from repro_torch.engine import supervision as t_sup
from repro_torch.engine import telemetry as t_tel
from repro_torch.engine import traffic as t_traffic
from repro_torch.engine.serving import Request
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.conv2d_nchwc import conv2d_nchwc
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul_blocked import matmul_blocked
from repro_torch.kernels.ssd_chunk import ssd_intra
from repro_torch.launch.cpu import maybe_pin, worker_cpu_sets


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# (a) against the reference, exactly
# ---------------------------------------------------------------------------

STREAMS = {"normal": lambda r: r.normal(10.0, 2.0, 3000),
           "exponential": lambda r: r.exponential(1.0, 3000),
           "ties": lambda r: r.integers(0, 7, 3000).astype(float)}


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_p2_quantile_equals_reference(stream, q):
    xs = STREAMS[stream](np.random.default_rng(5))
    ref, port = r_tel.P2Quantile(q), t_tel.P2Quantile(q)
    for i, x in enumerate(xs):
        ref.add(float(x))
        port.add(float(x))
        if i in (0, 3, 4, 5, 100, len(xs) - 1):
            assert port.value() == ref.value() or (
                np.isnan(port.value()) and np.isnan(ref.value()))
            assert port.count == ref.count
    assert port._h == ref._h and port._n == ref._n and port._np == ref._np


@pytest.mark.parametrize("exact_n", [16, 128])
def test_streaming_quantiles_equal_reference(exact_n):
    xs = np.random.default_rng(6).lognormal(0.0, 1.0, 600)
    ref = r_tel.StreamingQuantiles(exact_n=exact_n)
    port = t_tel.StreamingQuantiles(exact_n=exact_n)
    for i, x in enumerate(xs):
        ref.add(float(x))
        port.add(float(x))
        if i % 97 == 0:
            assert port.to_json() == ref.to_json()
    for q in np.linspace(0.0, 1.0, 41):
        assert port.quantile(float(q)) == ref.quantile(float(q))
    assert port.to_json() == ref.to_json()
    assert port.state_size() == ref.state_size()
    assert port.copy().to_json() == ref.copy().to_json()


@pytest.mark.parametrize("kind", TRACE_KINDS)
@pytest.mark.parametrize("seed", [0, 3])
def test_synth_trace_equals_reference(kind, seed):
    kw = dict(n=150, seed=seed, mean_rate=200.0, max_rows=8,
              tenants=("a", "b"), priorities=PRIORITY_CLASSES,
              deadline_ms=40.0)
    ref = r_traffic.synth_trace(kind, **kw)
    port = t_traffic.synth_trace(kind, **kw)
    assert [vars(r) for r in port] == [vars(r) for r in ref]


def test_priority_classes_equal_reference():
    assert t_traffic.PRIORITY_CLASSES == r_traffic.PRIORITY_CLASSES
    assert t_traffic.DEFAULT_PRIORITY == r_traffic.DEFAULT_PRIORITY
    assert t_traffic.TRACE_KINDS == r_traffic.TRACE_KINDS
    for p in PRIORITY_CLASSES:
        assert t_traffic.priority_rank(p) == r_traffic.priority_rank(p)


class _Req:
    def __init__(self, deadline=None):
        self.deadline = deadline


@pytest.mark.parametrize("policy", SHED_POLICIES)
def test_choose_shed_victim_equals_reference(policy):
    assert t_sup.SHED_POLICIES == r_sup.SHED_POLICIES
    rng = np.random.default_rng(9)
    for _ in range(200):
        n = int(rng.integers(0, 8))
        q = [_Req(None if rng.random() < 0.4
                  else float(rng.integers(0, 5))) for _ in range(n)]
        assert t_sup.choose_shed_victim(q, policy) == \
            r_sup.choose_shed_victim(q, policy)


@pytest.mark.parametrize("kw", [dict(), dict(budget=5, backoff_ms=3.0,
                                             backoff_factor=1.7,
                                             max_backoff_ms=40.0),
                                dict(budget=0, backoff_ms=0.0)])
def test_retry_backoff_equals_reference(kw):
    ref, port = r_sup.RetryPolicy(**kw), t_sup.RetryPolicy(**kw)
    assert [port.backoff_s(a) for a in range(1, 12)] == \
        [ref.backoff_s(a) for a in range(1, 12)]


def test_heartbeat_monitor_equals_reference():
    """One scripted sequence of beats, checks and revives on both."""
    rng = np.random.default_rng(2)
    rc, tc = Clock(), Clock()
    ref = r_sup.HeartbeatMonitor(range(4), timeout_s=0.5, clock=rc)
    port = t_sup.HeartbeatMonitor(range(4), timeout_s=0.5, clock=tc)
    for _ in range(300):
        dt = float(rng.exponential(0.2))
        rc.t += dt
        tc.t += dt
        op, h = int(rng.integers(0, 3)), int(rng.integers(0, 4))
        if op == 0:
            ref.beat(h)
            port.beat(h)
        elif op == 1:
            assert port.check() == ref.check()
        else:
            ref.revive(h)
            port.revive(h)
        assert port.alive == ref.alive
        assert port.last_seen == ref.last_seen


def test_straggler_mitigator_equals_reference():
    rng = np.random.default_rng(4)
    pol = dict(slow_factor=1.5, evict_after=2, window=3)
    ref = r_sup.StragglerMitigator(range(4), r_sup.StragglerPolicy(**pol))
    port = t_sup.StragglerMitigator(range(4), t_sup.StragglerPolicy(**pol))
    for step in range(60):
        times = {h: float(rng.exponential(1.0)) * (3.0 if h == 3 else 1.0)
                 for h in list(ref.history)}
        ref.record(times)
        port.record(times)
        assert port.stragglers() == ref.stragglers()
        assert port.evictions() == ref.evictions()
        assert port.strikes == ref.strikes
        if step == 40 and ref.evictions():
            h = ref.evictions()[0]
            ref.drop(h)
            port.drop(h)
    assert port.history == ref.history


def _fire(inj, mod, worker, seq):
    slept = []
    try:
        inj.fire(worker, seq, sleep=slept.append)
        return "ok", slept
    except mod.InjectedWorkerCrash:
        return "crash", slept
    except mod.InjectedPredictError:
        return "fail", slept


def test_fault_injector_equals_reference():
    def arm(mod):
        return mod.FaultInjector(
            mod.FailBatch(on_batch=2), mod.KillWorker(worker=1, times=2),
            mod.DelayBatch(times=None, delay_ms=7.0),
            mod.FailBatch(worker=0, times=3))
    ref, port = arm(r_faults), arm(t_faults)
    for worker, seq in [(0, 0), (1, 1), (0, 2), (1, 2), (1, 3), (0, 4),
                        (1, 5), (0, 6), (0, 7), (1, 8)]:
        assert _fire(port, t_faults, worker, seq) == \
            _fire(ref, r_faults, worker, seq)
    assert port.fired == ref.fired
    assert port.fired_kinds() == ref.fired_kinds()


# ---------------------------------------------------------------------------
# (c) the reference's invariants on the port: telemetry and traffic
# ---------------------------------------------------------------------------

def test_p2_tracks_known_quantiles():
    rng = np.random.default_rng(0)
    for dist, tol in [(rng.normal(10.0, 2.0, 4000), 0.05),
                      (rng.uniform(0.0, 1.0, 4000), 0.05),
                      (rng.exponential(1.0, 4000), 0.12)]:
        for q in (0.5, 0.9, 0.99):
            est = P2Quantile(q)
            for x in dist:
                est.add(float(x))
            ref = float(np.quantile(dist, q))
            assert abs(est.value() - ref) / max(abs(ref), 1e-9) < tol


def test_streaming_quantiles_exact_for_small_samples():
    sq = StreamingQuantiles(exact_n=64)
    xs = [float(i) for i in range(50)]
    for x in xs:
        sq.add(x)
    assert sq.exact
    assert sq.quantile(0.0) == 0.0 and sq.quantile(1.0) == 49.0
    assert sq.percentile(50) == pytest.approx(np.percentile(xs, 50))
    assert sq.percentile(99) == pytest.approx(np.percentile(xs, 99))
    assert sq.mean == pytest.approx(np.mean(xs)) and sq.count == 50


def test_streaming_quantiles_estimator_phase_and_bounded_state():
    rng = np.random.default_rng(7)
    xs = rng.normal(5.0, 1.0, 5000)
    sq = StreamingQuantiles()
    for x in xs:
        sq.add(float(x))
    assert not sq.exact
    for q in (50, 90, 99):
        ref = float(np.percentile(xs, q))
        assert abs(sq.percentile(q) - ref) / abs(ref) < 0.05
    assert sq.percentile(0) == pytest.approx(sq.min)
    assert sq.percentile(100) == pytest.approx(sq.max)
    assert sq.percentile(70) >= sq.percentile(50)
    mid = sq.state_size()
    for i in range(20_000):
        sq.add(float(i % 23))
    assert sq.state_size() == mid


def test_streaming_quantiles_copy_json_and_validation():
    sq = StreamingQuantiles()
    for x in (1.0, 2.0, 3.0):
        sq.add(x)
    snap = sq.copy()
    sq.add(100.0)
    assert snap.count == 3 and sq.count == 4
    assert snap.max == 3.0 and sq.max == 100.0
    js = sq.to_json()
    assert js["count"] == 4
    assert set(js) >= {"count", "mean", "min", "max", "p50", "p90", "p99"}
    empty = StreamingQuantiles()
    assert np.isnan(empty.quantile(0.5))
    assert empty.to_json()["mean"] is None
    with pytest.raises(ValueError, match="q must be"):
        StreamingQuantiles().quantile(1.5)
    with pytest.raises(ValueError, match="q must be"):
        P2Quantile(0.0)
    with pytest.raises(ValueError, match="quantile"):
        StreamingQuantiles(qs=())


def test_priority_classes():
    assert priority_rank("interactive") == 0
    assert priority_rank(DEFAULT_PRIORITY) == 1
    assert priority_rank("batch") == 2
    assert [priority_rank(p) for p in PRIORITY_CLASSES] == [0, 1, 2]
    with pytest.raises(ValueError, match="priority"):
        priority_rank("platinum")


def test_traces_deterministic_shaped_and_tagged():
    for kind in TRACE_KINDS:
        a = synth_trace(kind, n=200, seed=3)
        assert a == synth_trace(kind, n=200, seed=3)
        ts = [r.t for r in a]
        assert len(a) == 200 and ts == sorted(ts)
        assert all(1 <= r.rows <= 8 for r in a)
    assert synth_trace("bursty", n=200, seed=4) != a
    tr = synth_trace("heavytail", n=2000, seed=0)
    ones = sum(1 for r in tr if r.rows == 1)
    big = sum(1 for r in tr if r.rows >= 6)
    assert ones > len(tr) * 0.4 and 0 < big < ones / 2
    tr = synth_trace("uniform", n=12, seed=0, tenants=("a", "b"),
                     priorities=PRIORITY_CLASSES, deadline_ms=50.0)
    assert {r.tenant for r in tr} == {"a", "b"}
    for r in tr:
        assert r.deadline_ms == (50.0 if r.priority == "interactive"
                                 else None)
    with pytest.raises(ValueError, match="kind"):
        synth_trace("square-wave", n=5)


# ---------------------------------------------------------------------------
# (c) supervision
# ---------------------------------------------------------------------------

def test_heartbeat_silence_dead_once_revive_and_zombies():
    c = Clock()
    mon = HeartbeatMonitor([0, 1, 2], timeout_s=1.0, clock=c)
    c.t += 0.5
    mon.beat(1)
    c.t += 0.6
    assert mon.check() == [0, 2]
    assert mon.check() == []
    assert mon.alive == [1]
    mon = HeartbeatMonitor([0], timeout_s=1.0, clock=c)
    c.t += 2.0
    assert mon.check() == [0]
    mon.beat(0)                      # a zombie's beat must not resurrect
    assert mon.alive == []
    mon.revive(0)
    assert mon.alive == [0]
    c.t += 0.5
    assert mon.check() == []         # revive reset the silence window
    c.t += 0.6
    assert mon.check() == [0]
    idle = HeartbeatMonitor([0], timeout_s=0.1, clock=c)
    for _ in range(5):
        c.t += 0.2
        for h in idle.check():
            idle.revive(h)
    assert idle.alive == [0]


def test_straggler_strikes_eviction_and_recovery():
    mit = StragglerMitigator([0, 1, 2], StragglerPolicy(1.5, 2, 3))
    for _ in range(3):
        mit.record({0: 1.0, 1: 1.0, 2: 5.0})
    assert mit.stragglers() == [2] and mit.evictions() == []
    mit.record({0: 1.0, 1: 1.0, 2: 5.0})
    assert mit.stragglers() == [2] and mit.evictions() == [2]
    mit.drop(2)
    assert 2 not in mit.history and mit.stragglers() == []
    mit = StragglerMitigator([0, 1, 2], StragglerPolicy(1.5, 2, 2))
    mit.record({0: 1.0, 1: 1.0, 2: 5.0})
    assert mit.stragglers() == [2]
    mit.record({0: 1.0, 1: 1.0, 2: 1.0})
    mit.record({0: 1.0, 1: 1.0, 2: 1.0})
    assert mit.stragglers() == [] and mit.evictions() == []


def test_retry_backoff_exponential_capped_and_validated():
    rp = RetryPolicy(budget=5, backoff_ms=10.0, backoff_factor=2.0,
                     max_backoff_ms=50.0)
    assert [rp.backoff_s(a) for a in (1, 2, 3, 4, 9)] == pytest.approx(
        [0.010, 0.020, 0.040, 0.050, 0.050])
    with pytest.raises(ValueError, match="1-based"):
        rp.backoff_s(0)
    with pytest.raises(ValueError, match="budget"):
        RetryPolicy(budget=-1)
    with pytest.raises(ValueError, match="backoff"):
        RetryPolicy(backoff_factor=0.5)
    RetryPolicy(budget=0)


@pytest.mark.parametrize("queue,policy,want", [
    ([None, None], "newest", None),
    ([None, None], "oldest", 0),
    ([5.0, None, 2.0, 9.0], "deadline", 2),
    ([None, None], "deadline", None),
    ([2.0, 2.0, 7.0], "deadline", 0),           # ties: the oldest
    ([7.0, 2.0, 2.0], "deadline", 1),
    ([None, None, 3.0], "deadline", 2),         # deadline-free: immune
    ([None] * 16, "deadline", None),
    ([], "oldest", None),
])
def test_shed_victim_rules(queue, policy, want):
    assert choose_shed_victim([_Req(d) for d in queue], policy) == want


def test_shed_unknown_policy():
    with pytest.raises(ValueError, match="shed"):
        choose_shed_victim([_Req()], "lifo")
    assert set(SHED_POLICIES) == {"newest", "oldest", "deadline"}


def test_injector_matching_budgets_and_delay_first():
    inj = FaultInjector(FailBatch(on_batch=2),
                        KillWorker(worker=1, times=2),
                        DelayBatch(times=None))
    inj.fire(0, 0, sleep=lambda s: None)
    assert inj.fired_kinds() == ["DelayBatch"]
    with pytest.raises(InjectedPredictError):
        inj.fire(0, 2, sleep=lambda s: None)
    inj.fire(0, 2, sleep=lambda s: None)        # budget spent: no raise
    for seq in (5, 6):
        with pytest.raises(InjectedWorkerCrash):
            inj.fire(1, seq, sleep=lambda s: None)
    inj.fire(1, 7, sleep=lambda s: None)
    assert inj.fired_kinds().count("KillWorker") == 2
    slept = []
    inj = FaultInjector(DelayBatch(delay_ms=30.0), FailBatch())
    with pytest.raises(InjectedPredictError):
        inj.fire(0, 0, sleep=slept.append)
    assert slept == [pytest.approx(0.030)]


# ---------------------------------------------------------------------------
# (c) the request record and the batch policy
# ---------------------------------------------------------------------------

def _req(**kw):
    base = dict(x=torch.zeros((1, 4)), rows=1, future=Future(),
                t_submit=0.0, rank=priority_rank("standard"))
    base.update(kw)
    return Request(**base)


def test_request_rank_required_and_typed():
    with pytest.raises(TypeError):
        Request(x=torch.zeros((1, 4)), rows=1, future=Future(),
                t_submit=0.0)
    for bad in ("high", 1.5, None, True):
        with pytest.raises(TypeError, match="rank"):
            _req(rank=bad)
    urgent = _req(t_submit=1.0, deadline=10.0, priority="interactive",
                  rank=priority_rank("interactive"))
    normal = _req(t_submit=0.0, deadline=10.0)
    assert DynamicBatchPolicy(order="edf").select([normal, urgent], 1,
                                                  2.0) == [1]


def test_policy_validation_and_ready_semantics():
    for kw in (dict(max_batch=0), dict(max_wait_ms=-1.0),
               dict(fixed_bucket=0), dict(order="lifo")):
        with pytest.raises(ValueError):
            DynamicBatchPolicy(**kw)

    class Row:
        def __init__(self, rows, t):
            self.rows, self.t_submit, self.deadline = rows, t, None

    policy = DynamicBatchPolicy(max_batch=4, max_wait_ms=10.0)
    pend = [Row(2, 100.0)]
    assert not policy.ready(pend, 100.009)
    assert policy.ready(pend, 100.010)
    pend.append(Row(2, 100.001))
    assert policy.ready(pend, 100.002)
    assert policy.take(pend, 4) == 2 and policy.take(pend, 3) == 1


def _simulate(policy, sizes, buckets):
    """Drain a queue the way the server does: flush when ready, else jump
    the clock to the policy's next event."""
    class Row:
        def __init__(self, rows, tag):
            self.rows, self.t_submit, self.deadline, self.tag = \
                rows, 0.0, None, tag

    pending = [Row(s, i) for i, s in enumerate(sizes)]
    now, batches, execs = 0.0, [], []
    while pending:
        if not policy.ready(pending, now):
            nxt = policy.next_event(pending, now)
            assert nxt is not None
            now += max(nxt, 1e-9)
            continue
        n = policy.take(pending, policy.max_batch)
        assert n >= 1
        batch, pending = pending[:n], pending[n:]
        rows = sum(r.rows for r in batch)
        batches.append([r.tag for r in batch])
        execs.append((rows, policy.fixed_bucket
                      or nearest_bucket(rows, buckets)))
    return batches, execs


@settings(max_examples=150, deadline=None)
@given(sizes=st.lists(st.integers(1, 8), min_size=1, max_size=40),
       max_batch=st.integers(1, 16),
       buckets=st.lists(st.integers(1, 16), min_size=1, max_size=4,
                        unique=True).map(sorted))
def test_packing_invariants(sizes, max_batch, buckets):
    max_batch = max(max_batch, max(buckets))
    sizes = [min(s, max_batch) for s in sizes]
    batches, execs = _simulate(
        DynamicBatchPolicy(max_batch=max_batch, max_wait_ms=5.0), sizes,
        buckets)
    assert all(rows <= max_batch for rows, _ in execs)
    assert [t for b in batches for t in b] == list(range(len(sizes)))
    for rows, bucket in execs:
        assert bucket == nearest_bucket(rows, buckets)


@settings(max_examples=80, deadline=None)
@given(sizes=st.lists(st.integers(1, 4), min_size=1, max_size=30),
       fixed=st.integers(4, 12))
def test_fixed_bucket_policy_waste_bound(sizes, fixed):
    batches, execs = _simulate(
        DynamicBatchPolicy(max_batch=fixed, max_wait_ms=5.0,
                           fixed_bucket=fixed), sizes, [fixed])
    assert [t for b in batches for t in b] == list(range(len(sizes)))
    for b_idx, batch in enumerate(batches):
        rows, bucket = execs[b_idx]
        assert bucket == fixed and 0 <= fixed - rows < fixed
        if b_idx < len(batches) - 1:
            assert rows + sizes[batch[-1] + 1] > fixed or rows == fixed


# ---------------------------------------------------------------------------
# launch/cpu.py and the launch counters
# ---------------------------------------------------------------------------

def test_worker_cpu_sets_partition_round_robin():
    assert worker_cpu_sets(2, cpus=[0, 1, 2, 3, 4]) == [(0, 2, 4), (1, 3)]
    assert worker_cpu_sets(3, cpus=[5, 6]) == [(5,), (6,), (5,)]
    sets = worker_cpu_sets(2)
    assert len(sets) == 2 and all(sets)
    with pytest.raises(ValueError, match="n_workers"):
        worker_cpu_sets(0)


def test_maybe_pin_pins_only_the_calling_thread():
    before = sorted(__import__("os").sched_getaffinity(0))
    got = []
    t = threading.Thread(target=lambda: got.append(maybe_pin(before[:1])))
    t.start()
    t.join()
    assert got == [tuple(before[:1])]
    assert sorted(__import__("os").sched_getaffinity(0)) == before


@pytest.mark.parametrize("fn,route", [(conv2d_nchwc, "sm90"),
                                      (matmul_blocked, "splitk"),
                                      (flash_attention, "fma"),
                                      (ssd_intra, None)])
def test_launch_counter_bumps_are_atomic(fn, route):
    """8 threads bump one counter 20,000 times each: the total is exact
    (the serving workers launch from several threads at once)."""
    launches = fn.launches
    by_route = dict(getattr(fn, "launches_by_route", {}))
    n, per = 8, 20_000
    barrier = threading.Barrier(n)

    def bump():
        barrier.wait()
        for _ in range(per):
            kbuild.count_launch(fn, route)

    threads = [threading.Thread(target=bump) for _ in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert fn.launches - launches == n * per
        if route is not None:
            assert fn.launches_by_route[route] - by_route[route] == n * per
    finally:
        fn.launches = launches
        if route is not None:
            fn.launches_by_route.update(by_route)
