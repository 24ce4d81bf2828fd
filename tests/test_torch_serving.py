"""Port parity: ``AsyncServer`` on the CPU, against the reference's server
and against the invariants of its suite.

(b) One scripted fake-clock run — mixed sizes and priority classes, EDF
packing, deadlines, a cancelled request, a full queue under the
``"deadline"`` shed policy, a failed batch retried with backoff, a killed
worker, a drain — goes through the reference's ``AsyncServer`` on its
``_mini_net`` session (``tests/test_serving.py``) and through the port's
on the same graph with the reference session's weights
(``params_from_numpy``).  ``ServingStats.to_json()`` must be equal, every
request must end the same way, and every response must agree with the
reference's within rtol = atol = 1e-5 (fp32 sums in another order), as
must ``padded_predict``.

(c) The invariants of the reference's ``tests/test_serving.py`` on the
port's CPU session: packed results bit-identical to ``padded_predict`` at
the bucket (from 3 client threads, at 1 and 2 workers), packing by
``max_batch``/``max_wait_ms`` on a fake clock, FIFO and EDF order, typed
errors, drain, cancellation, frozen sessions' caps, the session lock's
compile-once, consistent snapshots under threads, bounded telemetry, and
the port's own surface: numpy, CPU-tensor and (through ``as_tensor``)
array inputs, and ``CompiledModel.replica``.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import Graph as RGraph
from repro.engine import AsyncServer as RServer
from repro.engine import DynamicBatchPolicy as RPolicy
from repro.engine import FailBatch as RFail
from repro.engine import FaultInjector as RInjector
from repro.engine import KillWorker as RKill
from repro.engine import RetryPolicy as RRetry
from repro.engine import compile as r_compile
from repro.engine import padded_predict as r_padded_predict
from repro_torch.core.graph import Graph
from repro_torch.engine import (AsyncServer, BatchPolicy,
                                DeadlineExceededError, DynamicBatchPolicy,
                                FailBatch, FaultInjector, InferenceSession,
                                KillWorker, QueueFullError,
                                RequestTooLargeError, RetryPolicy,
                                ServerClosedError, ServingError, compile,
                                nearest_bucket, padded_predict,
                                params_from_numpy)
from repro_torch.engine.telemetry import SizeHistogram

PARITY_TOL = dict(rtol=1e-5, atol=1e-5)


def _mini_net(G=Graph):
    g = G()
    g.add("in", "input")
    g.add("c1", "conv2d", ["in"], in_channels=3, out_channels=16, kh=3,
          kw=3, stride=2, pad=1)
    g.add("bn1", "batch_norm", ["c1"])
    g.add("r1", "relu", ["bn1"])
    g.add("c2", "conv2d", ["r1"], in_channels=16, out_channels=32, kh=3,
          kw=3, pad=1)
    g.add("gap", "global_avg_pool", ["c2"])
    g.add("fl", "flatten", ["gap"])
    g.add("fc", "dense", ["fl"], units=10)
    g.mark_output("fc")
    return g, {"in": (1, 3, 16, 16)}


@pytest.fixture(scope="module")
def pair():
    """The reference's session and the port's on its weights, buckets
    {1, 4} each, compiled once for the module."""
    rg, shapes = _mini_net(RGraph)
    ref = r_compile(rg, shapes)
    ref.specialize(4)
    g, _ = _mini_net()
    port = compile(g, shapes, device="cpu",
                   params=params_from_numpy(ref._params, device="cpu"))
    port.specialize(4)
    return ref, port


@pytest.fixture(scope="module")
def session(pair):
    return pair[1]


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


def _x(rng, rows, hw=16):
    return rng.normal(size=(rows, 3, hw, hw)).astype(np.float32)


def _manual_server(session, **kw):
    clock = FakeClock()
    policy = kw.pop("policy", DynamicBatchPolicy(max_batch=4,
                                                 max_wait_ms=10.0))
    srv = AsyncServer(session, policy, clock=clock, autostart=False, **kw)
    return srv, clock


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


# ---------------------------------------------------------------------------
# (b) one scripted fake-clock run through both servers
# ---------------------------------------------------------------------------

def _scripted(server_cls, policy_cls, inj, retry, session):
    clock = FakeClock()
    srv = server_cls(
        session, policy_cls(max_batch=4, max_wait_ms=10.0, order="edf"),
        clock=clock, autostart=False, sleep=lambda s: None, max_queue=6,
        shed="deadline", retry=retry(budget=2, backoff_ms=5.0),
        faults=inj)
    rng = np.random.default_rng(3)
    prios = ("batch", "interactive", "standard")
    futs, rejected = [], []
    sizes = [1, 2, 1, 3, 1, 1, 2, 4, 1, 2, 3, 1, 1, 2, 1, 1]
    for i, rows in enumerate(sizes):
        dl = 25.0 if i % 5 == 1 else None
        try:
            futs.append(srv.submit(_x(rng, rows), deadline_ms=dl,
                                   priority=prios[i % 3]))
        except Exception as e:        # noqa: BLE001 — recorded, compared
            rejected.append(type(e).__name__)
        if i == 3:
            futs[-1].cancel()
        clock.advance_ms(3.0 if i % 4 else 11.0)
        if i % 3 == 2:
            srv.step()
    for _ in range(40):
        clock.advance_ms(7.0)
        srv.step()
    srv.close(drain=True)
    outcomes = []
    for f in futs:
        if f.cancelled():
            outcomes.append(("cancelled", None))
        elif f.exception() is not None:
            outcomes.append((type(f.exception()).__name__, None))
        else:
            outcomes.append(("ok", _np(f.result())))
    return srv.stats.to_json(), outcomes, rejected


def test_scripted_run_same_stats_as_reference(pair):
    ref_sess, port_sess = pair
    r_stats, r_out, r_rej = _scripted(
        RServer, RPolicy, RInjector(RFail(on_batch=1), RKill(on_batch=3)),
        RRetry, ref_sess)
    t_stats, t_out, t_rej = _scripted(
        AsyncServer, DynamicBatchPolicy,
        FaultInjector(FailBatch(on_batch=1), KillWorker(on_batch=3)),
        RetryPolicy, port_sess)
    assert t_stats == r_stats
    assert t_rej == r_rej
    assert [k for k, _ in t_out] == [k for k, _ in r_out]
    # the script reaches every path it is meant to
    assert r_stats["n_retried"] >= 2 and r_stats["n_worker_crashes"] == 1
    assert r_stats["n_shed"] + r_stats["n_rejected_full"] >= 1
    assert r_stats["n_cancelled"] == 1
    assert {k for k, _ in r_out} >= {"ok", "cancelled"}
    for (_, got), (_, want) in zip(t_out, r_out):
        if want is not None:
            np.testing.assert_allclose(got, want, **PARITY_TOL)


@pytest.mark.parametrize("rows,bucket", [(1, None), (2, 4), (3, None),
                                         (4, 4)])
def test_padded_predict_agrees_with_reference(pair, rows, bucket):
    ref_sess, port_sess = pair
    x = _x(np.random.default_rng(rows), rows)
    want = np.asarray(r_padded_predict(ref_sess, jnp.asarray(x),
                                       bucket=bucket))
    got = padded_predict(port_sess, x, bucket=bucket).numpy()
    np.testing.assert_allclose(got, want, **PARITY_TOL)


# ---------------------------------------------------------------------------
# (c) packed results == sequential serving, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2])
def test_concurrent_submits_bit_identical_to_sequential(session, rng,
                                                        workers):
    xs = [_x(rng, 1) for _ in range(12)]
    refs = [padded_predict(session, x, bucket=4).numpy() for x in xs]
    policy = DynamicBatchPolicy(max_batch=4, max_wait_ms=5.0,
                                fixed_bucket=4)
    with AsyncServer(session, policy, max_queue=64,
                     workers=workers) as srv:
        futs = [None] * len(xs)

        def client(lo, hi):
            for i in range(lo, hi):
                futs[i] = srv.submit(xs[i])

        threads = [threading.Thread(target=client, args=(i * 4, i * 4 + 4))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        got = [f.result(timeout=60).numpy() for f in futs]
    for g, r in zip(got, refs):
        assert g.shape == r.shape and g.tobytes() == r.tobytes()
    st = srv.stats
    assert st.n_completed == 12 and st.rows_executed == 12
    assert st.batch_hist.max_size <= 4
    assert sum(st.worker_batches.values()) == st.n_batches


@pytest.mark.parametrize("form", ["numpy", "tensor", "list"])
def test_inputs_of_any_form_serve_the_same(session, rng, form):
    x = _x(rng, 2)
    want = padded_predict(session, x, bucket=4).numpy()
    arg = {"numpy": x, "tensor": torch.from_numpy(x),
           "list": x.tolist()}[form]
    srv, clock = _manual_server(
        session, policy=DynamicBatchPolicy(max_batch=4, max_wait_ms=1.0,
                                           fixed_bucket=4))
    fut = srv.submit(arg)
    clock.advance_ms(2.0)
    assert srv.step()
    got = fut.result(0)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.numpy().tobytes() == want.tobytes()
    assert padded_predict(session, arg, bucket=4).numpy().tobytes() \
        == want.tobytes()
    srv.close()


def test_padded_batch_slices_back_per_request(session, rng):
    xa, xb = _x(rng, 3), _x(rng, 1)
    srv, clock = _manual_server(session)
    fa, fb = srv.submit(xa), srv.submit(xb)
    assert srv.step()
    ya, yb = fa.result(0).numpy(), fb.result(0).numpy()
    assert ya.shape[0] == 3 and yb.shape[0] == 1
    packed = session.specialize(4).predict(
        torch.from_numpy(np.concatenate([xa, xb]))).numpy()
    assert ya.tobytes() == packed[:3].tobytes()
    assert yb.tobytes() == packed[3:4].tobytes()
    assert srv.stats.rows_padded == 0
    srv.close()


def test_padded_predict_matches_direct_at_bucket(session, rng):
    x = _x(rng, 2)
    y = padded_predict(session, x, bucket=4).numpy()
    direct = session.specialize(4).predict(torch.from_numpy(
        np.concatenate([x, np.zeros((2, 3, 16, 16), np.float32)])))[:2]
    assert y.tobytes() == direct.numpy().tobytes()
    with pytest.raises(ValueError, match="bucket"):
        padded_predict(session, _x(rng, 3), bucket=2)
    assert [nearest_bucket(n, [1, 4, 8]) for n in (3, 4, 5, 9)] == \
        [4, 4, 8, None]


def test_replica_is_self_on_its_own_device(session):
    m = session.specialize(1)
    assert m.device == torch.device("cpu")
    assert m.replica("cpu") is m
    assert m.replica(torch.device("cpu")) is m


def test_replica_on_another_device_copies_params_once(session,
                                                      monkeypatch):
    """A replica for another device is a copy with every bound tensor
    moved there, made once per device; the original keeps its own."""
    m = session.specialize(1)
    moved = []
    real_to = torch.Tensor.to

    def fake_to(self, *a, **kw):
        moved.append(a[0] if a else kw.get("device"))
        return real_to(self, "cpu")

    monkeypatch.setattr(torch.Tensor, "to", fake_to)
    rep = m.replica("meta")
    n_leaves = sum(len(p) for p in m.params.values())
    assert rep is not m and len(moved) == n_leaves
    assert m.replica("meta") is rep and len(moved) == n_leaves
    assert rep.plan is m.plan and rep.use_kernel == m.use_kernel


# ---------------------------------------------------------------------------
# (c) packing honors max_batch / max_wait_ms / order (fake clock)
# ---------------------------------------------------------------------------

def test_packing_respects_max_batch_and_max_wait(session, rng):
    srv, clock = _manual_server(session)
    f1, f2 = srv.submit(_x(rng, 1)), srv.submit(_x(rng, 1))
    assert not srv.step()
    assert not f1.done() and not f2.done()
    clock.advance_ms(10.1)
    assert srv.step()
    assert f1.done() and f2.done()
    assert srv.stats.batch_hist.counts() == {2: 1}
    futs = [srv.submit(_x(rng, 1)) for _ in range(5)]
    assert srv.step()
    assert srv.stats.batch_hist.counts() == {2: 1, 4: 1}
    assert [f.done() for f in futs] == [True] * 4 + [False]
    assert not srv.step()
    clock.advance_ms(10.1)
    assert srv.step()
    assert futs[4].done()
    assert srv.stats.batch_hist.counts() == {1: 1, 2: 1, 4: 1}
    assert srv.stats.rows_padded == (4 - 2) + 0 + 0
    srv.close()


def test_fifo_order_within_batches(session, rng):
    srv, clock = _manual_server(session)
    xs = [_x(rng, 2) for _ in range(4)]
    futs = [srv.submit(x) for x in xs]
    assert srv.step() and srv.step()
    for f, x in zip(futs, xs):
        assert f.result(0).numpy().tobytes() == \
            padded_predict(session, x, bucket=4).numpy().tobytes()
    assert srv.stats.batch_hist.counts() == {4: 2}
    srv.close()


def test_edf_priority_packing_order(session, rng):
    policy = DynamicBatchPolicy(max_batch=4, max_wait_ms=10.0,
                                fixed_bucket=4, order="edf")
    srv, clock = _manual_server(session, policy=policy)
    xs = [_x(rng, 2) for _ in range(4)]
    f_batch = [srv.submit(xs[0], priority="batch"),
               srv.submit(xs[1], priority="batch")]
    f_urgent = srv.submit(xs[2], deadline_ms=15.0, priority="interactive")
    f_std = srv.submit(xs[3], priority="standard")
    assert srv.step()
    assert f_urgent.done() and f_std.done()
    assert not f_batch[0].done() and not f_batch[1].done()
    assert srv.step()
    for f, x in zip(f_batch + [f_urgent, f_std], xs):
        assert f.result(0).numpy().tobytes() == \
            padded_predict(session, x, bucket=4).numpy().tobytes()
    st = srv.stats
    assert st.latency_by_class["interactive"].count == 1
    assert st.latency_by_class["batch"].count == 2
    assert st.latency_by_class["standard"].count == 1
    srv.close()


def test_fifo_default_unchanged_by_priority_field(session, rng):
    srv, clock = _manual_server(session)
    f_batch = srv.submit(_x(rng, 2), priority="batch")
    f_inter = srv.submit(_x(rng, 2), priority="interactive")
    assert srv.step()
    assert f_batch.done() and f_inter.done()
    assert srv.stats.batch_hist.counts() == {4: 1}
    srv.close()


# ---------------------------------------------------------------------------
# (c) typed errors
# ---------------------------------------------------------------------------

def test_queue_full_raises_typed_error(session, rng):
    srv, clock = _manual_server(session, max_queue=2)
    srv.submit(_x(rng, 1))
    srv.submit(_x(rng, 1))
    with pytest.raises(QueueFullError):
        srv.submit(_x(rng, 1))
    assert srv.stats.n_rejected_full == 1
    srv.close()


def test_deadline_exceeded_typed_error(session, rng):
    srv, clock = _manual_server(session)
    doomed = srv.submit(_x(rng, 1), deadline_ms=5.0)
    healthy = srv.submit(_x(rng, 1))
    clock.advance_ms(6.0)
    assert not srv.step()
    with pytest.raises(DeadlineExceededError):
        doomed.result(0)
    clock.advance_ms(5.0)
    assert srv.step()
    assert healthy.result(0).shape[0] == 1
    assert srv.stats.n_deadline_expired == 1
    srv.close()


def test_oversize_malformed_and_unknown_priority_rejected(session, rng):
    srv, clock = _manual_server(session)
    with pytest.raises(RequestTooLargeError, match="rows"):
        srv.submit(_x(rng, 5))
    assert issubclass(RequestTooLargeError, (ServingError, ValueError))
    with pytest.raises(ValueError, match="rank"):
        srv.submit(np.zeros((3, 16, 16), np.float32))
    with pytest.raises(ValueError, match="priority"):
        srv.submit(_x(rng, 1), priority="platinum")
    st = srv.stats
    assert st.n_rejected_too_large == 1
    assert st.n_submitted == 0 and len(srv) == 0
    srv.close()


def test_deadline_honored_without_policy_wakeup_hint(session, rng):
    class Stubborn(BatchPolicy):
        max_batch = 4

        def ready(self, pending, now):
            return False

        def take(self, pending, cap):
            return 1

    srv = AsyncServer(session, Stubborn())
    fut = srv.submit(_x(rng, 1), deadline_ms=30.0)
    with pytest.raises(DeadlineExceededError):
        fut.result(timeout=30)
    srv.close(drain=False)


# ---------------------------------------------------------------------------
# (c) drain, close, cancellation
# ---------------------------------------------------------------------------

def test_graceful_drain_manual_and_threaded(session, rng):
    srv, clock = _manual_server(session)
    futs = [srv.submit(_x(rng, 1)) for _ in range(3)]
    srv.close(drain=True)
    assert [f.result(0).shape[0] for f in futs] == [1, 1, 1]
    with pytest.raises(ServerClosedError):
        srv.submit(_x(rng, 1))
    assert srv.closed
    srv = AsyncServer(session, DynamicBatchPolicy(max_batch=4,
                                                  max_wait_ms=1.0),
                      max_queue=32)
    futs = [srv.submit(_x(rng, 1)) for _ in range(6)]
    srv.close(drain=True, timeout=60)
    assert all(f.result(0).shape[0] == 1 for f in futs)
    with pytest.raises(ServerClosedError):
        srv.submit(_x(rng, 1))


def test_close_without_drain_fails_pending(session, rng):
    srv, clock = _manual_server(session)
    fut = srv.submit(_x(rng, 1))
    srv.close(drain=False)
    with pytest.raises(ServerClosedError):
        fut.result(0)


def test_cancelled_future_skipped_not_fatal(session, rng):
    srv, clock = _manual_server(session)
    doomed = srv.submit(_x(rng, 1))
    healthy = srv.submit(_x(rng, 1))
    assert doomed.cancel()
    clock.advance_ms(10.1)
    assert srv.step()
    assert healthy.result(0).shape[0] == 1
    assert srv.stats.n_completed == 1
    gone = srv.submit(_x(rng, 1), deadline_ms=1.0)
    assert gone.cancel()
    clock.advance_ms(2.0)
    assert not srv.step()
    assert srv.stats.n_deadline_expired == 0
    srv.close()


@pytest.fixture(scope="module")
def frozen(session, tmp_path_factory):
    art = tmp_path_factory.mktemp("frozen") / "art"
    session.save(art, include_source=False)
    sess = InferenceSession.load(art, device="cpu")
    assert sess.frozen and sess.batch_sizes == [1, 4]
    return sess


def test_frozen_cap_flushes_full_bucket_immediately(frozen, rng):
    srv, clock = _manual_server(
        frozen, policy=DynamicBatchPolicy(max_batch=8, max_wait_ms=1000.0))
    futs = [srv.submit(_x(rng, 1)) for _ in range(4)]
    assert srv.step()
    assert all(f.done() for f in futs)
    assert srv.stats.batch_hist.counts() == {4: 1}
    srv.close()


def test_oversize_reject_on_frozen_session(frozen, rng):
    srv, clock = _manual_server(
        frozen, policy=DynamicBatchPolicy(max_batch=16, max_wait_ms=10.0))
    ok = srv.submit(_x(rng, 4))
    with pytest.raises(RequestTooLargeError, match="rows"):
        srv.submit(_x(rng, 5))
    assert srv.step()
    assert ok.result(0).shape[0] == 4
    srv.close()
    with pytest.raises(ValueError, match="fixed_bucket"):
        AsyncServer(frozen, DynamicBatchPolicy(fixed_bucket=2),
                    autostart=False)


# ---------------------------------------------------------------------------
# (c) the session lock, snapshots, telemetry
# ---------------------------------------------------------------------------

def test_concurrent_specialize_compiles_once(monkeypatch):
    g, shapes = _mini_net()
    sess = compile(g, shapes, device="cpu")
    calls = []
    in_run = threading.Event()
    real_run = type(sess.pipeline).run

    def slow_run(self, *a, **kw):
        calls.append(threading.get_ident())
        in_run.set()
        threading.Event().wait(0.1)
        return real_run(self, *a, **kw)

    monkeypatch.setattr(type(sess.pipeline), "run", slow_run)
    results = []

    def worker():
        results.append(sess.specialize(2))

    t1 = threading.Thread(target=worker)
    t1.start()
    assert in_run.wait(10)
    t2 = threading.Thread(target=worker)
    t2.start()
    t1.join()
    t2.join()
    assert len(calls) == 1, "double-compiled the same batch size"
    assert results[0] is results[1]
    assert sess.batch_sizes == [1, 2]


def test_stats_snapshots_consistent_under_threads(session, rng):
    n_threads, per_thread = 4, 20
    xs = [_x(rng, 1) for _ in range(4)]
    srv = AsyncServer(session, DynamicBatchPolicy(max_batch=4,
                                                  max_wait_ms=2.0),
                      workers=2, max_queue=256)
    futures, errors = [], []
    flock = threading.Lock()
    done = threading.Event()

    def submitter(i):
        for j in range(per_thread):
            f = srv.submit(xs[(i + j) % len(xs)])
            with flock:
                futures.append(f)

    def sampler():
        while not done.is_set():
            h = srv.health()
            c = h["counters"]
            rhs = (c["n_completed"] + c["n_failed"] + c["n_shed"]
                   + c["n_cancelled"] + c["n_deadline_expired"]
                   + h["queue_depth"] + h["inflight_requests"])
            if c["n_submitted"] != rhs:
                errors.append(f"torn health: {c['n_submitted']} != {rhs}")
            s = srv.stats
            if s.latency.count != s.n_completed:
                errors.append("torn stats: latencies vs completed")
            if s.batch_hist.n != s.n_batches:
                errors.append("torn stats: batch_hist vs batches")
            if sum(s.worker_batches.values()) != s.batch_hist.n:
                errors.append("torn stats: worker_batches vs batches")

    threads = ([threading.Thread(target=submitter, args=(i,))
                for i in range(n_threads)]
               + [threading.Thread(target=sampler) for _ in range(2)])
    try:
        for t in threads:
            t.start()
        for t in threads[:n_threads]:
            t.join(timeout=60)
        for f in futures:
            f.result(timeout=60)
    finally:
        done.set()
        for t in threads[n_threads:]:
            t.join(timeout=10)
        srv.close()
    assert not errors, errors[:5]
    s = srv.stats
    assert s.n_submitted == s.n_completed == n_threads * per_thread
    assert s.n_failed == s.n_shed == s.n_cancelled == 0
    assert s.batch_hist.rows == s.arrival_hist.n == s.n_submitted
    h = srv.health()
    assert h["queue_depth"] == 0 and h["inflight_requests"] == 0


def test_arrival_histogram_and_queue_depth_recorded(session, rng):
    srv, clock = _manual_server(session)
    before = session.traffic.n
    for rows in (1, 1, 2, 3, 1):
        srv.submit(_x(rng, rows))
        clock.advance_ms(10.1)
        while srv.step():
            pass
    st = srv.stats
    assert st.arrival_hist.counts() == {1: 3, 2: 1, 3: 1}
    assert st.arrival_hist.rows == 8 and st.queue_depth_peak >= 1
    assert session.traffic.n == before + 5
    srv.close()


class _FakeSession:
    """Executes instantly: enough session surface for the server."""

    def __init__(self, buckets=(1, 2, 4)):
        self._buckets = sorted(buckets)
        self.traffic = SizeHistogram()

    @property
    def input_spec(self):
        return {"x": (1, 4)}

    @property
    def batch_sizes(self):
        return list(self._buckets)

    @property
    def frozen(self):
        return True

    def specialize(self, batch):
        class _M:
            @staticmethod
            def predict(x):
                return x * 2.0
        return _M


def test_stats_memory_bounded_under_sustained_load():
    srv, clock = _manual_server(_FakeSession())
    sizes = [1, 2, 1, 3, 1, 4, 2, 1]

    def pump(n):
        for i in range(n):
            srv.submit(np.zeros((sizes[i % len(sizes)], 4), np.float32))
            clock.advance_ms(10.1)
            while srv.step():
                pass

    def state(st):
        return (st.latency.state_size(), st.arrival_hist.state_size(),
                st.batch_hist.state_size(),
                st.latency_by_class["standard"].state_size())

    pump(500)
    mid = state(srv.stats)
    pump(1500)
    st = srv.stats
    assert st.n_completed == 2000 and state(st) == mid
    assert st.latency.count == 2000 and st.arrival_hist.n == 2000
    assert np.isfinite(st.percentile_ms(99))
    srv.close()
