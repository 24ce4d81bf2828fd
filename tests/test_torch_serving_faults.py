"""The port's serving stack under injected faults, on the CPU: the
invariants of the reference's ``tests/test_faults.py``.

Failed and killed batches requeue with backoff and complete bit-identical
to ``padded_predict``; past the budget a future fails typed with its
cause; load shedding by ``"oldest"`` and ``"deadline"``; ``close()``
terminates under faults; real-thread supervision restarts crashed
workers, evicts a slot past ``max_restarts`` and degrades to the
survivors; the hung-batch watchdog requeues a stalled batch and leaves
idle workers alone; ``health()`` and ``to_json()`` carry the counters;
``corrupt_artifact`` makes the port's own artifacts refuse to load.
Manual-pump servers run on a fake clock with no sleeps; the supervision
tests need real threads and keep their timing generous and bounded.
"""
import shutil
import time

import numpy as np
import pytest
import torch

from repro_torch.core.graph import Graph
from repro_torch.engine import (AllWorkersUnhealthyError, ArtifactCorruptError,
                                AsyncServer,
                                DeadlineExceededError, DelayBatch,
                                DynamicBatchPolicy, FailBatch, FaultInjector,
                                InferenceSession, InjectedPredictError,
                                KillWorker, LoadShedError, QueueFullError,
                                RetriesExhaustedError, RetryPolicy, compile,
                                corrupt_artifact, corrupt_file,
                                padded_predict)


def _mini_net():
    g = Graph()
    g.add("in", "input")
    g.add("c1", "conv2d", ["in"], in_channels=3, out_channels=8, kh=3,
          kw=3, stride=2, pad=1)
    g.add("r1", "relu", ["c1"])
    g.add("gap", "global_avg_pool", ["r1"])
    g.add("fl", "flatten", ["gap"])
    g.add("fc", "dense", ["fl"], units=10)
    g.mark_output("fc")
    return g, {"in": (1, 3, 16, 16)}


@pytest.fixture(scope="module")
def session():
    g, shapes = _mini_net()
    sess = compile(g, shapes, device="cpu")
    sess.specialize(4)
    return sess


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


def _x(rng, rows=1):
    return rng.normal(size=(rows, 3, 16, 16)).astype(np.float32)


def _manual(session, **kw):
    clock = FakeClock()
    policy = kw.pop("policy", DynamicBatchPolicy(max_batch=4,
                                                 max_wait_ms=10.0))
    srv = AsyncServer(session, policy, clock=clock, autostart=False,
                      sleep=lambda s: None, **kw)
    return srv, clock


def _ref(session, x, bucket=1):
    return padded_predict(session, x, bucket=bucket).numpy()


def _same(fut, ref, timeout=0):
    return fut.result(timeout).numpy().tobytes() == ref.tobytes()


# ---------------------------------------------------------------------------
# Retries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault,crashes", [(FailBatch, 0), (KillWorker, 1)])
def test_failed_or_killed_batch_retries_bit_identical(session, rng, fault,
                                                      crashes):
    x = _x(rng)
    ref = _ref(session, x)
    srv, clock = _manual(session, faults=FaultInjector(fault(on_batch=0)),
                         retry=RetryPolicy(budget=2, backoff_ms=10.0))
    fut = srv.submit(x)
    clock.advance_ms(10.1)
    assert srv.step()                        # batch 0: the injected fault
    assert not fut.done()                    # requeued, not failed
    assert not srv.step()                    # the backoff gate holds it
    clock.advance_ms(10.1)
    assert srv.step()
    assert _same(fut, ref)
    st = srv.stats
    assert (st.n_retried, st.n_failed, st.n_worker_crashes) == (1, 0,
                                                                crashes)
    srv.close()


def test_retries_exhausted_typed_with_cause(session, rng):
    srv, clock = _manual(session,
                         faults=FaultInjector(FailBatch(times=None)),
                         retry=RetryPolicy(budget=2, backoff_ms=10.0))
    fut = srv.submit(_x(rng))
    for _ in range(3):
        clock.advance_ms(21.0)
        assert srv.step()
    with pytest.raises(RetriesExhaustedError) as ei:
        fut.result(0)
    assert isinstance(ei.value.__cause__, InjectedPredictError)
    st = srv.stats
    assert (st.n_retried, st.n_retries_exhausted, st.n_failed) == (2, 1, 1)
    srv.close()


def test_kernel_error_retried_then_typed_never_rerouted(session, rng,
                                                        monkeypatch):
    """A batch whose executable raises (as a kernel launch error would) is
    retried on the same executable and then fails typed; nothing runs it
    another way."""
    x = _x(rng)
    m = session.specialize(1)
    calls = []

    def broken(x):
        calls.append(x.device.type)
        raise RuntimeError("conv2d_nchwc launch failed (sm90): cudaError_t 719")

    monkeypatch.setattr(m, "predict", broken)
    srv, clock = _manual(session, retry=RetryPolicy(budget=2,
                                                    backoff_ms=1.0))
    fut = srv.submit(x)
    for _ in range(3):
        clock.advance_ms(11.0)
        assert srv.step()
    with pytest.raises(RetriesExhaustedError, match="launch failed"):
        fut.result(0)
    assert calls == ["cpu"] * 3
    srv.close()


def test_budget_zero_fails_with_original_exception(session, rng):
    srv, clock = _manual(session, faults=FaultInjector(FailBatch()),
                         retry=RetryPolicy(budget=0))
    fut = srv.submit(_x(rng))
    clock.advance_ms(10.1)
    assert srv.step()
    with pytest.raises(InjectedPredictError):
        fut.result(0)
    assert srv.stats.n_retried == 0
    srv.close()


def test_retry_backoff_does_not_starve_healthy_requests(session, rng):
    srv, clock = _manual(session,
                         faults=FaultInjector(FailBatch(on_batch=0)),
                         retry=RetryPolicy(budget=2, backoff_ms=50.0))
    f1 = srv.submit(_x(rng))
    clock.advance_ms(10.1)
    assert srv.step()
    f2 = srv.submit(_x(rng))
    clock.advance_ms(10.1)
    assert not srv.step()
    clock.advance_ms(40.1)
    assert srv.step()
    assert f1.done() and f2.done()
    srv.close()


# ---------------------------------------------------------------------------
# Load shedding + deadline-aware admission
# ---------------------------------------------------------------------------

def test_shed_oldest_evicts_head_admits_newcomer(session, rng):
    srv, clock = _manual(session, max_queue=2, shed="oldest")
    f0, f1 = srv.submit(_x(rng)), srv.submit(_x(rng))
    f2 = srv.submit(_x(rng))
    with pytest.raises(LoadShedError):
        f0.result(0)
    assert len(srv) == 2 and srv.stats.n_shed == 1
    clock.advance_ms(10.1)
    assert srv.step()
    assert f1.done() and f2.done()
    srv.close()


def test_shed_deadline_evicts_tightest_deadline(session, rng):
    srv, clock = _manual(session, max_queue=2, shed="deadline")
    f_loose = srv.submit(_x(rng), deadline_ms=500.0)
    f_tight = srv.submit(_x(rng), deadline_ms=20.0)
    f_new = srv.submit(_x(rng))
    with pytest.raises(LoadShedError):
        f_tight.result(0)
    clock.advance_ms(10.1)
    assert srv.step()
    assert f_loose.done() and f_new.done()
    srv2, _ = _manual(session, max_queue=1, shed="deadline")
    srv2.submit(_x(rng))
    with pytest.raises(QueueFullError):
        srv2.submit(_x(rng))
    srv.close()
    srv2.close()


def test_expired_deadline_rejected_at_admission(session, rng):
    srv, clock = _manual(session)
    for dl in (0.0, -5.0):
        with pytest.raises(DeadlineExceededError):
            srv.submit(_x(rng), deadline_ms=dl)
    assert srv.stats.n_deadline_expired == 2 and len(srv) == 0
    srv.close()


# ---------------------------------------------------------------------------
# close() robustness
# ---------------------------------------------------------------------------

def test_close_drain_terminates_when_batches_keep_failing(session, rng):
    srv, clock = _manual(session,
                         faults=FaultInjector(FailBatch(times=None)),
                         retry=RetryPolicy(budget=2, backoff_ms=10.0))
    futs = [srv.submit(_x(rng)) for _ in range(3)]
    srv.close(drain=True)
    for f in futs:
        with pytest.raises(RetriesExhaustedError):
            f.result(0)
    assert srv.closed


def test_close_drain_terminates_with_dead_worker_thread(session, rng):
    xs = [_x(rng) for _ in range(4)]
    refs = [_ref(session, x) for x in xs]
    srv = AsyncServer(session, DynamicBatchPolicy(max_batch=1,
                                                  max_wait_ms=0.0),
                      faults=FaultInjector(KillWorker(on_batch=0)),
                      retry=RetryPolicy(budget=2, backoff_ms=1.0),
                      max_restarts=0, workers=1)
    futs = [srv.submit(x) for x in xs]
    srv.close(drain=True, timeout=30)
    assert all(_same(f, r) for f, r in zip(futs, refs))
    assert srv.stats.n_completed == 4


def test_close_idempotent_and_reentrant(session, rng):
    srv, clock = _manual(session)
    fut = srv.submit(_x(rng))
    srv.close(drain=True)
    srv.close(drain=True)
    srv.close(drain=False)
    assert fut.done() and srv.closed


# ---------------------------------------------------------------------------
# Supervision with real threads
# ---------------------------------------------------------------------------

def _wait_until(pred, timeout=30.0, step=0.01):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return pred()


@pytest.mark.parametrize("workers", [1, 2])
def test_supervisor_restarts_crashed_worker(session, rng, workers):
    xs = [_x(rng) for _ in range(6)]
    refs = [_ref(session, x) for x in xs]
    srv = AsyncServer(session, DynamicBatchPolicy(max_batch=1,
                                                  max_wait_ms=0.0),
                      faults=FaultInjector(KillWorker(on_batch=1)),
                      retry=RetryPolicy(budget=2, backoff_ms=1.0),
                      workers=workers, max_restarts=2)
    futs = [srv.submit(x) for x in xs]
    assert all(_same(f, r, timeout=60) for f, r in zip(futs, refs))
    assert _wait_until(lambda: srv.stats.n_worker_restarts >= 1)
    h = srv.health()
    assert h["workers"]["alive"] == workers
    assert h["counters"]["n_worker_crashes"] >= 1
    srv.close()
    assert srv.stats.n_completed == 6


def test_repeated_crashes_mark_unhealthy_and_degrade(session, rng):
    srv = AsyncServer(session, DynamicBatchPolicy(max_batch=1,
                                                  max_wait_ms=0.0),
                      faults=FaultInjector(KillWorker(times=None)),
                      retry=RetryPolicy(budget=1, backoff_ms=1.0),
                      workers=1, max_restarts=1)
    futs = [srv.submit(_x(rng)) for _ in range(3)]
    assert _wait_until(lambda: srv.health()["workers"]["unhealthy"] == [0])
    assert _wait_until(lambda: all(f.done() for f in futs))
    for f in futs:
        with pytest.raises((RetriesExhaustedError,
                            AllWorkersUnhealthyError)):
            f.result(0)
    with pytest.raises(AllWorkersUnhealthyError):
        srv.submit(_x(rng))
    assert srv.stats.n_worker_restarts == 1
    srv.close()


def test_multi_worker_degrades_to_survivors(session, rng):
    xs = [_x(rng) for _ in range(8)]
    refs = [_ref(session, x) for x in xs]
    srv = AsyncServer(session, DynamicBatchPolicy(max_batch=1,
                                                  max_wait_ms=0.0),
                      faults=FaultInjector(KillWorker(worker=0,
                                                      times=None)),
                      retry=RetryPolicy(budget=4, backoff_ms=1.0),
                      workers=2, max_restarts=1)
    futs = [srv.submit(x) for x in xs]
    assert all(_same(f, r, timeout=60) for f, r in zip(futs, refs))
    srv.close()
    assert srv.health()["counters"]["n_completed"] == 8


def test_watchdog_requeues_hung_batch(session, rng):
    x = _x(rng)
    ref = _ref(session, x)
    srv = AsyncServer(session, DynamicBatchPolicy(max_batch=1,
                                                  max_wait_ms=0.0),
                      faults=FaultInjector(
                          DelayBatch(on_batch=0, delay_ms=1500.0)),
                      retry=RetryPolicy(budget=2, backoff_ms=1.0),
                      workers=1, max_restarts=2, watchdog_ms=150.0)
    fut = srv.submit(x)
    assert _same(fut, ref, timeout=60)
    assert _wait_until(lambda: srv.stats.n_hung_requeued >= 1)
    assert srv.stats.n_worker_restarts >= 1
    srv.close()


def test_watchdog_leaves_idle_workers_alone(session, rng):
    srv = AsyncServer(session, DynamicBatchPolicy(max_batch=1,
                                                  max_wait_ms=0.0),
                      workers=1, watchdog_ms=50.0)
    time.sleep(0.3)
    assert srv.stats.n_hung_requeued == 0
    assert srv.stats.n_worker_restarts == 0
    assert srv.submit(_x(rng)).result(timeout=60).shape[0] == 1
    srv.close()


# ---------------------------------------------------------------------------
# health(), to_json(), pinned workers
# ---------------------------------------------------------------------------

def test_health_snapshot_shape(session, rng):
    srv, clock = _manual(session, shed="oldest",
                         retry=RetryPolicy(budget=3))
    srv.submit(_x(rng))
    h = srv.health()
    assert h["queue_depth"] == 1 and h["workers"]["configured"] == 1
    assert h["shed_policy"] == "oldest" and h["retry_budget"] == 3
    assert not h["closed"] and not h["draining"]
    for k in ("n_submitted", "n_retried", "n_shed", "n_worker_crashes",
              "n_worker_restarts", "n_hung_requeued"):
        assert k in h["counters"]
    srv.close()
    assert srv.health()["closed"]


def test_stats_to_json_carries_fault_counters(session, rng):
    srv, clock = _manual(session,
                         faults=FaultInjector(FailBatch(on_batch=0)),
                         retry=RetryPolicy(budget=1, backoff_ms=5.0))
    fut = srv.submit(_x(rng))
    clock.advance_ms(10.1)
    srv.step()
    clock.advance_ms(5.1)
    srv.step()
    fut.result(0)
    js = srv.stats.to_json()
    assert js["n_retried"] == 1
    for k in ("n_retries_exhausted", "n_shed", "n_worker_crashes",
              "n_worker_restarts", "n_hung_requeued"):
        assert k in js
    srv.close()


def test_pinned_workers_serve_the_same(session, rng):
    xs = [_x(rng) for _ in range(4)]
    refs = [_ref(session, x) for x in xs]
    with AsyncServer(session, DynamicBatchPolicy(max_batch=1,
                                                 max_wait_ms=0.0),
                     workers=2, pin="auto") as srv:
        futs = [srv.submit(x) for x in xs]
        assert all(_same(f, r, timeout=60) for f, r in zip(futs, refs))
    with pytest.raises(ValueError, match="CPU sets"):
        AsyncServer(session, workers=2, pin=[(0,)], autostart=False)


# ---------------------------------------------------------------------------
# Artifact corruption: the port's own v5 artifacts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact(session, tmp_path_factory):
    art = tmp_path_factory.mktemp("faults") / "art"
    session.save(art)
    return art


@pytest.mark.parametrize("kind,error", [("weights", ArtifactCorruptError),
                                        ("plan", ArtifactCorruptError),
                                        ("manifest", ArtifactCorruptError)])
def test_corrupt_artifact_refused(artifact, tmp_path, kind, error):
    bad = tmp_path / "bad"
    shutil.copytree(artifact, bad)
    hit = corrupt_artifact(bad, kind)
    assert hit.is_file() and hit.read_bytes() != (
        artifact / hit.relative_to(bad)).read_bytes()
    with pytest.raises(error):
        InferenceSession.load(bad, device="cpu")
    with pytest.raises(ValueError, match="corruption target"):
        corrupt_artifact(bad, "everything")


def test_corrupt_file_flips_bytes(tmp_path):
    p = tmp_path / "blob"
    p.write_bytes(bytes(range(16)))
    corrupt_file(p, offset=15, nbytes=2)
    data = p.read_bytes()
    assert data[15] == 15 ^ 0xFF and data[0] == 0 ^ 0xFF
    assert data[1:15] == bytes(range(1, 15))
    empty = tmp_path / "empty"
    empty.touch()
    with pytest.raises(ValueError, match="empty"):
        corrupt_file(empty)


def test_loaded_artifact_serves_bit_identical(artifact, session, rng):
    loaded = InferenceSession.load(artifact, device="cpu")
    x = _x(rng, 3)
    want = padded_predict(session, x, bucket=4).numpy()
    with AsyncServer(loaded, DynamicBatchPolicy(max_batch=4,
                                                max_wait_ms=1.0,
                                                fixed_bucket=4)) as srv:
        got = srv.predict(torch.from_numpy(x), timeout=60).numpy()
    assert got.tobytes() == want.tobytes()
