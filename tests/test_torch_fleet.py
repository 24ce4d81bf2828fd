"""The port's ``FleetServer`` on the CPU: the invariants of the reference's
``tests/test_fleet.py`` — routed results bit-identical to
``padded_predict``, typed tenant errors, one shared schedule database (a
file-backed one too), LRU eviction under a memory budget with no request
lost and zero schedule searches to re-specialize, frozen tenants pinned
with a strict rollback, artifact paths loaded onto the fleet's device,
and the tenant lifecycle.  ``autostart=False`` fleets on a fake clock,
pumped by hand.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import local_search
from repro_torch.core.graph import Graph
from repro_torch.core.local_search import ScheduleDatabase
from repro_torch.engine import (DuplicateModelError, DynamicBatchPolicy,
                                FleetServer, InferenceSession,
                                MemoryBudgetError, ServingError,
                                UnknownModelError, compile, nearest_bucket,
                                padded_predict)
from repro_torch.engine.fleet import rows_of


def _tiny_net(units):
    g = Graph()
    g.add("in", "input")
    g.add("c1", "conv2d", ["in"], in_channels=3, out_channels=8, kh=3,
          kw=3, stride=2, pad=1)
    g.add("r1", "relu", ["c1"])
    g.add("gap", "global_avg_pool", ["r1"])
    g.add("fl", "flatten", ["gap"])
    g.add("fc", "dense", ["fl"], units=units)
    g.mark_output("fc")
    return g, {"in": (1, 3, 8, 8)}


def _fresh_session(units=4, **kw):
    g, shapes = _tiny_net(units)
    sess = compile(g, shapes, device="cpu", **kw)
    sess.specialize(4)
    return sess


@pytest.fixture(scope="module")
def session_pair():
    """Two sessions with different head widths (a routing mistake changes
    the output's shape), buckets {1, 4}."""
    return _fresh_session(units=4), _fresh_session(units=6)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


def _x(rng, rows):
    return rng.normal(size=(rows, 3, 8, 8)).astype(np.float32)


def _manual_fleet(**kw):
    clock = FakeClock()
    return FleetServer(clock=clock, autostart=False, device="cpu",
                       **kw), clock


def _pump(fleet, clock, futs, max_steps=64):
    for _ in range(max_steps):
        if all(f.done() for f in futs):
            return
        clock.advance_ms(20.0)
        fleet.step()
    raise AssertionError("futures did not settle under manual pumping")


def _fixed4():
    return DynamicBatchPolicy(max_batch=4, max_wait_ms=10.0, fixed_bucket=4)


def test_two_tenants_route_bit_identical(session_pair, rng):
    sa, sb = session_pair
    fleet, clock = _manual_fleet()
    fleet.add_model("alpha", sa, policy=_fixed4())
    fleet.add_model("beta", sb, policy=_fixed4())
    assert fleet.models == ["alpha", "beta"] and len(fleet) == 2
    xs = [_x(rng, 1) for _ in range(6)]
    refs = {n: [padded_predict(s, x, bucket=4).numpy() for x in xs]
            for n, s in (("alpha", sa), ("beta", sb))}
    futs = {n: [fleet.submit(n, x) for x in xs] for n in refs}
    _pump(fleet, clock, futs["alpha"] + futs["beta"])
    for n in refs:
        for f, ref in zip(futs[n], refs[n]):
            got = f.result(0).numpy()
            assert got.shape == ref.shape and got.tobytes() == ref.tobytes()
    st = fleet.stats()
    assert st["alpha"].n_completed == st["beta"].n_completed == 6
    fleet.close()


def test_unknown_and_duplicate_tenants(session_pair, rng):
    sa, _ = session_pair
    fleet, _clock = _manual_fleet()
    fleet.add_model("only", sa)
    with pytest.raises(UnknownModelError, match="ghost"):
        fleet.submit("ghost", _x(rng, 1))
    with pytest.raises(UnknownModelError):
        fleet.remove_model("ghost")
    with pytest.raises(DuplicateModelError, match="only"):
        fleet.add_model("only", sa)
    assert issubclass(UnknownModelError, (ServingError, KeyError))
    assert issubclass(DuplicateModelError, (ServingError, ValueError))
    assert issubclass(MemoryBudgetError, ServingError)
    fleet.close()


def test_shared_schedule_db(session_pair):
    sa, sb = session_pair
    n_a, n_b = len(sa.db), len(sb.db)
    fleet, _clock = _manual_fleet()
    fleet.add_model("alpha", sa)
    fleet.add_model("beta", sb)
    assert sa.db is fleet.db and sb.db is fleet.db
    assert len(fleet.db) >= max(n_a, n_b)
    fleet.close()


def test_shared_file_backed_db_written_by_one_thread_at_a_time(tmp_path):
    """A path-backed database shared by tenants that insert new entries
    from several threads: no insert fails while another writes the file,
    and the file ends holding every entry."""
    import dataclasses
    import threading

    db = ScheduleDatabase(tmp_path / "db.json")
    seed = _fresh_session(db=db)
    results = list(seed.db._mem.values())
    assert results
    errors = []

    def insert(i):
        try:
            for j in range(8):
                for r in results:
                    db.put(dataclasses.replace(
                        r.workload, batch=1000 * (i + 1) + j), r)
        except Exception as e:          # noqa: BLE001 — collected
            errors.append(e)

    threads = [threading.Thread(target=insert, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(ScheduleDatabase(tmp_path / "db.json")) == len(db)


def _pair_with_budget():
    sa, sb = _fresh_session(), _fresh_session()
    per_bucket = list(sa.memory_bytes().values())
    assert len(per_bucket) == 2
    total = sum(per_bucket) + sum(sb.memory_bytes().values())
    return sa, sb, total - min(per_bucket) // 2


def test_memory_budget_evicts_lru_with_zero_lost_requests(rng):
    """Room for three of the four specializations: LRU evicts.  A request
    runs through the smallest bucket resident when it executes (one
    request at a time here, so that bucket is known): every response is
    bit-identical to ``padded_predict`` at that bucket from before the
    fleet existed, an evicted bucket that no resident one covers is
    re-specialized with no schedule search, and nothing is lost.  alpha's
    second request is a single row, so its bucket 4 is the least recently
    used when beta arrives."""
    sa, sb, budget = _pair_with_budget()
    sessions = {"alpha": sa, "beta": sb}
    stream = [("alpha", 4), ("alpha", 1), ("beta", 1), ("alpha", 4),
              ("beta", 4), ("alpha", 1), ("beta", 1), ("alpha", 4),
              ("beta", 4)]
    xs = [_x(rng, rows) for _, rows in stream]
    before = {(i, b): padded_predict(sessions[n], x, bucket=b).numpy()
              for i, ((n, rows), x) in enumerate(zip(stream, xs))
              for b in (1, 4) if b >= rows}
    fleet, clock = _manual_fleet(memory_budget_bytes=budget)
    searches = local_search.search_calls()
    respecialized = 0
    for i, ((name, rows), x) in enumerate(zip(stream, xs)):
        if name not in fleet.models:
            fleet.add_model(name, sessions[name], policy=DynamicBatchPolicy(
                max_batch=4, max_wait_ms=0.0))
        fut = fleet.submit(name, x)
        sizes = sessions[name].batch_sizes
        bucket = nearest_bucket(rows, sizes)
        respecialized += bucket is None
        assert fleet.step(name)
        got = fut.result(0).numpy()
        assert got.tobytes() == before[(i, bucket or rows)].tobytes()
    assert local_search.search_calls() == searches
    assert respecialized >= 1
    health = fleet.health()
    assert health["memory"]["budget_bytes"] == budget
    assert health["memory"]["n_evictions"] == fleet.n_evictions >= 2
    assert 0 < health["memory"]["resident_bytes"] <= budget
    fleet.close()


def test_frozen_tenant_pinned_and_strict_rollback(session_pair, tmp_path):
    sa, _ = session_pair
    art = sa.save(tmp_path / "pinned_art", buckets=[1, 4],
                  include_source=False)
    frozen = InferenceSession.load(art, device="cpu")
    assert frozen.frozen
    need = sum(frozen.memory_bytes().values())
    fleet, _clock = _manual_fleet(memory_budget_bytes=max(1, need // 2))
    with pytest.raises(MemoryBudgetError, match="pinned"):
        fleet.add_model("heavy", frozen)
    assert fleet.models == [] and fleet.memory_bytes() == {}
    assert fleet.health()["memory"]["resident_bytes"] == 0
    assert sorted(frozen.batch_sizes) == [1, 4]
    fleet2, _c2 = _manual_fleet(memory_budget_bytes=need * 2)
    fleet2.add_model("heavy", frozen)
    assert fleet2.models == ["heavy"]
    fleet2.close()
    fleet.close()


def test_artifact_path_loads_on_the_fleets_device(session_pair, tmp_path,
                                                  rng):
    sa, _ = session_pair
    art = sa.save(tmp_path / "art")
    fleet, clock = _manual_fleet()
    fleet.add_model("alpha", art, policy=_fixed4())
    x = _x(rng, 2)
    fut = fleet.submit("alpha", torch.from_numpy(x))
    _pump(fleet, clock, [fut])
    assert fut.result(0).device.type == "cpu"
    assert fut.result(0).numpy().tobytes() == \
        padded_predict(sa, x, bucket=4).numpy().tobytes()
    fleet.close()


def test_budget_validation_and_rows_of():
    with pytest.raises(ValueError, match="memory_budget_bytes"):
        FleetServer(memory_budget_bytes=0, autostart=False)
    assert rows_of(np.zeros((3, 2))) == 3
    assert rows_of(torch.zeros((5, 1))) == 5
    assert rows_of([[1, 2], [3, 4]]) == 2


def test_remove_model_drains_queued_work(session_pair, rng):
    sa, sb = session_pair
    fleet, clock = _manual_fleet()
    fleet.add_model("alpha", sa)
    fleet.add_model("beta", sb)
    f = fleet.submit("alpha", _x(rng, 1))
    fleet.remove_model("alpha", drain=True)
    assert f.result(0).shape[0] == 1
    assert fleet.models == ["beta"]
    with pytest.raises(UnknownModelError):
        fleet.submit("alpha", _x(rng, 1))
    fleet.close()


def test_close_idempotent_and_context_manager(session_pair, rng):
    sa, _ = session_pair
    with _manual_fleet()[0] as fleet:
        fleet.add_model("alpha", sa)
        f = fleet.submit("alpha", _x(rng, 2))
    assert f.result(0).shape[0] == 2
    fleet.close()
    assert fleet.health()["closed"]
    with pytest.raises(ServingError, match="closed"):
        fleet.add_model("late", sa)


def test_per_tenant_stats_and_health_shape(session_pair, rng):
    sa, sb = session_pair
    fleet, clock = _manual_fleet()
    fleet.add_model("alpha", sa)
    fleet.add_model("beta", sb)
    futs = [fleet.submit("alpha", _x(rng, 1), priority="interactive",
                         deadline_ms=1000.0)]
    _pump(fleet, clock, futs)
    st = fleet.stats()
    assert set(st) == {"alpha", "beta"}
    assert st["alpha"].n_completed == 1
    assert st["alpha"].latency_by_class["interactive"].count == 1
    assert st["beta"].n_submitted == 0
    h = fleet.health()
    assert set(h) == {"tenants", "memory", "shared_db_entries", "closed"}
    assert set(h["tenants"]) == {"alpha", "beta"}
    assert "telemetry" in h["tenants"]["alpha"]
    assert h["memory"]["resident_bytes"] > 0
    fleet.close()


def test_step_single_model(session_pair, rng):
    sa, sb = session_pair
    fleet, clock = _manual_fleet()
    for n, s in (("alpha", sa), ("beta", sb)):
        fleet.add_model(n, s, policy=DynamicBatchPolicy(max_batch=4,
                                                        max_wait_ms=10.0))
    fa = fleet.submit("alpha", _x(rng, 1))
    fb = fleet.submit("beta", _x(rng, 1))
    clock.advance_ms(20.0)
    assert fleet.step("alpha")
    assert fa.done() and not fb.done()
    assert fleet.step()
    assert fb.done()
    fleet.close()


def test_threaded_fleet_serves_both_tenants(session_pair, rng):
    sa, sb = session_pair
    xs = [_x(rng, 1) for _ in range(8)]
    with FleetServer(device="cpu", workers=2) as fleet:
        fleet.add_model("alpha", sa, policy=_fixed4())
        fleet.add_model("beta", sb, policy=_fixed4())
        futs = [(n, x, fleet.submit(n, x)) for x in xs
                for n in ("alpha", "beta")]
        for n, x, f in futs:
            sess = sa if n == "alpha" else sb
            assert f.result(timeout=60).numpy().tobytes() == \
                padded_predict(sess, x, bucket=4).numpy().tobytes()
