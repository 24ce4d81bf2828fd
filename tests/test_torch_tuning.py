"""Port parity: A5, the measured schedule search.

(a) ``guided_local_search`` with the measured runner stubbed by the same
    scripted costs in both packages: on the lowerings the shortlist (the
    order of the measurements) and the final ranking, costs included, equal
    the reference's exactly, for six workloads under the reference's
    machine figures (a fused pool, a residual, a concat store, a
    ``quantize=True`` workload among them); on B1 the shortlist dedupes by
    ``(ic_bn, oc_bn, dtype)``.
(b) ``ScheduleDatabase.search_measured``'s budget rule, as the reference's
    ``tests/test_guided_search_db.py`` pins it, and its keys: entries
    measured on B1 apart from the lowerings', blobs crossing both packages.
(c) ``core.calibrate.measure_host_copy_bw`` on the CPU, the planner shim,
    and ``MachineModel``'s Hopper fields (the defaults are the reference's;
    the H100 plan's transforms are pinned).
(d) ``compile(..., tuning="measured", device="cpu")`` end to end: the
    calibrated ``transform_bw`` written back, the plan run through the
    reference's executor against the port's predict (``chip_smoke``'s
    ``phase_main`` tolerances: probabilities rtol 1e-3 / atol 1e-5 with
    equal argmax), and the artifact loaded with no search and no probe.
"""
import dataclasses
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost as r_cost
from repro.core import local_search as rls
from repro.core.schedule import VARIANTS
from repro.core.schedule import ConvWorkload as RWorkload
from repro.engine import compile as r_compile
from repro.engine.executor import compile_model as r_compile_model
from repro.engine.session import _plan_from_json as r_plan_from_json
from repro_torch.core import calibrate
from repro_torch.core import cost as t_cost
from repro_torch.core import local_search as tls
from repro_torch.core import planner
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.schedule import ConvWorkload as TWorkload
from repro_torch.engine import InferenceSession, compile as t_compile
from repro_torch.engine.session import _plan_to_json
from repro_torch.models.cnn import build

REF_MACHINE = t_cost.MachineModel(
    peak_flops=r_cost.PEAK_FLOPS_FP32, mem_bw=r_cost.HBM_BW,
    link_bw=r_cost.ICI_BW_PER_LINK, fast_mem_bytes=r_cost.VMEM_BYTES)
E2E_TOL = dict(rtol=1e-3, atol=1e-5)

WORKLOADS = {
    "stem_pool": dict(batch=1, in_channels=3, out_channels=64, height=56,
                      width=56, kh=7, kw=7, stride=2, pad=3, fused_bn=True,
                      fused_relu=True, fused_pool="max", pool_k=3,
                      pool_stride=2, pool_pad=1),
    "residual": dict(batch=2, in_channels=256, out_channels=64, height=14,
                     width=14, kh=1, kw=1, fused_bn=True,
                     fused_residual=True),
    "concat": dict(batch=1, in_channels=128, out_channels=32, height=14,
                   width=14, kh=3, kw=3, pad=1, fused_bn=True,
                   fused_relu=True, concat_offset=64, concat_total=160),
    "int8": dict(batch=1, in_channels=64, out_channels=128, height=28,
                 width=28, kh=3, kw=3, pad=1, fused_bn=True,
                 fused_relu=True, quantize=True),
    "plain": dict(batch=1, in_channels=64, out_channels=64, height=28,
                  width=28, kh=3, kw=3, stride=1, pad=1),
    "downsample": dict(batch=1, in_channels=128, out_channels=256,
                       height=28, width=28, kh=1, kw=1, stride=2,
                       fused_bn=True),
}


def scripted_cost(s) -> float:
    """A cost of the schedule alone, spaced 0.25% apart, so that many
    candidates fall within the 2% noise floor and the tie-break decides."""
    v = VARIANTS.index(s.resolved_variant())
    return 1e-3 * (1 + ((7 * s.ic_bn + 13 * s.oc_bn + 5 * v + 3 * s.ow_bn
                         + (s.dtype == "int8")) % 11) / 400)


def _stub(monkeypatch, module, calls):
    def run(wl, s, repeats=3, **kw):
        calls.append(dataclasses.asdict(s))
        return scripted_cost(s)

    monkeypatch.setattr(module, "measured_runner", run)


def _ranking(res):
    return [(dataclasses.asdict(r.schedule), r.cost_s) for r in res.ranked]


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_guided_search_matches_reference(monkeypatch, name):
    r_calls, t_calls = [], []
    _stub(monkeypatch, rls, r_calls)
    _stub(monkeypatch, tls, t_calls)
    want = rls.guided_local_search(RWorkload(**WORKLOADS[name]), top_k=6,
                                   per_variant=2)
    got = tls.guided_local_search(TWorkload(**WORKLOADS[name]), top_k=6,
                                  per_variant=2, machine=REF_MACHINE,
                                  device="cpu", use_kernel=False)
    assert t_calls == r_calls and len(t_calls) >= 6
    assert _ranking(got) == _ranking(want)
    assert (got.measured, got.search_budget) == (True, (6, 2))
    if name == "int8":
        assert any(s["dtype"] == "int8" for s in t_calls)
    # the tie-break decided: more than one candidate within the floor
    assert tls.ties(got) > 1


@pytest.mark.parametrize("name", ["residual", "int8"])
def test_b1_shortlist_dedupes_by_blocks_and_dtype(monkeypatch, name):
    lowering, b1 = [], []
    _stub(monkeypatch, tls, lowering)
    wl = TWorkload(**WORKLOADS[name])
    tls.guided_local_search(wl, machine=REF_MACHINE, device="cpu",
                            use_kernel=False)
    _stub(monkeypatch, tls, b1)
    res = tls.guided_local_search(wl, machine=REF_MACHINE, device="cpu",
                                  use_kernel=True)
    keys = [(s["ic_bn"], s["oc_bn"], s["dtype"]) for s in b1]
    assert len(keys) == len(set(keys))
    # the lowerings' shortlist measures one (ic_bn, oc_bn, dtype) under
    # several variants; B1, which ignores the variant, measures it once
    low_keys = [(s["ic_bn"], s["oc_bn"], s["dtype"]) for s in lowering]
    assert len(low_keys) > len(set(low_keys))
    assert len(res.ranked) == len(b1)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_search_measured_respects_budget(monkeypatch, pkg):
    calls = []
    mod = rls if pkg == "reference" else tls
    _stub(monkeypatch, mod, calls)
    wl = (RWorkload if pkg == "reference" else TWorkload)(
        **WORKLOADS["plain"])
    kw = {} if pkg == "reference" else dict(device="cpu")
    db = mod.ScheduleDatabase()
    db.search_measured(wl, top_k=2, per_variant=1, **kw)
    n_shallow = len(calls)
    db.search_measured(wl, top_k=2, per_variant=1, **kw)    # memoized
    assert len(calls) == n_shallow
    db.search_measured(wl, top_k=6, per_variant=2, **kw)    # deeper
    assert len(calls) > n_shallow
    if pkg == "port":
        # an analytical entry under the key does not satisfy it either
        db2 = tls.ScheduleDatabase()
        db2.search(wl)
        n = len(calls)
        db2.search_measured(wl, device="cpu", use_kernel=False)
        assert len(calls) > n


def test_measured_entries_are_keyed_by_engine(monkeypatch):
    calls = []
    _stub(monkeypatch, tls, calls)
    wl = TWorkload(**WORKLOADS["residual"])
    db = tls.ScheduleDatabase()
    b1 = db.search_measured(wl, device="cpu", use_kernel=True)
    low = db.search_measured(wl, device="cpu", use_kernel=False)
    key = tls._wl_key(wl)
    assert db._mem[key + tls.B1_KEY] is b1 and db._mem[key] is low
    # a B1 session's cached search takes the B1 entry, a lowering
    # session's the reference's key
    n = len(calls)
    assert db.search(wl, use_kernel=True) is b1
    assert db.search(wl, use_kernel=False) is low
    assert len(calls) == n


def test_measured_blobs_cross_both_packages(monkeypatch):
    """A reference-written measured blob serves the port's lowering
    sessions (not its B1 ones), and the port's blob, B1 entries included,
    loads in the reference, whose lowering search hits the port's
    lowering entry."""
    r_calls, t_calls = [], []
    _stub(monkeypatch, rls, r_calls)
    _stub(monkeypatch, tls, t_calls)
    spec = WORKLOADS["concat"]
    rdb = rls.ScheduleDatabase()
    rdb.search_measured(RWorkload(**spec))
    tdb = tls.ScheduleDatabase()
    tdb.load_blob(json.loads(json.dumps(rdb.to_blob(measured_only=True))))
    wl = TWorkload(**spec)
    got = tdb.search_measured(wl, device="cpu", use_kernel=False)
    assert not t_calls and got.measured
    assert _ranking(got) == _ranking(rdb.search_measured(RWorkload(**spec)))
    tdb.search_measured(wl, device="cpu", use_kernel=True)
    assert t_calls                      # B1 is measured, not borrowed
    back = rls.ScheduleDatabase()
    back.load_blob(json.loads(json.dumps(tdb.to_blob(measured_only=True))))
    assert len(back) == 2
    n = len(r_calls)
    back.search_measured(RWorkload(**spec))
    assert len(r_calls) == n
    assert json.loads(json.dumps(back.to_blob())) == \
        json.loads(json.dumps(tdb.to_blob()))


def test_copy_bandwidth_probe_on_the_cpu():
    n = calibrate.probe_calls()
    bw = calibrate.measure_host_copy_bw(image=16, channels=32, repeats=3,
                                        force=True, device="cpu")
    assert bw > 0 and calibrate.probe_calls() == n + 1
    assert calibrate.measure_host_copy_bw(device="cpu") == bw   # cached
    assert calibrate.probe_calls() == n + 1
    again = calibrate.measure_host_copy_bw(image=16, channels=32,
                                           repeats=3, force=True,
                                           device="cpu")
    assert again > 0 and calibrate.probe_calls() == n + 2
    assert calibrate.timed_seconds(lambda: None, 3, "cpu") >= 0


def test_planner_shim_warns_once_and_delegates(monkeypatch):
    monkeypatch.setattr(planner, "_warned", False)
    g, s = build("resnet-18", batch=1, image=32)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        plans = [planner.plan(g, s, mode="fusion") for _ in range(2)]
    assert sum(issubclass(w.category, DeprecationWarning)
               for w in seen) == 1
    g2, s2 = build("resnet-18", batch=1, image=32)
    want = _plan_to_json(Pipeline.preset("fusion").run(g2, s2))
    want.pop("report")
    for p in plans:
        got = _plan_to_json(p)
        got.pop("report")
        assert got == want


def test_machine_defaults_are_the_references():
    m = t_cost.MachineModel(1.0, 2.0, 3.0, 4)
    assert (m.tile_m, m.tile_n, m.tile_k, m.cores, m.working_set) == \
        (t_cost.SUBLANE, t_cost.MXU_DIM, t_cost.SUBLANE, 1, "blocked_loop")
    assert (t_cost.SUBLANE, t_cost.MXU_DIM) == (8, 128)
    h = t_cost.H100
    assert (h.tile_m, h.tile_n, h.tile_k, h.cores, h.working_set) == \
        (64, 64, 32, 132, "b1_launch")
    # the lowerings keep the reference's tile at the H100's rates
    assert t_cost.machine_for(False) == t_cost.MachineModel(
        h.peak_flops, h.mem_bw, h.link_bw, h.fast_mem_bytes)
    assert t_cost.machine_for(True) is h
    with pytest.raises(ValueError):
        t_cost.MachineModel(1.0, 2.0, 3.0, 4, working_set="vmem")
    wl = TWorkload(**WORKLOADS["residual"])
    assert t_cost.wave_utilization(wl, REF_MACHINE) == 1.0


def test_b1_smem_is_the_launch_plans():
    """The cost model's copy of B1's staged shared memory equals the
    launch plan's, at every conv of ResNet-50's and VGG-16's H100 plans
    and the pooled stem."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels.conv2d_nchwc import launch_plan

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    convs = (smoke.plan_convs("resnet-50", 1, 224)
             + smoke.plan_convs("vgg-16", 1, 224) + smoke.extra_cases())
    for c in convs:
        assert t_cost.b1_smem_bytes(c["wl"], t_cost.H100) == \
            launch_plan(*smoke.plan_shapes(c))["smem"], smoke.wl_name(c)


@pytest.mark.parametrize("model,transforms", [("resnet-50", 3),
                                              ("vgg-16", 2)])
def test_h100_plan_transforms_are_pinned(model, transforms):
    """The H100 model's roofline plan at 224 (B1's tile and staging; 34
    and 12 transforms on the reference's tile)."""
    g, s = build(model, batch=1, image=224)
    assert Pipeline.preset("fusion").run(g, s).planned.n_transforms == \
        transforms


@pytest.fixture(scope="module")
def measured_session():
    n = tls.search_calls()
    sess = t_compile("resnet-18", (1, 3, 32, 32), seed=0, device="cpu",
                     tuning="measured", search_budget=(1, 1, 1))
    return sess, tls.search_calls() - n


def test_measured_compile_plans_on_the_cpu(measured_session):
    sess, searches = measured_session
    plan = sess.plan_for(1)
    assert searches > 0 and plan.report.transform_bw is not None
    assert sess.transform_bw == plan.report.transform_bw
    stats = {p.name: p.stats for p in plan.report.passes}
    assert stats["local-tune"]["n_measured"] == stats["local-tune"]["n_convs"]
    assert stats["global-layout"]["transform_bw_auto"] == \
        round(sess.transform_bw)
    assert all(k.endswith(tls.B1_KEY) for k in sess.db._mem
               if sess.db._mem[k].measured)
    # a later batch size reuses the calibrated figure: no new probe
    n = calibrate.probe_calls()
    sess.specialize(2)
    assert calibrate.probe_calls() == n
    assert sess.plan_for(2).report.transform_bw == sess.transform_bw


def test_measured_plan_runs_in_the_reference(measured_session):
    sess, _ = measured_session
    ref = r_compile("resnet-18", (1, 3, 32, 32), seed=0)
    js = json.loads(json.dumps(_plan_to_json(sess.plan_for(1))))
    model = r_compile_model(r_plan_from_json(js), ref._params)
    x = np.random.default_rng(3).normal(size=(1, 3, 32, 32)).astype(
        np.float32)
    want = np.asarray(model.predict(jnp.asarray(x)))
    got = sess.predict(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **E2E_TOL)
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


def test_measured_artifact_loads_with_no_search_and_no_probe(
        measured_session, tmp_path):
    sess, _ = measured_session
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 3, 32, 32)).astype(np.float32))
    want = sess.predict(x)
    sess.save(tmp_path / "art")
    n, p = tls.search_calls(), calibrate.probe_calls()
    loaded = InferenceSession.load(tmp_path / "art", device="cpu")
    got = loaded.predict(x)
    assert tls.search_calls() == n and calibrate.probe_calls() == p
    assert (loaded.tuning, loaded.transform_bw) == ("measured",
                                                    sess.transform_bw)
    assert torch.equal(got, want)
