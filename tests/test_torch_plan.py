"""Port parity: the planner.

(d) Given a ``MachineModel`` built from the reference's TPU constants in
    ``repro.core.cost``, the port's ``Pipeline.preset(mode)`` emits the
    reference's plan: mode, graph, layouts, schedules, transform counts and
    bytes, and predicted seconds to 1e-9 relative — for all five modes on
    ResNet-18 and for "fusion" on ResNet-50 at 224.
"""
import dataclasses
import json

import pytest

from repro.core import cost as r_cost
from repro.core.local_search import ScheduleDatabase as RDatabase
from repro.core.pipeline import MODES, Pipeline as RPipeline
from repro.core.schedule import ConvSchedule as RSchedule
from repro.core.schedule import ConvWorkload as RWorkload
from repro.core.schedule import candidate_schedules as r_candidates
from repro.engine.session import _plan_to_json as r_plan_json
from repro.models.cnn import build as r_build
from repro_torch.core import calibrate
from repro_torch.core import cost as t_cost
from repro_torch.core.local_search import ScheduleDatabase as TDatabase
from repro_torch.core.pipeline import MODES as T_MODES
from repro_torch.core.pipeline import Pipeline as TPipeline
from repro_torch.core.schedule import ConvSchedule as TSchedule
from repro_torch.core.schedule import ConvWorkload as TWorkload
from repro_torch.core.schedule import candidate_schedules as t_candidates
from repro_torch.engine.session import _plan_to_json as t_plan_json
from repro_torch.models.cnn import build as t_build

REF_MACHINE = t_cost.MachineModel(
    peak_flops=r_cost.PEAK_FLOPS_FP32, mem_bw=r_cost.HBM_BW,
    link_bw=r_cost.ICI_BW_PER_LINK, fast_mem_bytes=r_cost.VMEM_BYTES)


def _split(js):
    """(exact part, predicted seconds) of a plan's JSON."""
    js = json.loads(json.dumps(js))
    js.pop("report")
    return js, js.pop("predicted")


def _plans(model, image, batch, mode):
    rg, rs = r_build(model, batch=batch, image=image)
    tg, ts = t_build(model, batch=batch, image=image)
    want = r_plan_json(RPipeline.preset(mode).run(rg, rs))
    got = t_plan_json(TPipeline.preset(mode).run(tg, ts,
                                                 machine=REF_MACHINE))
    return want, got


@pytest.mark.parametrize("model,image,batch,mode",
                         [("resnet-18", 64, 2, m) for m in MODES]
                         + [("resnet-50", 224, 1, "fusion")])
def test_plan_matches_reference(model, image, batch, mode):
    want, got = _plans(model, image, batch, mode)
    (want_js, want_pred), (got_js, got_pred) = _split(want), _split(got)
    assert got_js == want_js
    assert got_pred == pytest.approx(want_pred, rel=1e-9)
    assert got["report"]["n_fused_blocks"] == want["report"]["n_fused_blocks"]
    assert got["report"]["solver"] == pytest.approx(want["report"]["solver"],
                                                    rel=1e-9)


def test_modes_match_reference():
    assert T_MODES == MODES


def test_h100_machine_plans_every_conv_blocked():
    g, s = t_build("resnet-50", batch=1, image=224)
    plan = TPipeline.preset("fusion").run(g, s)
    blocks = [n for n in plan.planned.graph.topo_order()
              if n.op == "conv_block"]
    assert len(blocks) == 53
    assert all(plan.planned.layouts[n.name].is_blocked for n in blocks)
    assert plan.report.n_pool_fused == 1
    assert sum(1 for n in blocks if len(n.inputs) == 2) == 16   # residuals
    assert t_cost.MachineModel.h100() == t_cost.H100
    assert t_cost.H100.fast_mem_bytes == 232_448


def test_measured_tuning_waits():
    """Measured tuning plans (on the CPU here, on the plain versions), with
    every conv's ranking measured and the copy bandwidth probed; unknown
    tunings and modes are refused."""
    g, s = t_build("resnet-18", batch=1, image=32)
    plan = TPipeline.preset("fusion").run(g, s, tuning="measured",
                                          search_budget=(1, 1, 1),
                                          device="cpu")
    tune = {p.name: p.stats for p in plan.report.passes}["local-tune"]
    assert tune["n_measured"] == tune["n_convs"] == 20
    assert plan.report.transform_bw > 0
    with pytest.raises(ValueError):
        TPipeline.preset("fusion").run(g, s, tuning="guess")
    with pytest.raises(ValueError):
        TPipeline.preset("fastest")


def test_cached_tuning_on_measured_entries_needs_a_copy_bandwidth():
    """A database carrying the reference's measured rankings prices edges
    on a measured clock: without a given one the port probes the device's
    relayout bandwidth (``core.calibrate``), once per process."""
    g, s = t_build("resnet-18", batch=1, image=32)
    db = TDatabase()
    TPipeline.preset("fusion").run(g, s, db=db)
    blob = json.loads(json.dumps(db.to_blob()))
    for rec in blob.values():
        rec["measured"] = True
    measured = TDatabase()
    measured.load_blob(blob)
    probed = TPipeline.preset("fusion").run(g, s, db=measured,
                                            tuning="cached", device="cpu")
    assert probed.report.transform_bw == \
        calibrate.measure_host_copy_bw(device="cpu")
    plan = TPipeline.preset("fusion").run(g, s, db=measured, tuning="cached",
                                          transform_bw=1e11)
    assert plan.report.transform_bw == 1e11


WORKLOADS = [
    dict(batch=1, in_channels=3, out_channels=64, height=224, width=224,
         kh=7, kw=7, stride=2, pad=3, fused_bn=True, fused_relu=True,
         fused_pool="max", pool_k=3, pool_stride=2, pool_pad=1),
    dict(batch=8, in_channels=256, out_channels=64, height=56, width=56,
         kh=1, kw=1, fused_bn=True, fused_residual=True),
    dict(batch=2, in_channels=128, out_channels=32, height=14, width=14,
         kh=3, kw=3, pad=1, concat_offset=32, concat_total=96),
]


@pytest.mark.parametrize("wl", WORKLOADS, ids=["stem", "res", "concat"])
def test_schedule_costs_match_reference(wl):
    rw, tw = RWorkload(**wl), TWorkload(**wl)
    for s in [(3, 64, 16, 1, True, "tap_stack"), (64, 32, 8, 2, False),
              (16, 32, 4, 1, True, "scan"), (1, 32, 2, 1, False, "patch_gemm")]:
        if wl["in_channels"] % s[0] or wl["out_channels"] % s[1]:
            continue
        want = r_cost.conv_schedule_cost(rw, RSchedule(*s))
        got = t_cost.conv_schedule_cost(tw, TSchedule(*s), REF_MACHINE)
        assert (got.compute_s, got.memory_s) == pytest.approx(
            (want.compute_s, want.memory_s), rel=1e-12)
        assert t_cost.conv_vmem_bytes(tw, TSchedule(*s)) == \
            r_cost.conv_vmem_bytes(rw, RSchedule(*s))
    assert [dataclasses.asdict(s) for s in t_candidates(tw)] == \
        [dataclasses.asdict(s) for s in r_candidates(rw)]


@pytest.mark.parametrize("fn", ["all_gather_s", "reduce_scatter_s",
                                "all_reduce_s", "all_to_all_s"])
def test_collective_costs_match_reference(fn):
    for nbytes, axis, links in [(1 << 20, 4, 1), (3 << 30, 8, 2), (5, 1, 1)]:
        want = getattr(r_cost, fn)(nbytes, axis, links)
        got = getattr(t_cost, fn)(nbytes, axis, links, machine=REF_MACHINE)
        assert got == pytest.approx(want, rel=1e-12)


def test_schedule_database_blob_crosses_both_ways():
    wl = WORKLOADS[1]
    rdb, tdb = RDatabase(), TDatabase()
    rdb.search(RWorkload(**wl))
    tdb.load_blob(json.loads(json.dumps(rdb.to_blob())))
    assert json.loads(json.dumps(tdb.to_blob())) == \
        json.loads(json.dumps(rdb.to_blob()))
    back = RDatabase()
    back.load_blob(json.loads(json.dumps(tdb.to_blob())))
    assert len(back) == len(tdb) == 1
    # a search through the port hits the loaded entry instead of searching
    hit = tdb.search(TWorkload(**wl))
    assert hit.best.ic_bn == rdb.search(RWorkload(**wl)).best.ic_bn
