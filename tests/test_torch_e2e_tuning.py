"""``chip_smoke.phase_tuning`` rehearsed on the CPU at a tiny size
(ResNet-18 at 32, two rungs of the ladder): the roofline and measured
sessions each run their plan with no kernel launch (CPU tensors take the
plain versions), the measured session's outputs against a CPU session built
with ``tuning="cached"`` on its database and transform bandwidth (plans
equal; ``phase_main``'s tolerances), the lowering session measured on its
own engine, and the ladder's rungs on one database.  Times are "not
measured" off the card.
"""
import importlib.util
from pathlib import Path


def test_chip_smoke_tuning_phase_runs_on_cpu(monkeypatch):
    from repro_torch.core import calibrate

    # a fresh probe cache: another test of this process may have probed
    monkeypatch.setattr(calibrate, "_CACHED_BW", {})
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.phase_tuning("cpu", "cpu", models=(("resnet-18", 32),),
                             budget=(1, 1, 1), modes=("nchw", "fusion"))
    pair, low, nchw, fusion = out["lines"]
    assert pair["phase"] == "tuning" and pair["plans_equal"]
    assert pair["searches"] == pair["measured_workloads"] > 0
    assert pair["measurements"] >= pair["searches"]
    assert pair["probes"] == 1 and pair["transform_bw"] > 0
    assert pair["b1_per_predict"] == {"roofline": 0, "measured": 0}
    assert pair["times"]["measured"]["device_ms_per_predict"] == \
        "not measured"
    assert low["phase"] == "tuning_lowerings" and low["plans_equal"]
    assert low["lowerings_per_predict"] == 20
    assert sum(low["plan_variants"]["measured"].values()) == 20
    assert (nchw["mode"], nchw["transforms"], nchw["distinct_convs"]) == \
        ("nchw", 0, 0)
    # the fusion rung reuses the measured pair's database: no new search
    assert fusion["mode"] == "fusion"
    assert fusion["transforms"] == pair["transforms"]["measured"]
    assert out["session"].tuning == "measured"
