"""``chip_smoke.phase_serving`` rehearsed on the CPU at a tiny size, its
start-up child process included: a ResNet-18 session at 32 (batch 1 and 8)
served under load at 1 and 2 workers, under injected faults and a replayed
bursty trace, a reduced mamba2's prompts streamed, its artifact served from
a fresh process, and a two-tenant fleet that evicts — every response
bit-identical to ``padded_predict`` at its bucket, the streamed tokens
equal to ``generate``'s, and no launch of a card kernel on the CPU.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch


@pytest.fixture
def one_torch_thread(monkeypatch):
    """One intra-op thread here and in the start-up child: the phase runs
    client and worker threads of its own, and under the suite's parallel
    workers a pool of intra-op threads each oversubscribes the host."""
    n = torch.get_num_threads()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_serving_phase_runs_on_cpu(tmp_path, one_torch_thread):
    from repro_torch.configs import ARCHS, reduced

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    main = smoke.phase_main("cpu", image=32, requests=1, big_batch=8,
                            model="resnet-18")
    cfg = dataclasses.replace(reduced(ARCHS["mamba2-130m"]), dtype="bfloat16")
    lm = smoke.phase_lm_main("cpu", cfg, max_len=32, requests=((16, 1),),
                             big=(2, 16, 8, 2))
    art = main["session"].save(tmp_path / "resnet-18")
    # the chaos step's watchdog far above a CPU batch under a loaded host
    out = smoke.phase_serving("cpu", "cpu", main, lm, art, requests=16,
                              rounds=1, trace_n=16, prompts=(8, 10, 16),
                              new=3, fleet_model=("resnet-18", 32),
                              chaos_ms=(2000.0, 2500.0))
    load = out["load"]
    assert load["bit_identical"] and load["requests"] == 16
    assert set(load["requests_per_s"]) == {"sequential", "workers_1",
                                           "workers_2", "sequential_nearest"}
    split = load["host_ms_per_batch"]
    assert set(split) == {"workers_1", "workers_2"}
    assert all(s["walk"] > 0 and s["gather"] > 0 and s["wait"] == 0
               for s in split.values())          # no stream on the CPU
    chaos = out["chaos"]["counters"]
    assert chaos["n_worker_crashes"] == 1 and chaos["n_hung_requeued"] >= 1
    assert chaos["n_completed"] == 16 and chaos["n_failed"] == 0
    assert out["trace"]["n_completed"] == 16
    assert set(out["trace"]["by_class_ms"]) == {"interactive", "standard",
                                                "batch"}
    stream = out["stream"]
    assert stream["tokens_equal"] and len(stream["streams"]) == 3
    assert [s["bucket"] for s in stream["streams"]] == [8, 8, 16]
    startup = out["startup"]
    assert startup["bit_identical"] and startup["searches"] == 0
    assert startup["spawn_to_first_response_s"] < smoke.STARTUP_LIMIT_S
    assert startup["b1_launches_first_response"] == 0    # no card
    fleet = out["fleet"]
    assert fleet["evictions"] >= 2 and fleet["respecialized"] >= 1
    assert fleet["bit_identical"] and fleet["searches"] == 0
    assert out["b1_launches"] == {"load": {"workers_1": 0, "workers_2": 0},
                                  "chaos": 0, "trace": 0, "fleet": 0}
    assert out["b4_stream_launches"] == [0, 0, 0]
    assert not list(root.glob(".serving-*"))
