"""``chip_smoke.phase_train`` rehearsed on the CPU at a tiny size: each
backward Function against autograd of its plain version (CPU-sized
cases), reduced qwen2-1.5b and mamba2-130m (with remat) through the
parity, full-step and command-line steps, with no launch of a card kernel
on the CPU and every backward on the plain route.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, reduced


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and under the
    suite's parallel workers a pool of threads a worker oversubscribes
    the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_train_phase_runs_on_cpu():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    full = {reduced(ARCHS["qwen2-1.5b"]): (2, 16), dataclasses.replace(
        reduced(ARCHS["mamba2-130m"]), remat=True): (2, 16)}
    out = smoke.phase_train("cpu", "cpu", full=full,
                            parity=dict(n_layers=1, batch=1, seq=16),
                            small=True)
    for rows in out["backward"].values():
        assert rows and all(r["gate_share"] <= 1.0 for r in rows)
        assert all(r["backward_calls"]["plain"] == 1 for r in rows)
    assert [r["loss_rel"] for r in out["parity"]] == [0.0, 0.0]
    q, m = out["full"]
    assert q["backward_calls_per_step"] == {"flash_attention": 2.0}
    assert m["backward_calls_per_step"] == {"ssd_intra": 2.0}
    assert q["launches_per_step"] == {"flash_attention": 0.0}
    assert q["device_ms"] == "not measured"
    main = out["main"]
    assert main["loss"]["max_loss_rel_vs_ref"] == 0.0
    assert main["resume"]["restored_bit_identical"]
    assert main["learns"]["drop"] > 3 * main["learns"]["standard_error"]
    assert sorted(r["arch"] for r in main["one_step"]) == sorted(ARCHS)
    assert not list(root.glob(".train-*"))
