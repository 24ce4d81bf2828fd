"""``chip_smoke.phase_launch`` rehearsed on the CPU at a tiny size: a
ResNet-18 artifact at 32 (batch 1 and 8, the source packed), its int8
lowering session and a reduced mamba2 artifact served through the
command line (a uniform stream, a bursty trace with ``--health``,
``--buckets auto`` on a copy, the ``--dtype`` gate, streamed tokens equal
to ``generate``'s), ``--arch`` for every architecture against a second
run, the command line as a process, and the roofline lines at full width
on the meta device — with no launch of a card kernel on the CPU.
"""
import importlib.util
from pathlib import Path

import pytest
import torch


@pytest.fixture
def one_torch_thread(monkeypatch):
    """One intra-op thread here and in the spawned command line: the phase
    runs client and worker threads of its own, and under the suite's
    parallel workers a pool of intra-op threads oversubscribes the host.
    The environment is put back after."""
    n = torch.get_num_threads()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # the command line's env preset writes the process environment
    monkeypatch.delenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", raising=False)
    monkeypatch.delenv("LD_PRELOAD", raising=False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_launch_phase_runs_on_cpu(tmp_path, one_torch_thread):
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.engine import compile, compile_lm

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cnn = compile("resnet-18", (1, 3, 32, 32), device="cpu")
    cnn.specialize(8)
    cnn.save(tmp_path / "resnet-18")
    compile("resnet-18", (1, 3, 32, 32), device="cpu", dtype="int8",
            use_kernel=False).save(tmp_path / "resnet-18-int8")
    compile_lm(reduced(ARCHS["mamba2-130m"]), max_len=32,
               device="cpu").save(tmp_path / "mamba2")
    out = smoke.phase_launch("cpu", "cpu", tmp_path / "resnet-18",
                             tmp_path / "resnet-18-int8", tmp_path / "mamba2",
                             {})
    c = out["cnn"]
    for trace in ("uniform", "bursty"):
        assert c[trace]["requests"] == smoke.LAUNCH_REQUESTS
        assert c[trace]["b1_launches"] == 0 and c[trace]["searches"] == 0
        assert c[trace]["bit_identical_at_bucket"]
    assert c["bursty"]["health"] and c["bursty"]["stats_lines"] >= 0
    assert c["buckets_auto"]["buckets"] and "re-saved" in \
        c["buckets_auto"]["line"]
    assert out["int8"]["b1_launches"] == 0
    assert "int8 precision" in out["int8"]["fp32_refused"]
    lm = out["lm"]
    assert lm["tokens_equal_generate"] and lm["searches"] == 0
    assert lm["b4_launches"] == 0 and len(lm["catchup_steps"]) == 3
    archs = out["arch"]["archs"]
    assert sorted(a["arch"] for a in archs) == sorted(ARCHS)
    assert all(a["tokens_compared"] == a["steps"] for a in archs)
    assert all(not any(a["launches"].values()) for a in archs)
    assert out["spawn"]["served"].startswith(
        f"served {smoke.LAUNCH_SPAWN}/{smoke.LAUNCH_SPAWN} ")
    lines = out["roofline"]
    assert [r["model"] for r in lines] == list(smoke.ROOFLINE_MODELS)
    for r in lines:
        assert [(s["kind"], s["batch"]) for s in r["steps"]] == [
            ("prefill", 1), ("decode", 1), ("decode", 4)]
        for s in r["steps"]:
            assert s["counted_flops"] > 0 and s["ideal_step_s"] > 0
            assert s["roofline_share"] == "not measured"
    assert not list(root.glob(".launch-*"))
