"""``chip_smoke.phase_artifacts`` rehearsed on the CPU at a tiny size, its
child processes included (moved out of ``test_torch_e2e.py``, whose other
tests keep that file under a minute): a ResNet-18 session (batch 1 and 2,
the source packed, an unseen batch re-planned, a corrupt copy refused), its
int8 session on the lowerings, a reduced bf16 mamba2 and a ResNet-18
session compiled with ``tuning="measured"``, each loaded in a fresh process
with bit-identical outputs and leaves, no schedule search and no
calibration probe.
"""
import time


def test_chip_smoke_artifacts_phase_runs_on_cpu():
    """chip_smoke's ``artifacts`` phase at a tiny size, its child
    processes included: resnet-18 at 32 (batch 1 and 2, the source
    packed, an unseen batch 3 re-planned, a corrupt copy refused), its
    int8 session on the lowerings, a reduced bf16 mamba2 and a measured
    resnet-18, each loaded in a fresh process with bit-identical outputs
    and leaves and no schedule search; the measured one with no probe and
    its saved ``transform_bw``."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.engine import compile as t_compile

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    main = smoke.phase_main("cpu", image=32, requests=1, big_batch=2,
                            model="resnet-18")
    cfg = dataclasses.replace(reduced(ARCHS["mamba2-130m"]), dtype="bfloat16")
    lm = smoke.phase_lm_main("cpu", cfg, max_len=32, requests=((32, 1),),
                             big=(2, 16, 8, 2))
    t0 = time.perf_counter()
    tuned = {"session": t_compile("resnet-18", (1, 3, 32, 32), seed=0,
                                  device="cpu", tuning="measured",
                                  search_budget=(1, 1, 1)),
             "model": "resnet-18", "compile_s": time.perf_counter() - t0}
    lines = smoke.phase_artifacts("cpu", main, lm, tuned, requests=2,
                                  big_batch=2, respecialize=3,
                                  prompts=((32, 1), (20, 3)))
    cnn, q8, ssm, measured = lines
    assert cnn["batches"] == [1, 2] and cnn["search_calls"] == 0
    assert cnn["requests"] == [1, 1, 2] and cnn["files"] > 0
    assert cnn["respecialized"]["bit_identical"]
    assert "sha256" in cnn["corrupt_copy_refused"]["error"]
    assert q8["quantized_json"] and q8["dtype"] == "int8"
    assert q8["lowerings_per_predict"] == [20, 20]
    assert ssm["tokens_equal"] and ssm["dtype"] == "bfloat16"
    assert measured["tuning"] == "measured"
    assert measured["search_calls"] == measured["probes"] == 0
    assert measured["transform_bw"] == tuned["session"].transform_bw > 0
    assert measured["artifact"] == "resnet-18-measured"
    assert all(line["rebuild_s"] == 0.0 for line in lines)
    assert not list(root.glob(".artifacts-*"))
