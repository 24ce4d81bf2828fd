"""The serving command line, ``repro_torch.launch.serve``, against the
reference's ``repro.launch.serve`` on the CPU: the ``--arch`` greedy loop
of one reduced config of each family on the reference's parameters, CNN
artifacts the reference saved (outputs, the ``--dtype`` gate both ways, a
replayed trace with ``--health``, ``--buckets auto`` re-saving an artifact
both packages load), a reduced mamba2 LM artifact streamed with zero
searches, the manifest routing, the refusal to run on a card that is not
there, and ``python -m repro_torch.launch.serve`` as a process.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS, reduced as r_reduced
from repro.launch import serve as rserve
from repro.models.lm import model as r_model
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import lm_params_from_numpy
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
# tokens: a step whose tokens differ must be a near-tie on the reference's
# logits there (top-2 margin within this share of the largest |logit|):
# fp32 sums in another order differ by ~1e-6 of it at these widths
MARGIN_TOL = 1e-4
# CNN outputs: the port's lowerings against the reference's on the same
# artifact, fp32 sums in another order, relative to the largest value
OUT_TOL = 1e-5
ARCH_ARGS = ["--batch", "2", "--prompt-len", "8", "--gen", "4"]
FAMILIES = ["qwen2-1.5b", "mamba2-130m", "arctic-480b", "recurrentgemma-2b",
            "whisper-tiny", "llava-next-mistral-7b"]
ENV_KEYS = ("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "TF_CPP_MIN_LOG_LEVEL",
            "LD_PRELOAD")


@pytest.fixture(autouse=True)
def serving_env(monkeypatch):
    """Both packages' ``apply_serving_env`` write the process environment;
    put it back after each test."""
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


def _arch_inputs(cfg, batch=2, prompt_len=8):
    """The reference main's draws: prompts, then a vlm's image embeddings
    or an encdec's frames, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(batch, prompt_len))
    extra = {}
    if cfg.family == "vlm":
        extra["img_embeds"] = rng.normal(
            size=(batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            size=(batch, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    return prompts, extra


def _ref_logits(rp, rcfg, prompts, extra, tokens, step):
    """The reference's logits at ``step`` of the greedy loop, its earlier
    steps fed ``tokens`` (teacher-forced)."""
    max_len = prompts.shape[1] + tokens.shape[1] + rcfg.n_img_tokens
    kw = {k: jnp.asarray(v) for k, v in extra.items()}
    cache, logits = r_model.prefill(rp, rcfg, jnp.asarray(prompts, jnp.int32),
                                    max_len=max_len, **kw)
    pos0 = prompts.shape[1] + (rcfg.n_img_tokens if rcfg.family == "vlm"
                               else 0)
    for i in range(step):
        logits, cache = r_model.decode_step(
            rp, rcfg, jnp.asarray(tokens[:, i:i + 1], jnp.int32), cache,
            jnp.int32(pos0 + i))
    return np.asarray(logits, np.float32)


@pytest.mark.parametrize("name", FAMILIES)
def test_arch_tokens_match_the_reference(name):
    rcfg, cfg = r_reduced(R_ARCHS[name]), reduced(ARCHS[name])
    want = np.asarray(rserve.main(["--arch", name] + ARCH_ARGS))
    rp = r_model.init_params(rcfg, jax.random.PRNGKey(0))
    params = lm_params_from_numpy(rp, "cpu")
    prompts, extra = _arch_inputs(cfg)
    got, t_prefill, t_decode = serve.greedy_generate(
        params, cfg, torch.from_numpy(prompts), 4,
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    got = got.numpy()
    assert got.shape == want.shape == (2, 4) and got.dtype == np.int32
    assert t_prefill > 0 and t_decode > 0
    diff = np.nonzero((got != want).any(axis=0))[0]
    if diff.size:                  # tokens may differ only at a near-tie
        step = int(diff[0])
        logits = _ref_logits(rp, rcfg, prompts, extra, want, step)
        for row in np.nonzero(got[:, step] != want[:, step])[0]:
            top2 = np.sort(logits[row])[-2:]
            margin = (top2[1] - top2[0]) / np.abs(logits[row]).max()
            assert margin <= MARGIN_TOL, (name, step, row, margin)


def test_arch_main_draws_seed_0_parameters_and_returns_tokens():
    gen = serve.main(["--arch", "whisper-tiny", "--device", "cpu"]
                     + ARCH_ARGS)
    assert gen.shape == (2, 4) and gen.dtype == torch.int32
    cfg = reduced(ARCHS["whisper-tiny"])
    prompts, extra = _arch_inputs(cfg)
    from repro_torch.models.lm.model import init_params
    again, _, _ = serve.greedy_generate(
        init_params(cfg, 0, "cpu"), cfg, torch.from_numpy(prompts), 4,
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert torch.equal(gen, again)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def _tiny_graph():
    """``tests/test_system.py::test_serve_artifact_dtype_gate``'s graph."""
    from repro.core.graph import Graph

    g = Graph()
    g.add("in", "input")
    g.add("c1", "conv2d", ["in"], in_channels=3, out_channels=8, kh=3,
          kw=3, stride=2, pad=1)
    g.add("r1", "relu", ["c1"])
    g.add("gap", "global_avg_pool", ["r1"])
    g.add("fl", "flatten", ["gap"])
    g.add("fc", "dense", ["fl"], units=10)
    g.mark_output("fc")
    return g


@pytest.fixture(scope="module")
def cnn_artifact(tmp_path_factory):
    """The tiny graph compiled and saved by the reference (batch 1 and 2,
    the source packed): a replayed trace sizes its requests up to the
    largest."""
    from repro.engine import compile as compile_session

    art = tmp_path_factory.mktemp("cnn") / "art"
    sess = compile_session(_tiny_graph(), {"in": (1, 3, 16, 16)})
    sess.specialize(2)
    sess.save(art)
    return art


@pytest.fixture(scope="module")
def int8_artifact(tmp_path_factory):
    """The tiny graph as a W8 int8 session, saved by the reference."""
    from repro.engine import compile as compile_session

    art = tmp_path_factory.mktemp("int8") / "art"
    compile_session(_tiny_graph(), {"in": (1, 3, 16, 16)},
                    dtype="int8").save(art)
    return art


def _close(got, want):
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=OUT_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("flags", [
    ["--requests", "3", "--max-batch", "1", "--dtype", "fp32"],
    ["--requests", "6", "--max-batch", "2", "--trace", "bursty", "--health",
     "--stats-interval", "0.05"],
], ids=["uniform", "bursty"])
def test_cnn_artifact_output_matches_the_reference(cnn_artifact, flags,
                                                    capsys):
    base = ["--artifact", str(cnn_artifact)] + flags
    want = rserve.main(base)
    got = serve.main(base + ["--device", "cpu"])
    _close(got, want)
    out = capsys.readouterr().out
    n = flags[1]
    assert out.count(f"served {n}/{n} requests") == 2
    if "--health" in flags:
        assert out.count("health:") == 2 and "per-class p99" in out


def test_trace_pacing_reads_the_clock_once(monkeypatch):
    """A replayed trace waits for each request's arrival time; the clock
    moves between two readings, so a second reading for the sleep's
    length could pass the arrival and ask ``time.sleep`` for a negative
    length, which raises (seen on a loaded host)."""
    clock = iter([1.00, 1.10, 1.20])
    slept = []

    def sleep(s):
        if s < 0:
            raise ValueError("sleep length must be non-negative")
        slept.append(s)

    monkeypatch.setattr(serve, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock), sleep=sleep))
    serve._pace(0.05, 0.96)           # 0.01 s ahead at the one reading
    serve._pace(0.05, 0.96)           # already past: no sleep
    assert slept == [pytest.approx(0.01)]


def test_dtype_gate_both_ways(cnn_artifact, int8_artifact):
    """Each artifact serves at its own precision (the int8 one as the
    reference serves it) and refuses the other, typed."""
    base = ["--artifact", str(cnn_artifact), "--requests", "3",
            "--max-batch", "1", "--device", "cpu"]
    assert serve.main(base + ["--dtype", "fp32"]).shape == (1, 10)
    with pytest.raises(ValueError, match="int8.*fp32 precision"):
        serve.main(base + ["--dtype", "int8"])
    base = ["--artifact", str(int8_artifact), "--requests", "3",
            "--max-batch", "1"]
    _close(serve.main(base + ["--dtype", "int8", "--device", "cpu"]),
           rserve.main(base + ["--dtype", "int8"]))
    with pytest.raises(ValueError, match="fp32.*int8 precision"):
        serve.main(base + ["--dtype", "fp32", "--device", "cpu"])


def test_buckets_auto_resaves_an_artifact_both_packages_load(cnn_artifact,
                                                              tmp_path,
                                                              capsys):
    from repro.engine import InferenceSession as RSession
    from repro_torch.engine import InferenceSession

    art = tmp_path / "art"
    shutil.copytree(cnn_artifact, art)
    serve.main(["--artifact", str(art), "--requests", "8", "--max-batch",
                "2", "--trace", "bursty", "--buckets", "auto", "--device",
                "cpu"])
    out = capsys.readouterr().out
    assert f"re-saved {art} with learned buckets" in out
    manifest = json.loads((art / "manifest.json").read_text())
    assert manifest["traffic"]["mode"] == "auto"
    assert sum(manifest["traffic"]["histogram"].values()) == 8
    sess, ref = InferenceSession.load(art, device="cpu"), RSession.load(art)
    assert sess.batch_sizes == sorted(ref.batch_sizes) \
        == manifest["traffic"]["buckets"]
    x = np.random.default_rng(3).normal(size=(1, 3, 16, 16)).astype(
        np.float32)
    for b in sess.batch_sizes:
        xb = np.repeat(x, b, axis=0)
        _close(sess.predict(torch.from_numpy(xb)), ref.predict(xb))


def test_lm_artifact_streams_every_request_with_zero_searches(tmp_path,
                                                              capsys):
    from repro_torch.core.local_search import search_calls
    from repro_torch.engine import compile_lm

    art = tmp_path / "mamba2"
    compile_lm(reduced(ARCHS["mamba2-130m"]), max_len=32,
               device="cpu").save(art)
    n = search_calls()
    assert serve.main(["--artifact", str(art), "--requests", "3", "--gen",
                       "4", "--device", "cpu"]) == 3
    assert search_calls() == n
    assert "streamed 3/3 generations" in capsys.readouterr().out


def test_artifact_routing(cnn_artifact, tmp_path):
    from repro_torch.engine import compile_lm

    lm = tmp_path / "lm"
    compile_lm(reduced(ARCHS["qwen2-1.5b"]), max_len=16,
               device="cpu").save(lm)
    bare = tmp_path / "bare"
    bare.mkdir()
    for path, is_lm in ((cnn_artifact, False), (lm, True), (bare, False),
                        (tmp_path / "missing", False)):
        assert serve._artifact_is_lm(str(path)) is is_lm
        assert rserve._artifact_is_lm(str(path)) is is_lm


def test_cuda_without_a_card_raises(cnn_artifact):
    """No fallback: asking for the card on a host without one raises
    before anything runs on the CPU."""
    with pytest.raises(RuntimeError, match="0 visible"):
        serve.main(["--arch", "qwen2-1.5b"] + ARCH_ARGS)
    with pytest.raises(RuntimeError, match="0 visible"):
        serve.main(["--artifact", str(cnn_artifact), "--requests", "1"])
    with pytest.raises(RuntimeError, match="0 visible"):
        serve.serve_artifact(str(cnn_artifact), 1)
    with pytest.raises(RuntimeError, match="2 CUDA device.*0 visible"):
        serve.main(["--arch", "qwen2-1.5b", "--devices", "2"] + ARCH_ARGS)


def test_module_runs_as_a_process():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen2-1.5b"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "arch=qwen2-1.5b-reduced batch=4 device=cpu" in proc.stdout


def _flags(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(--[a-z][a-z-]*)", capsys.readouterr().out))


def test_parser_takes_every_reference_flag_plus_device(capsys):
    assert _flags(serve.main, capsys) == _flags(rserve.main, capsys) | {
        "--device"}
