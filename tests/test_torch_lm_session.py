"""Port parity: LM sessions, compile's LM dispatch, and the traffic tools.

``LMSession.generate`` against the reference's ``LMSession.generate`` on
the same weights (carried over by ``lm_params_from_numpy``), for prompts
below, at and between the buckets {8, 16} (the cases of
``tests/test_lm_session.py``), with ``on_token``, at batch 1 and 2, for
reduced qwen2-1.5b and mamba2-130m in fp32.  Tokens must be equal at every
step whose top-2 logit margin on the reference exceeds 1e-4 of the largest
logit (the port's logits agree to ~1e-6 relative; random weights can make
near-ties), up to the first near-tie that changes a token; the test also
checks that steps were compared.  ``solve_seq_buckets``, its helpers and
``SizeHistogram`` are held against the reference exactly on random
histograms.  chip_smoke.py's LM phases run here at a tiny size.
"""
import importlib.util
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.engine import compile_lm as r_compile_lm
from repro.engine import telemetry as r_tel
from repro.engine import traffic as r_traffic
from repro.models.lm import decode_step as r_decode, prefill as r_prefill
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import (LMSession, compile, compile_lm,
                                lm_params_from_numpy)
from repro_torch.engine import telemetry as t_tel
from repro_torch.engine import traffic as t_traffic

MARGIN = 1e-4
NAMES = ("qwen2-1.5b", "mamba2-130m")


def _pair(name, buckets, max_len=32, batch=1):
    r_cfg = r_reduced(R_ARCHS[name])
    ref = r_compile_lm(r_cfg, max_len=max_len, batch=batch,
                       seq_buckets=buckets, seed=0)
    port = compile_lm(reduced(ARCHS[name]), max_len=max_len, batch=batch,
                      seq_buckets=buckets,
                      params=lm_params_from_numpy(ref._params, "cpu"))
    return r_cfg, ref, port


def _margins(r_cfg, params, toks, new, max_len):
    """Top-2 margins, relative to the largest logit, along the
    reference's greedy path (its unbucketed prefill + decode loop, which
    its own tests hold bit-identical to generate)."""
    cache, lg = r_prefill(params, r_cfg, jnp.asarray(toks), max_len=max_len)
    out = []
    for t in range(new):
        a = np.asarray(lg)
        top2 = np.sort(a, axis=-1)[:, -2:]
        out.append(((top2[:, 1] - top2[:, 0]) / np.abs(a).max()).min())
        nxt = jnp.argmax(lg, -1).astype(jnp.int32)
        lg, cache = r_decode(params, r_cfg, nxt[:, None], cache,
                             jnp.int32(toks.shape[1] + t))
    return out


def _assert_tokens_match(got, want, margins):
    compared = 0
    for t, m in enumerate(margins):
        same = np.array_equal(got[:, t], want[:, t])
        if m > MARGIN:
            assert same, f"step {t} differs with a top-2 margin of {m}"
            compared += 1
        elif not same:
            break
    assert compared > 0


def _toks(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


# ---------------------------------------------------------------------------
# generation parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("prompt_len", [5, 8, 13, 16])
def test_generate_matches_reference(name, prompt_len):
    """Below / at / between / at-top of buckets {8, 16}."""
    r_cfg, ref, port = _pair(name, [8, 16])
    toks = _toks(r_cfg, (1, prompt_len))
    want = ref.generate(jnp.asarray(toks), 6)
    got = port.generate(toks, 6)
    assert got.dtype == np.int32 and got.shape == (1, 6)
    _assert_tokens_match(got, want,
                         _margins(r_cfg, ref._params, toks, 6, 32))


@pytest.mark.parametrize("name", NAMES)
def test_generate_batch_matches_reference(name):
    r_cfg, ref, port = _pair(name, [4, 8], max_len=16, batch=2)
    toks = _toks(r_cfg, (2, 11), seed=4)
    want = ref.generate(jnp.asarray(toks), 4)
    got = port.generate(toks, 4)
    _assert_tokens_match(got, want,
                         _margins(r_cfg, ref._params, toks, 4, 16))


def test_on_token_streams_exact_values():
    _, _, port = _pair("qwen2-1.5b", [8])
    toks = _toks(port.cfg, (1, 9))
    seen = []
    got = port.generate(toks, 5,
                        on_token=lambda s, t: seen.append((s, t.copy())))
    assert [s for s, _ in seen] == list(range(5))
    np.testing.assert_array_equal(np.stack([t for _, t in seen], 1), got)


def test_pick_reads_logits_and_feeds_tokens():
    """``pick`` sees each step's logits and its tokens are the ones fed
    back and returned: the argmax reproduces generate; fed tokens come
    back as given and steer the run like the same prompt extended."""
    _, _, port = _pair("mamba2-130m", [8])
    toks = _toks(port.cfg, (1, 9))
    seen = []

    def argmax(step, logits):
        seen.append(logits.clone())
        return logits.argmax(-1)

    greedy = port.generate(toks, 4)
    np.testing.assert_array_equal(port.generate(toks, 4, pick=argmax),
                                  greedy)
    assert len(seen) == 4 and seen[0].shape == (1, port.cfg.vocab)
    fed = np.array([[3, 1, 4]])
    out = port.generate(toks, 3,
                        pick=lambda s, lg: torch.from_numpy(fed[:, s]))
    np.testing.assert_array_equal(out, fed)
    # the step after feeding token 3 is the first step of the prompt + [3]
    nxt = port.generate(np.concatenate([toks, fed[:, :1]], 1), 1)
    seen.clear()
    port.generate(toks, 2, pick=lambda s, lg: (
        seen.append(lg.clone()), torch.from_numpy(fed[:, s]))[1])
    assert int(seen[1].argmax()) == int(nxt[0, 0])


def test_generate_validates():
    sess = compile_lm(reduced(ARCHS["qwen2-1.5b"]), max_len=16,
                      seq_buckets=[8], device="cpu")
    with pytest.raises(ValueError, match="overflow max_len"):
        sess.generate(_toks(sess.cfg, (1, 10)), 8)
    with pytest.raises(ValueError, match="tokens must be"):
        sess.generate(_toks(sess.cfg, (2, 4)), 2)          # wrong batch
    with pytest.raises(ValueError, match="tokens must be integers"):
        sess.generate(np.zeros((1, 4), np.float32), 2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        sess.generate(_toks(sess.cfg, (1, 4)), 0)
    with pytest.raises(ValueError, match="empty prompt"):
        sess.generate(np.zeros((1, 0), np.int64), 1)


def test_prewarm_runs_every_bucket():
    """A prewarmed session (one prefill per bucket and a decode step)
    keeps the halving ladder; the artifact half of this test, which
    waited for A6, is ``tests/test_torch_lm_artifacts.py``."""
    sess = compile_lm(reduced(ARCHS["mamba2-130m"]), max_len=16,
                      device="cpu", prewarm=True)
    assert sess.seq_buckets == [4, 8, 16]


# ---------------------------------------------------------------------------
# compile() dispatch and compile_lm's errors
# ---------------------------------------------------------------------------

def test_compile_dispatches_lm_config():
    sess = compile(reduced(ARCHS["qwen2-1.5b"]), (1, 32), device="cpu")
    assert isinstance(sess, LMSession)
    assert sess.max_len == 32 and sess.batch == 1
    assert sess.seq_buckets == [8, 16, 32]


def test_compile_dispatches_arch_name():
    sess = compile("mamba2-130m", {"tokens": (1, 8)}, device="cpu")
    assert isinstance(sess, LMSession)
    assert sess.cfg.family == "ssm" and sess.model_name == "mamba2-130m"
    assert sess.device.type == "cpu"


def test_entry_points_default_to_the_card():
    for fn in (compile, compile_lm):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_compile_lm_rejects_bad_spec():
    cfg = reduced(ARCHS["qwen2-1.5b"])
    with pytest.raises(ValueError, match="max_len"):
        compile(cfg, (1, 3, 8, 8), device="cpu")
    with pytest.raises(ValueError, match="exactly one token input"):
        compile(cfg, {"a": (1, 8), "b": (1, 8)}, device="cpu")
    with pytest.raises(ValueError, match="unknown LM architecture"):
        compile_lm("not-an-arch", max_len=8, device="cpu")
    with pytest.raises(ValueError, match="prompt_hist"):
        compile_lm(cfg, max_len=8, seq_buckets="auto", device="cpu")
    with pytest.raises(ValueError, match="only meaningful"):
        compile_lm(cfg, max_len=8, prompt_hist={4: 1}, device="cpu")
    # an encdec session compiles, and its prefill asks for the frames that
    # a token-only session cannot feed (as in the reference)
    whisper = compile(reduced(ARCHS["whisper-tiny"]), (1, 8), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        whisper.generate(np.zeros((1, 8), np.int64), 1)


def test_bucket_for_and_validation():
    cfg = reduced(ARCHS["qwen2-1.5b"])
    sess = compile_lm(cfg, max_len=32, seq_buckets=[8, 16, 32], device="cpu")
    assert sess.bucket_for(7) is None
    assert sess.bucket_for(8) == 8
    assert sess.bucket_for(31) == 16
    assert sess.bucket_for(32) == 32
    with pytest.raises(ValueError, match="seq_buckets"):
        compile_lm(cfg, max_len=16, seq_buckets=[32], device="cpu")
    with pytest.raises(ValueError, match="max_len must be"):
        compile_lm(cfg, max_len=0, device="cpu")
    with pytest.raises(ValueError, match="batch must be"):
        compile_lm(cfg, max_len=8, batch=0, device="cpu")


def test_auto_seq_buckets_from_histogram():
    hist = {4: 50, 16: 30, 17: 5, 32: 20}
    sess = compile_lm(reduced(ARCHS["qwen2-1.5b"]), max_len=32,
                      seq_buckets="auto", prompt_hist=hist,
                      max_seq_buckets=3, device="cpu")
    assert sess.seq_buckets == r_traffic.solve_seq_buckets(hist,
                                                           max_buckets=3)
    assert sess.traffic.counts() == hist
    assert t_traffic.expected_catchup_tokens(hist, sess.seq_buckets) <= \
        t_traffic.expected_catchup_tokens(hist, [32])


# ---------------------------------------------------------------------------
# traffic tools against the reference, on random histograms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_bucket_solvers_match_reference(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 200, size=rng.integers(1, 25))
    hist = {int(s): int(c) for s, c in zip(
        sizes, rng.integers(1, 50, size=len(sizes)))}
    k = int(rng.integers(1, 6))
    assert t_traffic.solve_seq_buckets(hist, max_buckets=k) == \
        r_traffic.solve_seq_buckets(hist, max_buckets=k)
    assert t_traffic.solve_buckets(hist, max_buckets=k) == \
        r_traffic.solve_buckets(hist, max_buckets=k)
    buckets = sorted(set(int(b) for b in rng.integers(1, 200, size=3)))
    assert t_traffic.expected_catchup_tokens(hist, buckets) == \
        r_traffic.expected_catchup_tokens(hist, buckets)
    assert t_traffic.expected_padded_waste(hist, buckets) == \
        r_traffic.expected_padded_waste(hist, buckets)


@pytest.mark.parametrize("seed", range(4))
def test_size_histogram_matches_reference(seed):
    rng = np.random.default_rng(seed)
    t_h, r_h = t_tel.SizeHistogram(8), r_tel.SizeHistogram(8)
    for s, c in zip(rng.integers(0, 500, size=60),
                    rng.integers(0, 4, size=60)):
        t_h.add(int(s), int(c))
        r_h.add(int(s), int(c))
    assert t_h.to_json() == r_h.to_json()
    assert [t_h.percentile(q) for q in (0, 50, 99, 100)] == \
        [r_h.percentile(q) for q in (0, 50, 99, 100)]
    assert t_traffic.solve_seq_buckets(t_h) == \
        r_traffic.solve_seq_buckets(r_h)


def test_coerce_counts_rejects_bad_histograms():
    with pytest.raises(ValueError, match=">= 1"):
        t_traffic.solve_seq_buckets({0: 3})
    with pytest.raises(ValueError, match="empty"):
        t_traffic.solve_seq_buckets({})
    with pytest.raises(TypeError):
        t_traffic.solve_buckets([1, 2])


# ---------------------------------------------------------------------------
# chip_smoke.py's LM phases, rehearsed on the CPU
# ---------------------------------------------------------------------------

def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("name", NAMES)
def test_chip_smoke_lm_phases_run_on_cpu(name):
    """On CPU tensors the wrappers take the plain versions, so the main
    path counts no launches; parity of the CPU against itself is exact."""
    smoke = _smoke()
    cfg = reduced(ARCHS[name])
    out = smoke.phase_lm_main("cpu", cfg, max_len=32,
                              requests=((32, 1), (16, 3), (13, 3), (5, 2)),
                              big=(2, 16, 8, 2))
    assert out["prefills"] == 4 and out["launches"] == 0
    par = smoke.phase_lm_parity("cpu", cfg, max_len=32, prompt=19, new=3)
    assert par["max_logit_err_rel"] == 0.0 and par["tokens_compared"] == 3
    assert par["bucket"] == 16


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "whisper-tiny",
                                  "llava-next-mistral-7b"])
def test_chip_smoke_a8_phases_run_on_cpu(name):
    """The A8 families' phases at reduced size: the hybrid through the
    session (a bucket past its window of 8), vlm and encdec through the
    model with their stub frontends' inputs; no launches on the CPU, and
    parity of the CPU against itself is exact."""
    smoke = _smoke()
    cfg = reduced(ARCHS[name])
    if cfg.family == "hybrid":
        assert smoke.lm_kernels_of(ARCHS[name]) == {"flash_attention": (8, 0)}
        out = smoke.phase_lm_main("cpu", cfg, max_len=32,
                                  requests=((20, 3), (32, 1)), big=None)
        assert out["prefills"] == 2 and out["launches"] == 0
        assert out["window"] == 8 and out["buckets"] == [[8, 16, 32]]
    else:
        out = smoke.phase_lm_frontend("cpu", cfg, 32, 5, 3, (1, 2))
        assert out["launches"] == 0 and len(out["runs"]) == 2
        assert out["runs"][0]["prefill_tokens"] == 5 + (
            cfg.n_img_tokens if cfg.family == "vlm" else 0)
    par = smoke.phase_lm_parity("cpu", cfg, n_layers=cfg.n_layers,
                                max_len=32, prompt=19, new=3)
    assert par["max_logit_err_rel"] == 0.0 and par["tokens_compared"] == 3
    assert smoke.lm_kernels_of(ARCHS["whisper-tiny"]) == {
        "flash_attention": (12, 4)}
    assert smoke.lm_kernels_of(ARCHS["llava-next-mistral-7b"]) == {
        "flash_attention": (32, 0)}


def test_chip_smoke_attn_bound_counts_the_masked_pairs():
    """B3's bound counts the pairs its masks keep: the causal half, the
    band of a window, every pair of a non-causal or cross-attention."""
    smoke = _smoke()
    assert smoke.attn_pairs(6, 6) == 21
    assert smoke.attn_pairs(6, 6, window=2) == 11
    assert smoke.attn_pairs(4608, 4608, True, 2048) == \
        2048 * 2049 // 2 + (4608 - 2048) * 2048
    assert smoke.attn_pairs(4, 1500, causal=False) == 6000
    b = smoke.attn_bound(1, 6, 6, 1, 64, torch.bfloat16, False, 0, 1500)
    assert b["bytes"] == 2 * (2 * 6 * 64 + 2 * 6 * 1500 * 64)
    assert b["bound_by"] == "bytes"


def test_chip_smoke_attn_cases_take_their_route():
    """Every B3 case that chip_smoke.py checks on the card is one that the
    route of its dtype takes (bf16: sm90, fp32: fma), and the cases cover
    the sm90 route's new head dims (80, kimi-k2's 112), a ragged S and
    every bf16 shape that the A8 families' main paths give B3."""
    from repro_torch.kernels.flash_attention import _route

    smoke = _smoke()
    cases = smoke.attn_cases()
    for name, b, hq, hkv, s, d, causal, window, dt, sk in cases:
        assert _route(dt, d) == smoke.B3_ROUTE[dt], name
    bf16 = [c for c in cases if c[8] == torch.bfloat16]
    assert {c[5] for c in bf16} >= {80, 112, 128, 256}
    assert any(c[4] % 128 for c in bf16)
    # (B, Hq, Hkv, S, D, causal, window, Sk): recurrentgemma-2b's buckets,
    # llava's image and text tokens, whisper-tiny's encoder, decoder and
    # cross-attention at a prompt and a decode step, at batch 1 and 4
    a8 = {(1, 10, 1, s, 256, True, 2048, s) for s in (1152, 2304, 4608)}
    a8.add((1, 32, 8, 3392, 128, True, 0, 3392))
    for b in (1, 4):
        a8 |= {(b, 6, 6, 1500, 64, False, 0, 1500),
               (b, 6, 6, 4, 64, True, 0, 4),
               (b, 6, 6, 4, 64, False, 0, 1500),
               (b, 6, 6, 1, 64, False, 0, 1500)}
    assert a8 <= {c[1:8] + c[9:] for c in bf16}
