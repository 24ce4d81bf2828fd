"""Port parity: the hybrid family (recurrentgemma-2b's RG-LRU blocks and
banded attention) against the reference, on the CPU.

``rg_lru``, ``rg_lru_step`` and ``recurrent_block`` (both gate layouts)
hold the reference's outputs to rtol = atol = 2e-4, the reference's own
bound against its oracle (the doubling scan sums in another order than
``associative_scan``).  ``forward``, ``prefill`` and ``decode_step`` of
reduced recurrentgemma-2b (3 layers: rec, rec, attn; window 8), with the
reference's parameters carried over by ``lm_params_from_numpy``, hold the
logits to 1e-4 of the largest and the LRU and conv states to 1e-5.  The
windowed-cache property of ``tests/test_windowed_cache.py`` holds on the
port's own model: prompts below, at and above the window, decode that
wraps the ring, each step against the port's ``forward``, and the ring
against the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.models.lm import model as RM
from repro.models.lm import rglru as RR
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import compile, lm_params_from_numpy
from repro_torch.models.lm import model as TM
from repro_torch.models.lm import rglru as TR

NAME = "recurrentgemma-2b"
LRU_TOL = dict(rtol=2e-4, atol=2e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_REL = 1e-4
# the reference's model functions, jitted once per config and shape
R_PREFILL = jax.jit(RM.prefill, static_argnums=(1,),
                    static_argnames=("max_len",))
R_DECODE = jax.jit(RM.decode_step, static_argnums=(1,))
R_FORWARD = jax.jit(RM.forward, static_argnums=(1,))
R_BLOCK = jax.jit(RR.recurrent_block, static_argnums=(2,),
                  static_argnames=("decode",))


@functools.lru_cache(maxsize=None)
def _setup(fused=False, seed=0):
    r_cfg = dataclasses.replace(r_reduced(R_ARCHS[NAME]), fused_gates=fused)
    t_cfg = dataclasses.replace(reduced(ARCHS[NAME]), fused_gates=fused)
    r_p = RM.init_params(r_cfg, jax.random.PRNGKey(seed))
    return r_cfg, t_cfg, r_p, lm_params_from_numpy(r_p, "cpu")


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close_rel(got, want, rel=LOGIT_REL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
    assert err <= rel, err


@pytest.mark.parametrize("t", [1, 2, 7, 16, 33])
def test_linear_scan_is_the_recurrence(t):
    """The doubling scan equals h_t = a_t h_{t-1} + b_t stepped in fp64."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.5, 1.0, (2, t, 5))
    b = rng.standard_normal((2, t, 5))
    h, want = np.zeros((2, 5)), []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    got = TR.linear_scan(torch.from_numpy(a).float(),
                         torch.from_numpy(b).float())
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("t", [1, 9, 64])
def test_rg_lru_matches_reference(t, with_h0):
    rng = np.random.default_rng(t)
    x, ig, rg = (_rand(rng, (2, t, 16)) for _ in range(3))
    lam = np.linspace(0.5, 2.0, 16).astype(np.float32)
    h0 = _rand(rng, (2, 16)) if with_h0 else None
    want_h, want_last = RR.rg_lru(
        jnp.asarray(x), jnp.asarray(ig), jnp.asarray(rg), jnp.asarray(lam),
        h0=None if h0 is None else jnp.asarray(h0))
    got_h, got_last = TR.rg_lru(
        torch.from_numpy(x), torch.from_numpy(ig), torch.from_numpy(rg),
        torch.from_numpy(lam), h0=None if h0 is None else torch.from_numpy(h0))
    assert got_last.dtype == torch.float32
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **LRU_TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               **LRU_TOL)


def test_rg_lru_step_matches_reference():
    rng = np.random.default_rng(3)
    x, ig, rg, h = (_rand(rng, (3, 16)) for _ in range(4))
    lam = np.linspace(0.5, 2.0, 16).astype(np.float32)
    want = RR.rg_lru_step(*(jnp.asarray(v) for v in (x, ig, rg, lam, h)))
    got = TR.rg_lru_step(*(torch.from_numpy(v) for v in (x, ig, rg, lam, h)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LRU_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_recurrent_block_matches_reference(fused):
    """Both gate layouts, a prefill from zero states and one from carried
    states, then a decode step."""
    r_cfg, t_cfg, r_p, t_p = _setup(fused)
    r_lp, t_lp = r_p["layers_list"][0]["rec"], t_p["layers_list"][0]["rec"]
    assert ("w_gates" in t_lp) == fused
    rng = np.random.default_rng(5)
    x = _rand(rng, (2, 11, t_cfg.d_model))
    want, (w_lru, w_conv) = R_BLOCK(jnp.asarray(x), r_lp, r_cfg)
    got, (g_lru, g_conv) = TR.recurrent_block(torch.from_numpy(x), t_lp,
                                              t_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LRU_TOL)
    np.testing.assert_allclose(g_lru.numpy(), np.asarray(w_lru), **STATE_TOL)
    np.testing.assert_allclose(g_conv.numpy(), np.asarray(w_conv),
                               **STATE_TOL)
    x2 = _rand(rng, (2, 5, t_cfg.d_model))
    want, (w_lru, w_conv) = R_BLOCK(
        jnp.asarray(x2), r_lp, r_cfg, lru_state=w_lru, conv_state=w_conv)
    got, (g_lru, g_conv) = TR.recurrent_block(
        torch.from_numpy(x2), t_lp, t_cfg, lru_state=g_lru,
        conv_state=g_conv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LRU_TOL)
    np.testing.assert_allclose(g_lru.numpy(), np.asarray(w_lru), **LRU_TOL)
    x1 = _rand(rng, (2, 1, t_cfg.d_model))
    want, (w_lru, w_conv) = R_BLOCK(
        jnp.asarray(x1), r_lp, r_cfg, lru_state=w_lru, conv_state=w_conv,
        decode=True)
    got, (g_lru, g_conv) = TR.recurrent_block(
        torch.from_numpy(x1), t_lp, t_cfg, lru_state=g_lru,
        conv_state=g_conv, decode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LRU_TOL)
    np.testing.assert_allclose(g_lru.numpy(), np.asarray(w_lru), **LRU_TOL)
    np.testing.assert_allclose(g_conv.numpy(), np.asarray(w_conv),
                               **STATE_TOL)


def test_init_params_tree_matches_reference():
    """``layers_list``: one dict a layer, its kind from the pattern, the
    reference's shapes and types (values from another generator)."""
    r_cfg, t_cfg, r_p, _ = _setup()
    t_p = TM.init_params(t_cfg, seed=0, device="cpu")
    assert isinstance(t_p["layers_list"], list)
    r_flat = jax.tree_util.tree_flatten_with_path(r_p)[0]
    t_flat = dict(_flat(t_p))
    assert len(r_flat) == len(t_flat)
    for path, leaf in r_flat:
        key = jax.tree_util.keystr(path)
        assert tuple(t_flat[key].shape) == leaf.shape, key
        assert str(t_flat[key].dtype).removeprefix("torch.") == \
            str(leaf.dtype), key
    kinds = ["attn" if "attn" in lp else "rec" for lp in t_p["layers_list"]]
    assert kinds == [t_cfg.layer_kind(i) for i in range(t_cfg.n_layers)] \
        == ["rec", "rec", "attn"]
    torch.testing.assert_close(t_p["layers_list"][0]["rec"]["lam"],
                               torch.from_numpy(np.array(
                                   r_p["layers_list"][0]["rec"]["lam"])))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_forward_prefill_decode_match_reference():
    r_cfg, t_cfg, r_p, t_p = _setup()
    toks = np.random.default_rng(1).integers(0, r_cfg.vocab, size=(2, 15))
    want, _ = R_FORWARD(r_p, r_cfg, jnp.asarray(toks))
    got = TM.forward(t_p, t_cfg, torch.from_numpy(toks))
    _close_rel(got.numpy(), want)
    r_cache, r_lg = R_PREFILL(r_p, r_cfg, jnp.asarray(toks[:, :11]),
                              max_len=24)
    t_cache, t_lg = TM.prefill(t_p, t_cfg, torch.from_numpy(toks[:, :11]),
                               max_len=24)
    _close_rel(t_lg.numpy(), r_lg)
    for p in range(11, 15):
        r_lg, r_cache = R_DECODE(r_p, r_cfg, jnp.asarray(toks[:, p:p + 1]),
                                 r_cache, jnp.int32(p))
        t_lg, t_cache = TM.decode_step(t_p, t_cfg,
                                       torch.from_numpy(toks[:, p:p + 1]),
                                       t_cache, p)
        _close_rel(t_lg.numpy(), r_lg)
    for i, (r_l, t_l) in enumerate(zip(r_cache["layers"],
                                       t_cache["layers"])):
        assert set(r_l) == set(t_l)
        tol = STATE_TOL if "lru" in t_l else dict(rtol=1e-4, atol=1e-4)
        for k in t_l:
            np.testing.assert_allclose(t_l[k].numpy(), np.asarray(r_l[k]),
                                       err_msg=f"layer {i} {k}", **tol)


# the windowed-cache property (tests/test_windowed_cache.py) on the port
W = reduced(ARCHS[NAME]).local_window                 # 8
MAX_LEN = 24


def _ring_case(prompt_len: int, n_decode: int):
    r_cfg, t_cfg, r_p, t_p = _setup()
    total = prompt_len + n_decode
    toks = np.random.default_rng(total).integers(0, t_cfg.vocab,
                                                 size=(2, total))
    ref = TM.forward(t_p, t_cfg, torch.from_numpy(toks))
    cache, lg = TM.prefill(t_p, t_cfg, torch.from_numpy(toks[:, :prompt_len]),
                           max_len=MAX_LEN)
    r_cache, _ = R_PREFILL(r_p, r_cfg, jnp.asarray(toks[:, :prompt_len]),
                           max_len=MAX_LEN)
    _close_rel(lg.numpy(), ref[:, prompt_len - 1].numpy())
    for j in range(n_decode):
        p = prompt_len + j
        lg, cache = TM.decode_step(t_p, t_cfg,
                                   torch.from_numpy(toks[:, p:p + 1]),
                                   cache, p)
        _, r_cache = R_DECODE(r_p, r_cfg, jnp.asarray(toks[:, p:p + 1]),
                              r_cache, jnp.int32(p))
        _close_rel(lg.numpy(), ref[:, p].numpy())
    ring = cache["layers"][2]
    assert ring["k"].shape[2] == W
    for k in ("k", "v"):
        np.testing.assert_allclose(ring[k].numpy(),
                                   np.asarray(r_cache["layers"][2][k]),
                                   rtol=1e-4, atol=1e-4)


_RNG = np.random.default_rng(7)
_CASES = sorted({(int(_RNG.integers(2, 15)), int(_RNG.integers(1, 7)))
                 for _ in range(8)})


@pytest.mark.parametrize("prompt_len,n_decode", _CASES)
def test_windowed_decode_matches_forward(prompt_len, n_decode):
    _ring_case(prompt_len, n_decode)


@pytest.mark.parametrize("prompt_len", [W - 1, W, W + 1, 2 * W + 3])
def test_window_boundary_prompts_wrap_the_ring(prompt_len):
    """Below, at and above the window, with enough decode steps to wrap
    the ring at least once."""
    _ring_case(prompt_len, W + 2)


def test_session_serves_the_hybrid_family():
    """``compile`` of a hybrid config: a bucket past the window rolls the
    ring, catch-up and new tokens decode on it, as the reference's
    session does on the same weights."""
    from repro.engine import compile_lm as r_compile_lm

    r_cfg, t_cfg, r_p, t_p = _setup()
    sess = compile(t_cfg, (1, 24), params=t_p, device="cpu")
    ref = r_compile_lm(r_cfg, max_len=24, params=r_p)
    assert sess.seq_buckets == ref.seq_buckets == [6, 12, 24]
    toks = np.random.default_rng(2).integers(0, t_cfg.vocab, size=(1, 14))
    np.testing.assert_array_equal(sess.generate(toks, 6),
                                  np.asarray(ref.generate(jnp.asarray(toks),
                                                          6)))
