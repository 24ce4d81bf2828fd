"""Port parity: the LM layers of the dense and ssm families.

Norms, RoPE, the attention block (prefill through B3's plain version and
the decode path), decode attention, the MLP, the causal conv, the SSD
decode step and the whole Mamba-2 layer, each held against the reference
(``repro/models/lm/{layers,ssm}.py``) on the same numpy inputs, in fp32.
Tolerance rtol = atol = 1e-5 (fp32 sums of at most a few hundred terms in
another order), 1e-4 through a whole attention block or Mamba-2 layer
(several such sums composed).  One bf16 case checks the reference's cast
order: normalise in fp32, cast, then scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.models.lm import layers as RL
from repro.models.lm import ssm as RS
from repro.models.lm.model import init_params as r_init_params
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import lm_params_from_numpy
from repro_torch.models.lm import layers as TL
from repro_torch.models.lm import ssm as TS

TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


def _layer0(name):
    """Layer 0 of the reference's reduced config, on both sides."""
    cfg = r_reduced(R_ARCHS[name])
    params = r_init_params(cfg, jax.random.PRNGKey(3))
    r_lp = jax.tree.map(lambda a: a[0], params["layers"])
    return cfg, reduced(ARCHS[name]), r_lp, lm_params_from_numpy(r_lp, "cpu")


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 3, 128)])
def test_rmsnorm_and_layernorm(shape, rng):
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        _np(RL.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        TL.layernorm(*(torch.from_numpy(a) for a in (x, w, b))).numpy(),
        _np(RL.layernorm(*(jnp.asarray(a) for a in (x, w, b)))), **TOL)


def test_rmsnorm_bf16_cast_order(rng):
    """bf16: normalised in fp32, cast to bf16, then multiplied by w in
    bf16 — the same bits as the reference, up to one bf16 rounding."""
    x = rng.normal(size=(3, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    want = _np(RL.rmsnorm(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(w, jnp.bfloat16))).astype(np.float32)
    got = TL.rmsnorm(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=8e-3)


@pytest.mark.parametrize("positions", ["range", "batch"])
def test_rope(positions, rng):
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = (np.arange(7) if positions == "range"
           else rng.integers(0, 4096, size=(2, 7)))
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        _np(RL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), **BLOCK_TOL)


@pytest.mark.parametrize("cache_len", [1, 9, 16, "per_row"])
def test_decode_attention(cache_len, rng):
    q = rng.normal(size=(2, 4, 1, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 2, 16, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 2, 16, 16)).astype(np.float32)
    lens = np.array([5, 12]) if cache_len == "per_row" else cache_len
    want = RL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(lens))
    got = TL.decode_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc)),
        torch.from_numpy(lens) if cache_len == "per_row" else lens)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_attention_prefill_block():
    """Projections + bias + RoPE + flash attention (B3's plain version) +
    output projection, and the K/V it emits for the cache."""
    r_cfg, t_cfg, r_lp, t_lp = _layer0("qwen2-1.5b")
    x = np.random.default_rng(1).normal(size=(2, 11, 64)).astype(np.float32)
    pos = np.arange(11)
    want, (wk, wv) = RL.attention(jnp.asarray(x), r_lp["attn"], r_cfg,
                                  positions=jnp.asarray(pos))
    got, (gk, gv) = TL.attention(torch.from_numpy(x), t_lp["attn"], t_cfg,
                                 positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), **BLOCK_TOL)
    np.testing.assert_allclose(gk.numpy(), _np(wk), **BLOCK_TOL)
    np.testing.assert_allclose(gv.numpy(), _np(wv), **BLOCK_TOL)


def test_attention_decode_block(rng):
    r_cfg, t_cfg, r_lp, t_lp = _layer0("qwen2-1.5b")
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    kc = rng.normal(size=(2, r_cfg.n_kv, 12, 16)).astype(np.float32)
    vc = rng.normal(size=(2, r_cfg.n_kv, 12, 16)).astype(np.float32)
    pos = np.full((2, 1), 6)
    want, _ = RL.attention(jnp.asarray(x), r_lp["attn"], r_cfg,
                           positions=jnp.asarray(pos),
                           kv_cache=(jnp.asarray(kc), jnp.asarray(vc)),
                           cache_len=7)
    got, _ = TL.attention(torch.from_numpy(x), t_lp["attn"], t_cfg,
                          positions=torch.from_numpy(pos),
                          kv_cache=(torch.from_numpy(kc),
                                    torch.from_numpy(vc)), cache_len=7)
    np.testing.assert_allclose(got.numpy(), _np(want), **BLOCK_TOL)


def test_mlp(rng):
    r_cfg, t_cfg, r_lp, t_lp = _layer0("qwen2-1.5b")
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(
        TL.mlp(torch.from_numpy(x), t_lp["mlp"], t_cfg).numpy(),
        _np(RL.mlp(jnp.asarray(x), r_lp["mlp"], r_cfg)), **BLOCK_TOL)
    # the plain-GELU MLP of starcoder2's recipe
    w = {"wu": rng.normal(size=(64, 128)).astype(np.float32) / 8,
         "wd": rng.normal(size=(128, 64)).astype(np.float32) / 11}
    r_g = dataclasses.replace(r_cfg, mlp_gated=False)
    t_g = dataclasses.replace(t_cfg, mlp_gated=False)
    np.testing.assert_allclose(
        TL.mlp(torch.from_numpy(x), {k: torch.from_numpy(v)
                                     for k, v in w.items()}, t_g).numpy(),
        _np(RL.mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                    for k, v in w.items()}, r_g)),
        **BLOCK_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state, rng):
    x = rng.normal(size=(2, 6, 10)).astype(np.float32)
    w = rng.normal(size=(4, 10)).astype(np.float32)
    st = rng.normal(size=(2, 3, 10)).astype(np.float32) if with_state else None
    wy, ws = RS.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                              None if st is None else jnp.asarray(st))
    gy, gs = TS.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(gy.numpy(), _np(wy), **TOL)
    np.testing.assert_allclose(gs.numpy(), _np(ws), **TOL)


def test_ssd_decode_step(rng):
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, size=(2, 3)).astype(np.float32)
    a_log = rng.normal(size=(3,)).astype(np.float32)
    b = rng.normal(size=(2, 5)).astype(np.float32)
    c = rng.normal(size=(2, 5)).astype(np.float32)
    st = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    wy, ws = RS.ssd_decode_step(*(jnp.asarray(a)
                                  for a in (x, dt, a_log, b, c, st)))
    gy, gs = TS.ssd_decode_step(*(torch.from_numpy(a)
                                  for a in (x, dt, a_log, b, c, st)))
    np.testing.assert_allclose(gy.numpy(), _np(wy), **TOL)
    np.testing.assert_allclose(gs.numpy(), _np(ws), **TOL)


@pytest.mark.parametrize("t", [5, 8, 21])
def test_mamba2_layer_prefill(t, rng):
    """in_proj split, conv, softplus, SSD through B4's plain version (T
    below, at and across chunks of 8), skip, gated RMSNorm, out_proj."""
    r_cfg, t_cfg, r_lp, t_lp = _layer0("mamba2-130m")
    x = rng.normal(size=(2, t, 64)).astype(np.float32)
    want, (ws, wc) = RS.mamba2_layer(jnp.asarray(x), r_lp, r_cfg)
    got, (gs, gc) = TS.mamba2_layer(torch.from_numpy(x), t_lp, t_cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), **BLOCK_TOL)
    np.testing.assert_allclose(gs.numpy(), _np(ws), **BLOCK_TOL)
    np.testing.assert_allclose(gc.numpy(), _np(wc), **BLOCK_TOL)


def test_mamba2_layer_decode(rng):
    r_cfg, t_cfg, r_lp, t_lp = _layer0("mamba2-130m")
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    st = rng.normal(size=(2, r_cfg.ssm_heads, r_cfg.ssm_head_dim,
                          r_cfg.ssm_state)).astype(np.float32)
    cv = rng.normal(size=(2, 3, r_cfg.d_inner + 2 * r_cfg.ssm_state)
                    ).astype(np.float32)
    want, (ws, wc) = RS.mamba2_layer(jnp.asarray(x), r_lp, r_cfg,
                                     ssm_state=jnp.asarray(st),
                                     conv_state=jnp.asarray(cv), decode=True)
    got, (gs, gc) = TS.mamba2_layer(torch.from_numpy(x), t_lp, t_cfg,
                                    ssm_state=torch.from_numpy(st),
                                    conv_state=torch.from_numpy(cv),
                                    decode=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **BLOCK_TOL)
    np.testing.assert_allclose(gs.numpy(), _np(ws), **BLOCK_TOL)
    np.testing.assert_allclose(gc.numpy(), _np(wc), **BLOCK_TOL)


def test_lm_params_from_numpy_keeps_bf16():
    tree = {"a": {"w": np.arange(6, dtype=np.float32).astype(
        ml_dtypes.bfloat16).reshape(2, 3)}, "b": np.ones(2, np.float32)}
    out = lm_params_from_numpy(tree, "cpu")
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["b"].dtype == torch.float32
    np.testing.assert_array_equal(out["a"]["w"].float().numpy(),
                                  np.arange(6).reshape(2, 3))
