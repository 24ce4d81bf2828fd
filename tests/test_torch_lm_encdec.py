"""Port parity: the encoder-decoder family (whisper-tiny) against the
reference, on the CPU.

Reduced whisper-tiny (2 encoder and 2 decoder layers, 16 frame positions,
layernorm, QKV bias, tied embeddings), with the reference's parameters
carried over by ``lm_params_from_numpy``: the encoder (non-causal, no
RoPE), each decoder layer's cross-attention K/V, ``forward``, ``prefill``
and several decode steps hold the reference's values to 1e-4 of the
largest (two layers of fp32 sums in another order).  The plain version of
B3 takes keys of their own length as the reference's
``flash_attention_xla`` does: fp32 sums of the same chunks, within
rtol = atol = 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.models.lm import layers as RL
from repro.models.lm import model as RM
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import lm_params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.lm import model as TM

NAME = "whisper-tiny"
REL = 1e-4
R_PREFILL = jax.jit(RM.prefill, static_argnums=(1,),
                    static_argnames=("max_len",))
R_DECODE = jax.jit(RM.decode_step, static_argnums=(1,))
R_FORWARD = jax.jit(RM.forward, static_argnums=(1,))
R_ENCODE = jax.jit(RM._encode, static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    r_cfg, t_cfg = r_reduced(R_ARCHS[NAME]), reduced(ARCHS[NAME])
    r_p = RM.init_params(r_cfg, jax.random.PRNGKey(seed))
    return r_cfg, t_cfg, r_p, lm_params_from_numpy(r_p, "cpu")


def _frames(cfg, batch, seed=2, s=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, s or cfg.enc_positions, cfg.d_model),
                               dtype=np.float32)


def _toks(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


def _close_rel(got, want, rel=REL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
    assert err <= rel, err


@pytest.mark.parametrize("s", [16, 11])
def test_encoder_and_cross_kv_match_reference(s):
    """The encoder over 16 or 11 frames, then every decoder layer's
    cross-attention K and V of its output."""
    r_cfg, t_cfg, r_p, t_p = _setup()
    fr = _frames(t_cfg, 2, s=s)
    want = R_ENCODE(r_p, r_cfg, jnp.asarray(fr))
    got = TM._encode(t_p, t_cfg, torch.from_numpy(fr))
    _close_rel(got.numpy(), want)
    for r_lp, t_lp in zip(r_p["dec_layers"], t_p["dec_layers"]):
        for g, w in zip(TM._cross_kv(t_lp, t_cfg, got),
                        RM._cross_kv(r_lp, r_cfg, want)):
            assert g.is_contiguous() and tuple(g.shape) == w.shape
            _close_rel(g.numpy(), w)


def test_forward_prefill_decode_match_reference():
    r_cfg, t_cfg, r_p, t_p = _setup()
    toks, fr = _toks(t_cfg, (2, 9)), _frames(t_cfg, 2)
    want, _ = R_FORWARD(r_p, r_cfg, jnp.asarray(toks),
                        frames=jnp.asarray(fr))
    got = TM.forward(t_p, t_cfg, torch.from_numpy(toks),
                     frames=torch.from_numpy(fr))
    _close_rel(got.numpy(), want)
    r_cache, r_lg = R_PREFILL(r_p, r_cfg, jnp.asarray(toks[:, :4]),
                              max_len=16, frames=jnp.asarray(fr))
    t_cache, t_lg = TM.prefill(t_p, t_cfg, torch.from_numpy(toks[:, :4]),
                               max_len=16, frames=torch.from_numpy(fr))
    _close_rel(t_lg.numpy(), r_lg)
    for i in range(t_cfg.n_layers):
        for k in ("k", "v"):
            _close_rel(t_cache["cross"][i][k].numpy(),
                       r_cache["cross"][i][k])
            _close_rel(t_cache["self"][i][k].numpy(), r_cache["self"][i][k])
    for p in range(4, 9):
        r_lg, r_cache = R_DECODE(r_p, r_cfg, jnp.asarray(toks[:, p:p + 1]),
                                 r_cache, jnp.int32(p))
        t_lg, t_cache = TM.decode_step(t_p, t_cfg,
                                       torch.from_numpy(toks[:, p:p + 1]),
                                       t_cache, p)
        _close_rel(t_lg.numpy(), r_lg)
        # each decoded position against the port's own full forward
        _close_rel(t_lg.numpy(), got[:, p].numpy())


def test_init_params_and_cache_trees_match_reference():
    r_cfg, t_cfg, r_p, _ = _setup()
    t_p = TM.init_params(t_cfg, seed=0, device="cpu")
    assert len(t_p["enc_layers"]) == 2 and len(t_p["dec_layers"]) == 2
    r_shapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), r_p)
    t_shapes = _shapes(t_p)
    assert t_shapes == jax.tree_util.tree_map(tuple, r_shapes,
                                              is_leaf=lambda x: isinstance(
                                                  x, tuple))
    want = jax.tree_util.tree_map(lambda a: a.shape,
                                  RM.init_cache(r_cfg, 3, 12))
    got = TM.init_cache(t_cfg, 3, 12, "cpu")
    assert jax.tree_util.tree_map(
        tuple, want, is_leaf=lambda x: isinstance(x, tuple)) == \
        _shapes(got, dtypes=False)


def _shapes(tree, dtypes=True):
    if isinstance(tree, dict):
        return {k: _shapes(v, dtypes) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v, dtypes) for v in tree]
    shape = tuple(tree.shape)
    return (shape, str(tree.dtype).removeprefix("torch.")) if dtypes \
        else shape


def test_prefill_needs_frames():
    _, t_cfg, _, t_p = _setup()
    with pytest.raises(ValueError, match="frames"):
        TM.prefill(t_p, t_cfg, torch.zeros((1, 4), dtype=torch.long),
                   max_len=8)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,sk,chunks", [(1, 40, (16, 16)), (4, 40, (16, 8)),
                                         (33, 21, (16, 16)),
                                         (7, 100, (1024, 1024))])
def test_plain_attention_with_a_kv_length_of_its_own(s, sk, chunks, causal):
    """``flash_attention_plain`` at Sk != S (whisper's cross-attention: a
    decode step, a prompt; and more queries than keys) against the
    reference's ``flash_attention_xla``, GQA 4:2, with its chunks."""
    rng = np.random.default_rng(s + sk)
    q = rng.standard_normal((2, 4, s, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, 2, sk, 16), dtype=np.float32)
            for _ in range(2))
    qc, kc = chunks
    want = RL.flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, q_chunk=qc,
                                  kv_chunk=kc)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
