"""Port parity: the LM model of the dense and ssm families.

``forward``, ``prefill`` and ``decode_step`` of reduced qwen2-1.5b (dense,
GQA, QKV bias) and reduced mamba2-130m (SSD, tied embeddings) against the
reference (``repro/models/lm/model.py``), with the reference's parameters
carried over by ``lm_params_from_numpy``.  fp32; tolerance rtol = atol =
1e-4 on logits and caches (two layers of fp32 sums of up to a few hundred
terms, in another order).  A bf16 copy of the dense config holds the
reference's cast points: logits within 3e-2 of the largest logit, which
is a few bf16 roundings (2^-8 each) through two layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.models.lm import model as RM
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import compile, lm_params_from_numpy
from repro_torch.models.lm import model as TM

TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("qwen2-1.5b", "mamba2-130m")


def _setup(name, dtype="float32", seed=0):
    r_cfg = dataclasses.replace(r_reduced(R_ARCHS[name]), dtype=dtype)
    t_cfg = dataclasses.replace(reduced(ARCHS[name]), dtype=dtype)
    r_p = RM.init_params(r_cfg, jax.random.PRNGKey(seed))
    return r_cfg, t_cfg, r_p, lm_params_from_numpy(r_p, "cpu")


def _toks(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


@pytest.mark.parametrize("name", NAMES)
def test_init_params_tree_matches_reference(name):
    """Same tree, shapes and types as the reference's init_params (the
    values come from another generator)."""
    r_cfg, t_cfg, r_p, _ = _setup(name)
    t_p = TM.init_params(t_cfg, seed=0, device="cpu")
    r_leaves = jax.tree_util.tree_flatten_with_path(r_p)[0]
    t_flat = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                t_flat[path + (k,)] = v
    walk(t_p)
    r_flat = {tuple(p.key for p in path): leaf for path, leaf in r_leaves}
    assert set(r_flat) == set(t_flat)
    for key, leaf in r_flat.items():
        assert tuple(t_flat[key].shape) == leaf.shape, key
        assert str(t_flat[key].dtype).replace("torch.", "") == \
            str(leaf.dtype), key
    n = sum(v.numel() for k, v in t_flat.items())
    assert n == sum(leaf.size for leaf in r_flat.values())
    # same seed, same draws; another seed, other draws
    again = TM.init_params(t_cfg, seed=0, device="cpu")
    other = TM.init_params(t_cfg, seed=1, device="cpu")
    assert torch.equal(again["embed"], t_p["embed"])
    assert not torch.equal(other["embed"], t_p["embed"])


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    r_cfg, t_cfg, r_p, t_p = _setup(name)
    toks = _toks(r_cfg, (2, 21))
    want, _ = RM.forward(r_p, r_cfg, jnp.asarray(toks))
    got = TM.forward(t_p, t_cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("prompt", [8, 13])
def test_prefill_then_decode_matches_reference(name, prompt):
    """prefill fills the cache (K/V, or SSM and conv states) and returns
    the last logits; three decode steps then extend it in place, as the
    reference's return new caches."""
    r_cfg, t_cfg, r_p, t_p = _setup(name)
    toks = _toks(r_cfg, (2, prompt))
    r_cache, r_lg = RM.prefill(r_p, r_cfg, jnp.asarray(toks), max_len=24)
    t_cache, t_lg = TM.prefill(t_p, t_cfg, torch.from_numpy(toks),
                               max_len=24)
    assert set(t_cache) == set(r_cache)
    for step in range(3):
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(r_lg), **TOL)
        for key in r_cache:
            np.testing.assert_allclose(t_cache[key].numpy(),
                                       np.asarray(r_cache[key]), **TOL)
        nxt = np.array(jnp.argmax(r_lg, -1))[:, None]
        r_lg, r_cache = RM.decode_step(r_p, r_cfg, jnp.asarray(nxt, jnp.int32),
                                       r_cache, jnp.int32(prompt + step))
        t_lg, same = TM.decode_step(t_p, t_cfg, torch.from_numpy(nxt),
                                    t_cache, prompt + step)
        assert same is t_cache


@pytest.mark.parametrize("name", NAMES)
def test_decode_from_empty_cache_matches_reference(name):
    r_cfg, t_cfg, r_p, t_p = _setup(name)
    r_cache = RM.init_cache(r_cfg, 1, 8)
    t_cache = TM.init_cache(t_cfg, 1, 8, "cpu")
    for key in r_cache:
        assert tuple(t_cache[key].shape) == r_cache[key].shape
        assert str(t_cache[key].dtype)[6:] == str(r_cache[key].dtype)
    for pos, tok in enumerate(_toks(r_cfg, (4,))):
        t = np.array([[tok]])
        r_lg, r_cache = RM.decode_step(r_p, r_cfg, jnp.asarray(t, jnp.int32),
                                       r_cache, jnp.int32(pos))
        t_lg, t_cache = TM.decode_step(t_p, t_cfg, torch.from_numpy(t),
                                       t_cache, pos)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(r_lg), **TOL)


def test_bf16_dense_prefill_keeps_cast_points():
    r_cfg, t_cfg, r_p, t_p = _setup("qwen2-1.5b", dtype="bfloat16")
    assert t_p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    toks = _toks(r_cfg, (1, 16))
    _, r_lg = RM.prefill(r_p, r_cfg, jnp.asarray(toks), max_len=16)
    cache, t_lg = TM.prefill(t_p, t_cfg, torch.from_numpy(toks), max_len=16)
    assert t_lg.dtype == torch.bfloat16
    assert cache["k"].dtype == torch.bfloat16
    want = np.asarray(r_lg.astype(jnp.float32))
    err = np.abs(t_lg.float().numpy() - want).max() / np.abs(want).max()
    assert err < 3e-2


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "whisper-tiny",
                                  "llava-next-mistral-7b"])
def test_other_families_initialise_cache_and_compile(name):
    """The hybrid, encdec and vlm families at reduced size: the
    reference's parameter tree (lists of layers for hybrid and encdec),
    its cache's shapes, and a session that compiles and prewarms (an
    encdec's prewarm raises for its missing frames, as its generate
    does)."""
    cfg = reduced(ARCHS[name])
    r_cfg = r_reduced(R_ARCHS[name])
    params = TM.init_params(cfg, device="cpu")
    r_p = RM.init_params(r_cfg, jax.random.PRNGKey(0))
    assert _structure(params) == jax.tree_util.tree_map(
        lambda a: a.shape, r_p)
    cache = TM.init_cache(cfg, 2, 12, "cpu")
    assert _structure(cache) == jax.tree_util.tree_map(
        lambda a: a.shape, RM.init_cache(r_cfg, 2, 12))
    sess = compile(cfg, (1, 12), params=params, device="cpu")
    assert sess.cfg.family == cfg.family and sess.seq_buckets == [3, 6, 12]
    if cfg.family == "encdec":
        with pytest.raises(ValueError, match="frames"):
            sess.prewarm()
    else:
        sess.prewarm()


def _structure(tree):
    """The tree of dicts and lists with each tensor's shape."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return tuple(tree.shape)


SHIMS = ("arctic_480b", "kimi_k2_1t_a32b", "llava_next_mistral_7b",
         "mamba2_130m", "qwen2_1_5b", "recurrentgemma_2b", "stablelm_3b",
         "starcoder2_3b", "whisper_tiny", "yi_9b")


@pytest.mark.parametrize("shim", SHIMS)
def test_config_shims_are_the_references(shim):
    """Each of the port's ``configs/<arch>.py`` shims holds the
    reference's ``CONFIG`` and ``REDUCED``."""
    import importlib

    ours = importlib.import_module(f"repro_torch.configs.{shim}")
    ref = importlib.import_module(f"repro.configs.{shim}")
    assert dataclasses.asdict(ours.CONFIG) == dataclasses.asdict(ref.CONFIG)
    assert dataclasses.asdict(ours.REDUCED) == \
        dataclasses.asdict(ref.REDUCED)
    assert ours.CONFIG is ARCHS[ours.CONFIG.name]


def test_configs_are_the_reference_table():
    assert sorted(ARCHS) == sorted(R_ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(R_ARCHS[name])
        assert dataclasses.asdict(reduced(cfg)) == \
            dataclasses.asdict(r_reduced(R_ARCHS[name]))
        assert cfg.param_count() == R_ARCHS[name].param_count()
