"""Port parity: the trainer's pure parts — AdamW, SGD and the cosine
schedule (``optim/adamw.py``), gradient compression
(``runtime/compression.py``), the synthetic data stream
(``data/pipeline.py``) and the elastic re-mesh helpers
(``runtime/fault_tolerance.py``) — against the reference on the same numpy
inputs.

Tolerances: an update of fp32 leaves within rtol = 1e-6, atol = 1e-7 of
the reference's (the same elementwise fp32 arithmetic; the global norm is
a sum in another order, and XLA may fuse a multiply-add); bf16 leaves
within one bf16 ulp of the reference's (the same fp32 value rounded, or
its neighbour where the fp32 values differ in the last bits); moments in
fp32 as the fp32 leaves.  Compression codes equal, scales and errors
within 1e-7 relative.  The data stream and the re-mesh helpers exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import ARCHS as R_ARCHS, reduced as r_reduced
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticLMStream as RStream
from repro.engine.supervision import StragglerMitigator as RMitigator
from repro.optim import AdamW as RAdamW, SGD as RSGD, cosine_lr as r_cosine
from repro.runtime import compression as rcomp
from repro.runtime import fault_tolerance as rft
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.engine.supervision import StragglerMitigator
from repro_torch.optim import AdamW, AdamWState, SGD, cosine_lr
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import (compression, plan_elastic_mesh,
                                 rebalanced_batch_split)
from repro_torch.runtime import fault_tolerance as tft


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and under the
    suite's parallel workers a pool of threads a worker oversubscribes
    the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, bf16=False, scale=1.0):
    """A small parameter-shaped tree: dicts, a list of dicts, fp32 leaves
    and (with ``bf16``) bf16 ones; numpy values."""
    rng = np.random.default_rng(seed)

    def a(*shape, dt=np.float32):
        return (rng.normal(size=shape) * scale).astype(dt)
    bdt = ml_dtypes.bfloat16 if bf16 else np.float32
    return {"embed": a(16, 8, dt=bdt), "final_norm": {"w": a(8)},
            "layers": {"attn": {"wq": a(2, 8, 8, dt=bdt), "bq": a(2, 8)},
                       "ssm": {"a_log": a(2, 4)}},
            "layers_list": [{"w": a(3, 5)}, {"w": a(5, dt=bdt)}]}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    def leaf(x):
        x = np.asarray(x)
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.astype(np.float32)).bfloat16()
        return torch.from_numpy(x.copy())
    return jax.tree.map(leaf, tree) if isinstance(tree, (dict, list)) \
        else leaf(tree)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_tree_close(got, want, bf16_ulps=1):
    g = tree_leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape
        if y.dtype == ml_dtypes.bfloat16:
            assert x.dtype == torch.bfloat16
            yf = y.astype(np.float32)
            ulp = np.abs(yf) * 2.0 ** -7 + 1e-30
            assert (np.abs(_np(x) - yf) <= bf16_ulps * ulp).all()
        else:
            np.testing.assert_allclose(_np(x), y.astype(np.float32), **TOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_adamw_steps_match_reference(bf16, grad_scale):
    """Three updates with a changing lr scale; gradients small (the clip
    does nothing) or large (the clip scales them to norm 1)."""
    params = _tree(0, bf16)
    r_opt, t_opt = RAdamW(lr=1e-2), AdamW(lr=1e-2)
    rp, tp = _to_jax(params), _to_torch(params)
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    assert isinstance(ts, AdamWState)
    assert ts.step.dtype == torch.int32 and ts.step.dim() == 0
    assert all(m.dtype == torch.float32 for m in tree_leaves(ts.mu))
    for i in range(3):
        g = _tree(10 + i, bf16, scale=grad_scale)
        lr_scale = 0.5 + 0.25 * i
        rp, rs, rm = r_opt.update(_to_jax(g), rs, rp, lr_scale=lr_scale)
        tp, ts, tm = t_opt.update(_to_torch(g), ts, tp, lr_scale=lr_scale)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        _assert_tree_close(tp, rp)
        _assert_tree_close(ts.mu, rs.mu)
        _assert_tree_close(ts.nu, rs.nu)
        assert int(ts.step) == int(rs.step) == i + 1


def test_adamw_does_not_write_its_inputs_and_keeps_types():
    params = _to_torch(_tree(1, bf16=True))
    grads = _to_torch(_tree(2, bf16=True))
    opt = AdamW()
    state = opt.init(params)
    before = [t.clone() for t in tree_leaves((params, grads, state))]
    new_p, new_s, _ = opt.update(grads, state, params)
    for a, b in zip(before, tree_leaves((params, grads, state))):
        assert torch.equal(a, b)
    assert [t.dtype for t in tree_leaves(new_p)] == \
        [t.dtype for t in tree_leaves(params)]
    assert not any(t.requires_grad for t in tree_leaves((new_p, new_s)))


def test_adamw_bf16_moments():
    params = _tree(3)
    r_opt = RAdamW(moment_dtype="bfloat16")
    t_opt = AdamW(moment_dtype="bfloat16")
    g = _tree(4)
    rp, rs, _ = r_opt.update(_to_jax(g), r_opt.init(_to_jax(params)),
                             _to_jax(params))
    tp, ts, _ = t_opt.update(_to_torch(g), t_opt.init(_to_torch(params)),
                             _to_torch(params))
    assert all(m.dtype == torch.bfloat16 for m in tree_leaves(ts.mu))
    _assert_tree_close(tp, rp)
    _assert_tree_close(ts.mu, rs.mu)


@pytest.mark.parametrize("grad_scale,clipped", [(0.01, False), (10.0, True)])
def test_clip_by_global_norm(grad_scale, clipped):
    """The first moment after one step is (1 - b1) times the clipped
    gradient, so it shows the clip factor min(1, clip_norm / |g|)."""
    g = _to_torch(_tree(5, scale=grad_scale))
    params = tree_map(torch.zeros_like, g)
    opt = AdamW(weight_decay=0.0)
    _, state, m = opt.update(g, opt.init(params), params)
    norm = float(torch.sqrt(sum(x.square().sum() for x in tree_leaves(g))))
    np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-6)
    factor = min(1.0, 1.0 / norm)
    assert (factor < 1.0) == clipped
    for mu, x in zip(tree_leaves(state.mu), tree_leaves(g)):
        np.testing.assert_allclose(mu.numpy(), 0.1 * factor * x.numpy(),
                                   rtol=1e-5, atol=1e-9)


def test_sgd_matches_reference():
    params = _tree(6, bf16=True)
    r_opt, t_opt = RSGD(), SGD()
    rp, tp = _to_jax(params), _to_torch(params)
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    for i in range(3):
        g = _tree(20 + i, bf16=True)
        rp, rs, _ = r_opt.update(_to_jax(g), rs, rp, lr_scale=0.5)
        tp, ts, _ = t_opt.update(_to_torch(g), ts, tp, lr_scale=0.5)
        _assert_tree_close(tp, rp)
        _assert_tree_close(ts, rs)


@pytest.mark.parametrize("warmup,total", [(10, 30), (0, 5), (3, 3),
                                          (10, 100)])
def test_cosine_lr_matches_reference(warmup, total):
    for step in range(total + 2):
        got = cosine_lr(step, base=1.0, warmup=warmup, total=total)
        want = r_cosine(step, base=1.0, warmup=warmup, total=total)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("seed", range(4))
def test_quantize_leaf_codes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(33, 17)) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    err = (rng.normal(size=g.shape) * 1e-3).astype(np.float32)
    rc, rs, re = rcomp.quantize_leaf(jnp.asarray(g), jnp.asarray(err))
    tc, ts, te = compression.quantize_leaf(torch.from_numpy(g),
                                           torch.from_numpy(err))
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(float(ts), float(rs), rtol=1e-7)
    np.testing.assert_allclose(te.numpy(), np.asarray(re), rtol=1e-6,
                               atol=1e-7 * float(rs))
    np.testing.assert_allclose(
        compression.dequantize_leaf(tc, ts).numpy(),
        np.asarray(rcomp.dequantize_leaf(rc, rs)), rtol=1e-7)


def test_quantize_all_zero_leaf():
    tc, ts, te = compression.quantize_leaf(torch.zeros(4), torch.zeros(4))
    assert float(ts) == pytest.approx(1e-12 / 127.0)
    assert not tc.any() and not te.any()


def test_compress_grads_over_steps_matches_reference():
    """Three steps of the round trip with error feedback carried."""
    grads0 = _tree(7, bf16=True)
    r_err = rcomp.init_error(_to_jax(grads0))
    t_err = compression.init_error(_to_torch(grads0))
    for i in range(3):
        g = _tree(30 + i, bf16=True)
        r_deq, r_err = rcomp.compress_grads(_to_jax(g), r_err)
        t_deq, t_err = compression.compress_grads(_to_torch(g), t_err)
        assert all(x.dtype == torch.float32 for x in tree_leaves(t_deq))
        for a, b in zip(tree_leaves(t_deq), jax.tree.leaves(r_deq)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        for a, b in zip(tree_leaves(t_err), jax.tree.leaves(r_err)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("bf16", [False, True])
def test_compression_ratio_matches_reference(bf16):
    g = _tree(8, bf16)
    assert compression.compression_ratio(_to_torch(g)) == pytest.approx(
        rcomp.compression_ratio(_to_jax(g)), rel=1e-12)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-130m",
                                  "llava-next-mistral-7b", "whisper-tiny"])
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_stream_bit_identical(name, n_hosts):
    r_cfg, t_cfg = r_reduced(R_ARCHS[name]), reduced(ARCHS[name])
    for seed in (0, 3):
        rs = RStream(RDataConfig(4, 24, r_cfg.vocab, seed), r_cfg)
        ts = SyntheticLMStream(DataConfig(4, 24, t_cfg.vocab, seed), t_cfg)
        for step in (0, 1, 17):
            want, got = rs.global_batch(step), ts.global_batch(step)
            assert sorted(want) == sorted(got)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            for h in range(n_hosts):
                w, g = rs.host_slice(step, h, n_hosts), \
                    ts.host_slice(step, h, n_hosts)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
        r_it, t_it = rs.iterator(5, 0, n_hosts), ts.iterator(5, 0, n_hosts)
        for _ in range(3):
            w, g = next(r_it), next(t_it)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_stream_without_config_and_vlm_extras():
    dc = DataConfig(2, 8, 50)
    out = SyntheticLMStream(dc).global_batch(0)
    assert sorted(out) == ["targets", "tokens"]
    np.testing.assert_array_equal(out["targets"][:, :-1],
                                  out["tokens"][:, 1:])
    cfg = dataclasses.replace(reduced(ARCHS["llava-next-mistral-7b"]))
    assert SyntheticLMStream(dc, cfg).global_batch(0)["img_embeds"].shape \
        == (2, cfg.n_img_tokens, cfg.d_model)


@settings(max_examples=200, deadline=None)
@given(n=st.integers(0, 600), model=st.sampled_from([1, 2, 3, 4, 8, 16]),
       min_data=st.integers(1, 8))
def test_plan_elastic_mesh_matches_reference(n, model, min_data):
    got = plan_elastic_mesh(n, model_axis=model, min_data_axis=min_data)
    assert got == rft.plan_elastic_mesh(n, model_axis=model,
                                        min_data_axis=min_data)
    d, m = got
    assert m >= 1 and d >= 1
    if n >= 1:
        assert d * m <= max(n, 1)


@settings(max_examples=200, deadline=None)
@given(batch=st.integers(0, 4096),
       weights=st.lists(st.floats(0.01, 100.0), min_size=1, max_size=16))
def test_rebalanced_batch_split_matches_reference(batch, weights):
    got = rebalanced_batch_split(batch, weights)
    assert got == rft.rebalanced_batch_split(batch, weights)
    assert sum(got) == batch and all(x >= 0 for x in got)


def test_batch_weights_feed_the_split():
    times = [{0: 1.0, 1: 2.0, 2: 4.0}, {0: 1.2, 1: 2.2, 2: 4.4}]
    rm, tm = RMitigator([0, 1, 2]), StragglerMitigator([0, 1, 2])
    for t in times:
        rm.record(t)
        tm.record(t)
    assert tm.batch_weights() == rm.batch_weights()
    w = list(tm.batch_weights().values())
    assert rebalanced_batch_split(64, w) == \
        rft.rebalanced_batch_split(64, w)


def test_fault_tolerance_reexports_supervision():
    from repro_torch.engine import supervision
    for name in ("HeartbeatMonitor", "StragglerMitigator",
                 "StragglerPolicy"):
        assert getattr(tft, name) is getattr(supervision, name)
    assert sorted(tft.__all__) == sorted(rft.__all__)
