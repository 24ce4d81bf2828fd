"""Port parity: the training loss path — ``models/lm/model.py::loss_fn``
(with the MoE aux loss, remat and the per-layer unbinding) and
``rglru.linear_scan`` out of place — against the reference on the CPU.

* ``loss_fn`` of every family (reduced; the reference's parameters carried
  across by ``lm_params_from_numpy``) against
  ``jax.value_and_grad(repro.models.lm.model.loss_fn)``: the loss, ce and
  aux within rtol 1e-5, each gradient leaf within 1e-4 of its largest
  value (fp32 sums in another order through two layers) plus 1e-5 of the
  largest gradient of all (a leaf whose exact gradient is 0, such as a key
  bias under the softmax, holds rounding noise only); a leaf the loss
  does not reach gets the reference's zero gradient.
* Remat (``full`` and ``dots``) gives the gradients of the plain forward
  bit for bit (the recompute repeats the same CPU arithmetic).
* The training forward gives the inference forward's logits bit for bit.

The trainer (``launch/train.py``) is ``tests/test_torch_train_main.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS, reduced as r_reduced
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticLMStream as RStream
from repro.models.lm import model as RM
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import lm_params_from_numpy
from repro_torch.models.lm import model as TM
from repro_torch.models.lm.rglru import linear_scan
from repro_torch.optim.adamw import tree_leaves, tree_map


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and under the
    suite's parallel workers a pool of threads a worker oversubscribes
    the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one config of each family, and kimi-k2 (moe with a shared expert the
# reference's tree never runs: a zero gradient)
FAMILIES = ("qwen2-1.5b", "arctic-480b", "kimi-k2-1t-a32b", "mamba2-130m",
            "recurrentgemma-2b", "whisper-tiny", "llava-next-mistral-7b")


def _setup(name, seed=0, **overrides):
    r_cfg = dataclasses.replace(r_reduced(R_ARCHS[name]), **overrides)
    t_cfg = dataclasses.replace(reduced(ARCHS[name]), **overrides)
    r_p = RM.init_params(r_cfg, jax.random.PRNGKey(seed))
    return r_cfg, t_cfg, r_p, lm_params_from_numpy(r_p, "cpu")


def _batch(cfg, batch=2, seq=16, step=3):
    return RStream(RDataConfig(batch, seq, cfg.vocab), cfg).global_batch(step)


@functools.lru_cache(maxsize=None)
def _r_value_and_grad():
    return jax.jit(jax.value_and_grad(RM.loss_fn, has_aux=True),
                   static_argnums=1)


def _t_value_and_grad(params, cfg, batch):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, parts = TM.loss_fn(live, cfg, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    loss.backward()
    return loss, parts, [p.grad for p in tree_leaves(live)]


def _assert_grads_close(got, want, rel=1e-4, floor=1e-5):
    """Each leaf within ``rel`` of its largest value plus ``floor`` of the
    largest gradient of all: a leaf whose exact gradient is 0 (a key bias
    under the softmax) holds rounding noise only."""
    assert len(got) == len(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g is None:
            assert not w.any()
            continue
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= rel * scale + floor * top, (err, scale, top)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_fn_matches_reference(name):
    r_cfg, t_cfg, r_p, t_p = _setup(name)
    batch = _batch(r_cfg)
    (r_loss, r_parts), r_grads = _r_value_and_grad()(
        r_p, r_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, parts, grads = _t_value_and_grad(t_p, t_cfg, batch)
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(parts[k].item(), float(r_parts[k]),
                                   rtol=1e-5, atol=1e-7)
    if t_cfg.family == "moe":
        assert parts["aux"].item() > 0
    _assert_grads_close(grads, jax.tree.leaves(r_grads))


def test_loss_fn_masks_negative_targets():
    """Targets below 0 are left out of the mean; a vlm is scored on its
    text positions only."""
    for name in ("qwen2-1.5b", "llava-next-mistral-7b"):
        r_cfg, t_cfg, r_p, t_p = _setup(name)
        batch = _batch(r_cfg)
        batch["targets"][0, ::3] = -1
        batch["targets"][1, :] = -5
        (r_loss, _), r_grads = _r_value_and_grad()(
            r_p, r_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
        loss, _, grads = _t_value_and_grad(t_p, t_cfg, batch)
        np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-5)
        _assert_grads_close(grads, jax.tree.leaves(r_grads))


@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-130m",
                                  "recurrentgemma-2b", "arctic-480b"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(name, policy):
    cfg = reduced(ARCHS[name])
    params = TM.init_params(cfg, 1, "cpu")
    batch = _batch(cfg, step=5)
    loss, _, grads = _t_value_and_grad(params, cfg, batch)
    rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    r_loss, _, r_grads = _t_value_and_grad(params, rcfg, batch)
    assert r_loss.item() == loss.item()
    for g, w in zip(r_grads, grads):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


def test_remat_recomputes_each_layer_under_checkpoint():
    """With remat the layer's forward runs twice: once forward, once in
    the backward's recompute (the kernel launches twice on the card)."""
    cfg = dataclasses.replace(reduced(ARCHS["mamba2-130m"]), remat=True)
    params = TM.init_params(cfg, 0, "cpu")
    calls = []
    real = TM.ssm.mamba2_layer

    def spy(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*a, **kw)
    TM.ssm.mamba2_layer = spy
    try:
        _t_value_and_grad(params, cfg, _batch(cfg))
        n_grad = len(calls)
        with torch.no_grad():
            TM.forward(params, cfg, torch.zeros((1, 8), dtype=torch.long))
    finally:
        TM.ssm.mamba2_layer = real
    assert n_grad == 2 * cfg.n_layers
    assert len(calls) == 3 * cfg.n_layers


def test_layers_unbound_under_autograd_indexed_otherwise():
    """Without autograd the unbound slices are the views of the stack that
    indexing gives; under it each carries an unbind's backward."""
    cfg = reduced(ARCHS["qwen2-1.5b"])
    params = TM.init_params(cfg, 0, "cpu")
    plain = [lp["attn"]["wq"] for lp in TM._layers(params, cfg)]
    assert all(t.grad_fn is None and t._base is params["layers"]["attn"]
               ["wq"] for t in plain)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    bound = [lp["attn"]["wq"] for lp in TM._layers(live, cfg)]
    assert all(type(t.grad_fn).__name__.startswith("UnbindBackward")
               for t in bound)
    for a, b in zip(plain, bound):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "recurrentgemma-2b",
                                  "arctic-480b"])
def test_forward_with_grad_equals_inference(name):
    """The training forward (unbound leaves, the out-of-place scan, the
    Functions) gives the inference forward's logits bit for bit."""
    cfg = reduced(ARCHS[name])
    params = TM.init_params(cfg, 2, "cpu")
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    with torch.no_grad():
        want = TM.forward(params, cfg, toks)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    got = TM.forward(live, cfg, toks)
    assert got.requires_grad
    assert torch.equal(got.detach(), want)


def test_linear_scan_out_of_place_matches_in_place_and_recurrence():
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 37, 5), generator=g)
    b = torch.randn((2, 37, 5), generator=g)
    want = linear_scan(a.clone(), b.clone())
    al, bl = a.clone().requires_grad_(), b.clone().requires_grad_()
    got = linear_scan(al, bl)
    assert torch.equal(got.detach(), want)
    assert torch.equal(al.detach(), a)          # inputs not written
    ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
    h, hs = torch.zeros(2, 5), []
    for t in range(37):
        h = ar[:, t] * h + br[:, t]
        hs.append(h)
    dh = torch.randn((2, 37, 5), generator=g)
    ga = torch.autograd.grad(got, (al, bl), dh)
    gr = torch.autograd.grad(torch.stack(hs, 1), (ar, br), dh)
    for x, y in zip(ga, gr):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
