"""Port parity: the backward passes of the LM kernels, B2, B3 and B4.

Where autograd records, each kernel's wrapper runs through a
``torch.autograd.Function`` on every device (``FlashAttentionFn``,
``SSDIntraFn``, ``MatmulSoftmaxFn``): on the CPU its forward is the plain
version and its backward the same analytic torch code the card runs.  The
reference has no backward kernel: its gradients are ``jax.grad`` of its
plain functions, which these tests take as the oracle.

* B3 against ``jax.grad`` of ``flash_attention_xla`` over the five forms
  on the training paths (causal, windowed with Sk >= S, non-causal, cross
  with Sk != S, GQA), fp32: rtol = atol = 1e-5 of values of order 1 (the
  same fp32 sums in another order and library); bf16 inputs against the
  fp32 gradient within 3e-2 of the largest (a few bf16 roundings).
* B4 against ``jax.grad`` of ``ssd_intra_ref`` (fp32, 1e-4 relative to
  the largest gradient: sums of up to Q * N terms in another order), and,
  with decays steep enough that ``exp`` overflows above the diagonal,
  against a JAX expression that masks before the exp (the reference's
  ``_segsum`` order): the port's gradients stay finite.
* B2's scale-then-softmax tail against ``jax.grad`` of
  ``softmax(scale * x @ w)`` (fp32, 1e-5; bf16 operands with fp32 output,
  the router's types, 1e-2 of the largest), and its other tails (and B1)
  raising ``NotImplementedError`` when grad is required.
* ``torch.autograd.gradcheck`` in fp64 on tiny shapes: the plain versions
  and the backwards compute in fp64 for fp64 inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ssd_intra_ref as r_ssd
from repro.models.lm.layers import flash_attention_xla
from repro_torch.core.epilogue import EpilogueSpec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.kernels.conv2d_nchwc import conv2d_nchwc
from repro_torch.kernels.matmul_blocked import (MatmulSchedule,
                                                matmul_blocked,
                                                matmul_padded)
from repro_torch.kernels.ops import attention_probs, dense_softmax


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and under the
    suite's parallel workers a pool of threads a worker oversubscribes
    the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# b, hq, hkv, s, sk, d, causal, window, q_chunk: the five forms
ATTN_FORMS = {
    "causal": (2, 4, 4, 24, 24, 16, True, 0, 16),
    "gqa": (1, 6, 2, 20, 20, 32, True, 0, 16),
    "window": (1, 4, 2, 33, 33, 16, True, 5, 16),
    "noncausal": (2, 3, 3, 17, 17, 16, False, 0, 16),
    "cross": (2, 4, 2, 5, 19, 16, False, 0, 4),
}
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _attn_inputs(seed, b, hq, hkv, s, sk, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    do = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    return q, k, v, do


def _jax_attn_grads(q, k, v, do, causal, window, q_chunk):
    def f(q, k, v):
        out = flash_attention_xla(q, k, v, causal=causal, window=window,
                                  q_chunk=q_chunk, kv_chunk=q_chunk)
        return jnp.sum(out * do)
    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _torch_attn_grads(q, k, v, do, causal, window, q_chunk, dtype):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal, window=window,
                             q_chunk=q_chunk, kv_chunk=q_chunk)
    out.backward(torch.tensor(do, dtype=dtype))
    return out, [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("form", sorted(ATTN_FORMS))
def test_b3_backward_matches_jax_grad(form):
    b, hq, hkv, s, sk, d, causal, window, qc = ATTN_FORMS[form]
    q, k, v, do = _attn_inputs(0, b, hq, hkv, s, sk, d)
    want = _jax_attn_grads(q, k, v, do, causal, window, qc)
    out, got = _torch_attn_grads(q, k, v, do, causal, window, qc,
                                 torch.float32)
    assert out.requires_grad
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("form", ("causal", "window", "cross"))
def test_b3_backward_bf16(form):
    """bf16 q, k, v (the sm90 route's type on the card): gradients in
    bf16, within 3e-2 of the largest fp32 gradient."""
    b, hq, hkv, s, sk, d, causal, window, qc = ATTN_FORMS[form]
    q, k, v, do = _attn_inputs(1, b, hq, hkv, s, sk, d)
    bf = [torch.tensor(a).bfloat16().float().numpy() for a in (q, k, v, do)]
    want = _jax_attn_grads(*bf, causal, window, qc)
    _, got = _torch_attn_grads(*bf, causal, window, qc, torch.bfloat16)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 3e-2 * np.abs(w).max()


def test_b3_backward_counts_calls_by_route():
    before = dict(fa.flash_attention.backward_calls)
    launches = fa.flash_attention.launches
    q, k, v, do = _attn_inputs(2, 1, 2, 2, 8, 8, 16)
    _torch_attn_grads(q, k, v, do, True, 0, 4, torch.float32)
    after = fa.flash_attention.backward_calls
    assert after["plain"] == before["plain"] + 1
    assert (after["sm90"], after["fma"]) == (before["sm90"], before["fma"])
    assert fa.flash_attention.launches == launches     # no kernel here


def test_b3_takes_the_function_only_where_autograd_records():
    q, k, v, _ = _attn_inputs(3, 1, 2, 2, 8, 8, 16)
    ts = [torch.tensor(a) for a in (q, k, v)]
    assert fa.flash_attention(*ts).grad_fn is None
    ts[1].requires_grad_()
    with torch.no_grad():
        assert fa.flash_attention(*ts).grad_fn is None
    out = fa.flash_attention(*ts)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    # the Function's forward is the plain version's, bit for bit
    torch.testing.assert_close(out.detach(), fa.flash_attention_plain(
        *[t.detach() for t in ts]), rtol=0, atol=0)


def _ssd_inputs(seed, bcn, h, q, n, p, steep=False):
    rng = np.random.default_rng(seed)
    cc = rng.normal(size=(bcn, q, n)).astype(np.float32)
    bc = rng.normal(size=(bcn, q, n)).astype(np.float32)
    lo, hi = (2.0, 6.0) if steep else (1e-3, 0.2)
    acum = np.cumsum(-rng.uniform(lo, hi, size=(bcn, h, q)),
                     axis=-1).astype(np.float32)
    xd = rng.normal(size=(bcn, h, q, p)).astype(np.float32)
    dy = rng.normal(size=(bcn, h, q, p)).astype(np.float32)
    return cc, bc, acum, xd, dy


def _torch_ssd_grads(cc, bc, acum, xd, dy):
    ts = [torch.tensor(a, requires_grad=True) for a in (cc, bc, acum, xd)]
    sc.ssd_intra(*ts).backward(torch.tensor(dy))
    return [t.grad.numpy() for t in ts]


def _close_to_largest(got, want, rel):
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), \
            np.abs(g - w).max() / np.abs(w).max()


@pytest.mark.parametrize("shape", [(2, 3, 16, 8, 4), (1, 4, 64, 16, 16),
                                   (3, 2, 9, 5, 7)])
def test_b4_backward_matches_jax_grad(shape):
    cc, bc, acum, xd, dy = _ssd_inputs(0, *shape)

    def f(*a):
        return jnp.sum(r_ssd(*a) * dy)
    want = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (cc, bc, acum, xd)))
    _close_to_largest(_torch_ssd_grads(cc, bc, acum, xd, dy),
                      [np.asarray(w) for w in want], 1e-4)


def test_b4_backward_masks_before_the_exp():
    """Steep decays: exp(acum_i - acum_j) overflows above the diagonal.
    The reference's oracle exponentiates before it masks, so its gradient
    of acum is NaN there; the port's masks first, as the reference's
    ``_segsum`` does, and matches jax.grad of that order."""
    cc, bc, acum, xd, dy = _ssd_inputs(1, 2, 3, 64, 8, 4, steep=True)
    q = cc.shape[1]
    mask = np.tril(np.ones((q, q), bool))

    def masked_first(cc, bc, acum, xd):
        scores = jnp.einsum("gin,gjn->gij", cc, bc)
        diff = acum[..., :, None] - acum[..., None, :]
        ell = jnp.exp(jnp.where(mask, diff, -jnp.inf))
        return jnp.sum(jnp.einsum("gij,ghij,ghjp->ghip", scores, ell, xd)
                       * dy)
    args = [jnp.asarray(a) for a in (cc, bc, acum, xd)]
    r_acum = jax.grad(lambda *a: jnp.sum(r_ssd(*a) * dy), argnums=2)(*args)
    assert not np.isfinite(np.asarray(r_acum)).all()
    want = jax.grad(masked_first, argnums=(0, 1, 2, 3))(*args)
    _close_to_largest(_torch_ssd_grads(cc, bc, acum, xd, dy),
                      [np.asarray(w) for w in want], 1e-4)


def test_b4_backward_counts_calls_by_route():
    before = sc.ssd_intra.backward_calls["plain"]
    _torch_ssd_grads(*_ssd_inputs(2, 1, 2, 8, 4, 4))
    assert sc.ssd_intra.backward_calls["plain"] == before + 1
    assert sc.ssd_intra.backward_calls["sm90"] == 0


def _jax_softmax_grads(x, w, dp, scale):
    def f(x, w):
        z = x.astype(jnp.float32) @ w.astype(jnp.float32)
        if scale is not None:
            z = z * scale
        return jnp.sum(jax.nn.softmax(z, axis=-1) * dp)
    return [np.asarray(g, np.float32)
            for g in jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(w))]


@pytest.mark.parametrize("m,k,n,scale", [(12, 16, 8, None), (33, 24, 5, None),
                                         (7, 64, 128, 0.125)])
def test_b2_softmax_backward_matches_jax_grad(m, k, n, scale):
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    dp = rng.normal(size=(m, n)).astype(np.float32)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    spec = EpilogueSpec(scale=scale, softmax=True)
    p = matmul_padded(tx, tw, schedule=MatmulSchedule(), epilogue=spec)
    p.backward(torch.tensor(dp))
    for g, want in zip((tx.grad, tw.grad), _jax_softmax_grads(x, w, dp,
                                                              scale)):
        np.testing.assert_allclose(g.numpy(), want, **GRAD_TOL)


def test_b2_router_types_bf16_operands_fp32_output():
    """The router's call: bf16 x and w, fp32 probabilities; gradients in
    the operands' type."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(20, 32)), dtype=torch.bfloat16,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(32, 8)) * 0.1, dtype=torch.bfloat16,
                     requires_grad=True)
    dp = rng.normal(size=(20, 8)).astype(np.float32)
    probs = dense_softmax(x, w, out_dtype=torch.float32)
    assert probs.dtype == torch.float32
    probs.backward(torch.tensor(dp))
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    want = _jax_softmax_grads(x.detach().float().numpy(),
                              w.detach().float().numpy(), dp, None)
    for g, wnt in zip((x.grad, w.grad), want):
        assert np.abs(g.float().numpy() - wnt).max() <= 1e-2 * np.abs(
            wnt).max()


@pytest.mark.parametrize("tail", ["identity", "scale_only", "causal",
                                  "relu", "n_valid"])
def test_b2_other_tails_raise_when_grad_is_required(tail):
    a = torch.randn(16, 16, requires_grad=True)
    b = torch.randn(16, 16)
    specs = {"identity": EpilogueSpec(), "scale_only": EpilogueSpec(
        scale=0.5), "causal": EpilogueSpec(mask="causal", softmax=True),
        "relu": EpilogueSpec(relu=True), "n_valid": EpilogueSpec(
            softmax=True)}
    kw = {"n_valid": 12} if tail == "n_valid" else {}
    with pytest.raises(NotImplementedError, match="no backward"):
        matmul_blocked(a, b, schedule=MatmulSchedule(bm=16, bk=16, bn=16),
                       epilogue=specs[tail], **kw)
    if tail == "causal":
        with pytest.raises(NotImplementedError):
            attention_probs(a, b)
    # without grad the same calls run
    with torch.no_grad():
        matmul_blocked(a, b, schedule=MatmulSchedule(bm=16, bk=16, bn=16),
                       epilogue=specs[tail], **kw)


def test_b1_raises_when_grad_is_required():
    x = torch.randn(1, 1, 6, 6, 4, requires_grad=True)
    w = torch.randn(1, 1, 3, 3, 4, 4)
    with pytest.raises(NotImplementedError, match="no backward"):
        conv2d_nchwc(x, w)
    with torch.no_grad():
        assert conv2d_nchwc(x, w).shape == (1, 1, 4, 4, 4)
    assert conv2d_nchwc(x.detach(), w).grad_fn is None


def _f64(*shape):
    return torch.randn(*shape, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("form", sorted(ATTN_FORMS))
def test_gradcheck_b3(form):
    _, hq, hkv, s, sk, _, causal, window, _ = ATTN_FORMS[form]
    torch.manual_seed(0)
    hq, hkv = (2, 1) if hq > hkv else (1, 1)        # GQA kept where it was
    s, sk = (5, 7) if s != sk else (6, 6)
    q, k, v = _f64(1, hq, s, 4), _f64(1, hkv, sk, 4), _f64(1, hkv, sk, 4)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=causal,
                                           window=min(window, 3),
                                           q_chunk=4, kv_chunk=4),
        (q, k, v))


def test_gradcheck_b4():
    torch.manual_seed(1)
    acum = torch.cumsum(-torch.rand(1, 2, 6, dtype=torch.float64), -1)
    assert torch.autograd.gradcheck(
        sc.ssd_intra, (_f64(1, 6, 3), _f64(1, 6, 3),
                       acum.requires_grad_(), _f64(1, 2, 6, 4)))


@pytest.mark.parametrize("scale", [None, 0.5])
def test_gradcheck_b2(scale):
    torch.manual_seed(2)
    spec = EpilogueSpec(scale=scale, softmax=True)
    assert torch.autograd.gradcheck(
        lambda x, w: matmul_padded(x, w, epilogue=spec),
        (_f64(6, 5), _f64(5, 3)))
