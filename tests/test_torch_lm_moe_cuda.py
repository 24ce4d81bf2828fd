"""The blocked matmul B2 on the card: each of its three routes (splitk,
sm90, fma) against its plain version, bit for bit over two launches, the
wrapper's refusals, and its launches, by route, through a MoE prefill and
decode.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor the reference, so it also runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_moe_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.epilogue import EpilogueSpec
from repro_torch.engine import compile_lm
from repro_torch.kernels.matmul_blocked import (MatmulSchedule, _route,
                                                matmul_blocked, matmul_plain,
                                                pad_operands)
from repro_torch.kernels.ops import attention_probs, dense_softmax
from repro_torch.models.lm import model as TM

pytestmark = pytest.mark.cuda

# probabilities: fp32 logits summed in another order, then the same exp
# and normalisation (rtol 1e-4 / atol 1e-6, with router-scale logits of
# order 1); other outputs: fp32 sums of up to 1,024 terms of order 1 in
# another order (1e-4); a bf16 output is the fp32 one rounded, within half
# a bf16 step (2^-8 relative: 8 significant bits) of it, under rtol 8e-3
PROB_TOL = dict(rtol=1e-4, atol=1e-6)
SUM_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = {True: dict(rtol=8e-3, atol=1e-6), False: dict(rtol=8e-3,
                                                           atol=1e-2)}
SPECS = {
    "identity": dict(),
    "softmax": dict(softmax=True),
    "scale_softmax": dict(scale=0.125, softmax=True),
    "causal_softmax": dict(mask="causal", softmax=True),
    "attention_tail": dict(scale=0.25, mask="causal", softmax=True),
    "scale_only": dict(scale=2.0),
    "causal_only": dict(mask="causal"),
    "scale_relu": dict(scale=0.5, relu=True),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ab(m, k, n, dtype, device, b_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, b_scale, size=(k, n)).astype(
        np.float32))
    return a.to(device=device, dtype=dtype), b.to(device=device, dtype=dtype)


def _plain(a, b, spec, n_valid=None, out_dtype=None):
    """The plain version on operands padded as the reference pads them."""
    m, n = a.shape[0], b.shape[1]
    ap, bp, s, nv = pad_operands(a, b, MatmulSchedule(), spec)
    return matmul_plain(ap, bp, schedule=s, epilogue=spec,
                        n_valid=n_valid or nv, out_dtype=out_dtype)[:m, :n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("m,k,n", [(100, 130, 60), (33, 257, 129),
                                   (4, 1024, 128), (256, 64, 300),
                                   (128, 128, 128)])
def test_kernel_matches_plain(card, dtype, name, m, k, n):
    spec = EpilogueSpec(**SPECS[name])
    # b scaled like a router (0.02 * sqrt(K) per logit) for a softmax, so
    # that the probabilities are not one-hot
    a, b = _ab(m, k, n, dtype, card,
               b_scale=0.02 if spec.softmax else 1.0)
    before = matmul_blocked.launches
    got = matmul_blocked(a, b, epilogue=spec, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert matmul_blocked.launches == before + 1
    want = _plain(a, b, spec, out_dtype=torch.float32)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    tol = PROB_TOL if spec.softmax else SUM_TOL
    torch.testing.assert_close(got, want, **tol)
    # in the operands' own type
    got = matmul_blocked(a, b, epilogue=spec)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        tol = BF16_TOL[spec.softmax]
    torch.testing.assert_close(got.float(), want, **tol)


def test_padded_operands_with_n_valid_equal_unpadded(card):
    """The kernel on operands padded to 128 columns with n_valid equals
    the kernel on the unpadded ones, and the plain version on the padded
    ones; the padded columns get probability 0."""
    a, b = _ab(70, 200, 50, torch.float32, card, b_scale=0.05)
    spec = EpilogueSpec(scale=0.5, softmax=True)
    ap, bp, _, nv = pad_operands(a, b, MatmulSchedule(), spec)
    assert nv == 50
    got = matmul_blocked(ap, bp, epilogue=spec, n_valid=nv)
    flat = matmul_blocked(a, b, epilogue=spec)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:70, :50], flat, **PROB_TOL)
    assert torch.all(got[:, 50:] == 0)
    torch.testing.assert_close(got[:70, :50], _plain(a, b, spec), **PROB_TOL)


@pytest.mark.parametrize("m", [2048, 4, 1])
def test_router_shapes(card, m):
    """dense_softmax at arctic-480b's router shapes, fp32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        x, w = _ab(m, 7168, 128, dtype, card, b_scale=0.02, seed=m)
        got = dense_softmax(x.float(), w.float())
        want = _plain(x.float(), w.float(), EpilogueSpec(softmax=True))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **PROB_TOL)
        torch.testing.assert_close(got.sum(-1), torch.ones(m, device=card))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_probs(card, causal):
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn((512, 128), generator=g).to(card) for _ in range(2))
    got = attention_probs(q, k, causal=causal)
    spec = EpilogueSpec(scale=128 ** -0.5,
                        mask="causal" if causal else "none", softmax=True)
    want = _plain(q, k.t().contiguous(), spec)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **PROB_TOL)


def test_wrapper_rejects_what_the_kernel_cannot_take(card):
    a, b = _ab(8, 16, 24, torch.float32, card)
    with pytest.raises(TypeError, match="share"):
        matmul_blocked(a, b.bfloat16())
    with pytest.raises(TypeError, match="share"):
        matmul_blocked(a.double(), b.double())
    with pytest.raises(TypeError, match="out_dtype"):
        matmul_blocked(a, b, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_blocked(a, b.t().contiguous().t())
    with pytest.raises(ValueError, match="expected"):
        matmul_blocked(a, b[:15])
    with pytest.raises(ValueError, match="is on"):
        matmul_blocked(a, b.cpu())
    with pytest.raises(ValueError, match="n_valid"):
        matmul_blocked(a, b, epilogue=EpilogueSpec(softmax=True), n_valid=25)


@pytest.mark.parametrize("name", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_router_launches_per_prefill_and_decode_step(card, name):
    """One B2 launch per layer per prefill and per decode step; the card
    matches the CPU."""
    cfg = reduced(ARCHS[name])
    params = TM.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 21)))
    before = matmul_blocked.launches
    cache, logits = TM.prefill(TM.params_to(params, card), cfg,
                               toks.to(card), max_len=32)
    torch.cuda.synchronize()
    assert matmul_blocked.launches - before == cfg.n_layers
    _, want = TM.prefill(params, cfg, toks, max_len=32)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
    before = matmul_blocked.launches
    TM.decode_step(TM.params_to(params, card), cfg, toks[:, :1].to(card),
                   cache, 21)
    assert matmul_blocked.launches - before == cfg.n_layers
    sess = compile_lm(cfg, max_len=32, params=TM.params_to(params, card))
    before = matmul_blocked.launches
    out = sess.generate(toks[:1, :13].numpy(), 4)   # bucket 8 + 5 catch-up
    assert matmul_blocked.launches - before == cfg.n_layers * (1 + 5 + 3)
    assert out.shape == (1, 4) and 0 <= out.min() and out.max() < cfg.vocab


ROUTER_K = 7168          # arctic-480b's and kimi-k2's d_model
U = 2.0 ** -24


def _by_route(fn):
    """fn's result and the launches it made on each route."""
    before = dict(matmul_blocked.launches_by_route)
    out = fn()
    return out, {r: n - before[r]
                 for r, n in matmul_blocked.launches_by_route.items()
                 if n != before[r]}


@pytest.mark.parametrize("n", [128, 384])
@pytest.mark.parametrize("m", [1, 4, 16, 63, 64, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_each_route_matches_plain_bit_for_bit_twice(card, dtype, m, n):
    """arctic-480b's (N = 128) and kimi-k2's (N = 384) routers at decode
    and prefill row counts on the route the wrapper names: splitk below
    64 rows, sm90 for bf16 at 64 and more, fma for fp32 there.  Two
    launches on the same inputs are bit-identical (fixed-order sums)."""
    a, b = _ab(m, ROUTER_K, n, dtype, card, b_scale=0.02, seed=m)
    spec = EpilogueSpec(softmax=True)
    route = _route(m, ROUTER_K, n, dtype)
    assert route == ("splitk" if m < 64 else
                     "sm90" if dtype == torch.bfloat16 else "fma")
    (got, again), launched = _by_route(lambda: [
        matmul_blocked(a, b, epilogue=spec, out_dtype=torch.float32)
        for _ in range(2)])
    torch.cuda.synchronize()
    assert launched == {route: 2}
    assert torch.equal(got, again)
    torch.testing.assert_close(got, _plain(a, b, spec,
                                           out_dtype=torch.float32),
                               **PROB_TOL)


@pytest.mark.parametrize("k", [72, 1000, ROUTER_K])
@pytest.mark.parametrize("n", [64, 128, 200, 256, 384, 512])
def test_sm90_descriptors_and_k_tails(card, n, k):
    """The tensor-core route's MN-major b descriptors over one to eight
    64-column panels (one or two consumers, a ragged last panel at 200),
    K tails that TMA fills with zeros (72, 1,000), and ragged rows (130):
    the identity tail within the fp64 bound K * 2^-24 * (|a| @ |b|), the
    attention tail against plain."""
    a, b = _ab(130, k, n, torch.bfloat16, card, seed=k + n)
    got, launched = _by_route(lambda: matmul_blocked(
        a, b, out_dtype=torch.float32))
    assert launched == {"sm90": 1}
    a64, b64 = a.double(), b.double()
    bound = k * U * (a64.abs() @ b64.abs())
    torch.cuda.synchronize()
    assert ((got.double() - a64 @ b64).abs() <= bound).all()
    spec = EpilogueSpec(**SPECS["attention_tail"])
    a, b = _ab(130, k, n, torch.bfloat16, card, b_scale=0.02, seed=k)
    got = matmul_blocked(a, b, epilogue=spec, out_dtype=torch.float32)
    torch.testing.assert_close(got, _plain(a, b, spec,
                                           out_dtype=torch.float32),
                               **PROB_TOL)


def test_split_routes_refuse_unaligned_operands(card):
    """TMA and bulk copies need 16-byte aligned rows: a view that starts
    mid-row is refused, not sent to another kernel."""
    a, b = _ab(4, 64, 64, torch.bfloat16, card)
    off = torch.empty(4 * 64 + 1, dtype=torch.bfloat16, device=card)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        matmul_blocked(off.view(4, 64).copy_(a), b)
    big = torch.empty(64 * 64 + 1, dtype=torch.bfloat16, device=card)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        matmul_blocked(big.view(64, 64), b)


def test_router_routes_per_prefill_and_decode_step(card):
    """A bf16 MoE model's routers on the card: every prefill launch takes
    sm90, every decode-step launch splitk."""
    cfg = dataclasses.replace(reduced(ARCHS["arctic-480b"]),
                              dtype="bfloat16")
    params = TM.params_to(TM.init_params(cfg, seed=0, device="cpu"), card)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 40))).to(card)          # 80 rows >= 64
    (cache, logits), launched = _by_route(
        lambda: TM.prefill(params, cfg, toks, max_len=48))
    assert launched == {"sm90": cfg.n_layers}
    _, launched = _by_route(lambda: TM.decode_step(
        params, cfg, toks[:, :1], cache, 40))
    torch.cuda.synchronize()
    assert launched == {"splitk": cfg.n_layers}
    assert torch.isfinite(logits).all()
