"""Port parity: the LM kernels' plain versions, B3 and B4.

(a) B3's plain version (``kernels/flash_attention.py``, the version a CPU
    tensor takes) against the reference's ``flash_attention_xla``,
    ``gqa_attention_ref`` and ``flash_attention_pallas`` in interpret mode,
    over the reference's own cases (``tests/test_kernels_matmul_attention``)
    plus ragged S, and the head dims only its sm90 route takes (80, 112),
    in fp32 and bf16; and the rule that picks the route (``_route``).
    Tolerance rtol = atol = 1e-5 against the XLA loop (the same chunked
    sums in fp32, in another library) and 1e-4 against the dense oracle
    and the Pallas kernel, as the reference holds them; 1e-2 for bf16.
(b) B4's plain version against ``ssd_intra_pallas`` in interpret mode and
    ``ssd_intra_ref``, and the port's ``ssd_chunked`` (which runs B4's
    plain version on the CPU) against the reference's, ragged T included.
    Tolerance 1e-4 as the reference's own test (sums of up to Q * N terms
    in another order), 2e-4 through the whole chunked path.

The kernels themselves run only on the card: ``tests/test_torch_lm_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import gqa_attention_ref as r_gqa
from repro.kernels.ssd_chunk import ssd_intra_pallas, ssd_intra_ref as r_ssd
from repro.models.lm.layers import flash_attention_xla
from repro.models.lm.ssm import ssd_chunked as r_ssd_chunked
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.kernels.ref import gqa_attention_ref, ssd_intra_ref
from repro_torch.models.lm.ssm import ssd_chunked

XLA_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(rng, b, hq, hkv, s, d):
    return [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# (a) B3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 40)])
@pytest.mark.parametrize("s,cq,ckv", [(96, 32, 32), (100, 32, 64),
                                      (64, 128, 128), (77, 16, 32)])
def test_plain_matches_xla_loop(causal, window, s, cq, ckv, rng):
    """The reference's flash_attention_xla cases (ragged S against the
    chunk sizes included), with the same chunks."""
    q, k, v = _qkv(rng, 2, 4, 2, s, 16)
    want = flash_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window, q_chunk=cq,
                               kv_chunk=ckv)
    got = fa.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             q_chunk=cq, kv_chunk=ckv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **XLA_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        r_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
              window=window)), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96)])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (8, 1)])
def test_plain_matches_pallas_kernel(causal, window, hq, hkv, rng):
    """The reference's flash_attention_pallas cases, the Pallas kernel in
    interpret mode."""
    q, k, v = _qkv(rng, 2, hq, hkv, 128, 32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, bq=64, bkv=64)
    got = fa.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,window", [(1, 0), (13, 0), (130, 0), (130, 7)])
def test_plain_ragged_s_default_chunks(s, window, rng):
    """Any S with the config's default chunks (1024): the path the CPU
    prefill takes; D = 128 as qwen2-1.5b's heads, GQA 6:1."""
    q, k, v = _qkv(rng, 1, 12, 2, s, 128)
    want = r_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 window=window)
    got = fa.flash_attention(*_t(q, k, v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_keeps_bf16(rng):
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(rng, 1, 4, 2, 33, 16)))
    got = fa.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = gqa_attention_ref(q.float(), k.float(), v.float())
    # bf16 inputs, fp32 inside, one bf16 rounding of an O(1) output
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_port_gqa_oracle_matches_reference(causal, window, rng):
    q, k, v = _qkv(rng, 2, 6, 3, 21, 16)
    want = r_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal, window=window)
    got = gqa_attention_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **XLA_TOL)


# bf16 inputs on both sides, fp32 inside, one bf16 rounding of an O(1)
# output each (as test_plain_keeps_bf16)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _as(dtype, arrays):
    """The same numpy inputs for both packages: rounded to ``dtype`` once
    (in torch), then handed to torch and, as exact fp32, to JAX."""
    ts = [torch.from_numpy(a).to(dtype) for a in arrays]
    js = [jnp.asarray(t.float().numpy()) for t in ts]
    if dtype == torch.bfloat16:
        js = [j.astype(jnp.bfloat16) for j in js]
    return ts, js


def _close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        **(BF16_TOL if dtype == torch.bfloat16 else XLA_TOL))


@pytest.mark.parametrize("dtype,d,want", [
    *[(torch.bfloat16, d, "sm90") for d in (16, 80, 112, 128, 256)],
    *[(torch.float32, d, "fma") for d in (16, 64, 80, 112, 128, 256)]])
def test_route_takes(dtype, d, want):
    """Both routes take any D that is a multiple of 16 up to 256
    (kimi-k2's 112, stablelm-3b's 80): bf16 goes to the tensor-core
    kernel, fp32 to the FMA kernel."""
    assert fa._route(dtype, d) == want


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 8), (torch.bfloat16, 40), (torch.bfloat16, 264),
    (torch.float32, 40), (torch.float32, 264)])
def test_route_refuses_head_dim(dtype, d):
    with pytest.raises(ValueError, match="head dim"):
        fa._route(dtype, d)


def test_route_refuses_dtype():
    with pytest.raises(TypeError, match="share"):
        fa._route(torch.float16, 128)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 112])
def test_plain_matches_xla_loop_new_head_dims(d, dtype, causal, window,
                                              rng):
    """The sm90 route's new head dims (stablelm-3b's 80, kimi-k2's 112)
    through the plain version against flash_attention_xla at a ragged S,
    with the same chunks."""
    (q, k, v), (jq, jk, jv) = _as(dtype, _qkv(rng, 1, 4, 2, 100, d))
    want = flash_attention_xla(jq, jk, jv, causal=causal, window=window,
                               q_chunk=32, kv_chunk=64)
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_chunk=32, kv_chunk=64)
    assert got.dtype == dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 112])
def test_plain_matches_pallas_kernel_new_head_dims(d, dtype, causal, window,
                                                   rng):
    """The same head dims against flash_attention_pallas in interpret mode,
    at an S that its blocks divide."""
    (q, k, v), (jq, jk, jv) = _as(dtype, _qkv(rng, 1, 4, 2, 128, d))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  bq=64, bkv=64)
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        **(BF16_TOL if dtype == torch.bfloat16 else TOL))


def test_flash_cpu_tensor_takes_plain_version(rng):
    before = fa.flash_attention.launches
    q, k, v = _t(*_qkv(rng, 1, 2, 1, 9, 16))
    got = fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before
    torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v),
                               rtol=0, atol=0)


def test_flash_other_devices_raise():
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# (b) B4
# ---------------------------------------------------------------------------

def _ssd_case(rng, bcn, h, q, n, p, steps=(0.01, 0.5)):
    """Random B4 operands; ``steps`` bounds the per-position log-decay
    step -dt*A (None: no decay, acum = 0)."""
    cc = rng.normal(size=(bcn, q, n)).astype(np.float32)
    bc = rng.normal(size=(bcn, q, n)).astype(np.float32)
    acum = (np.zeros((bcn, h, q)) if steps is None else -np.cumsum(
        rng.uniform(*steps, size=(bcn, h, q)), axis=-1)).astype(np.float32)
    xd = rng.normal(size=(bcn, h, q, p)).astype(np.float32)
    return cc, bc, acum, xd


@pytest.mark.parametrize("q,n,p,h,bcn", [
    (8, 4, 4, 2, 3), (16, 8, 8, 3, 2), (32, 16, 8, 1, 1), (8, 16, 16, 8, 4),
])
def test_ssd_plain_matches_pallas_and_oracle(q, n, p, h, bcn, rng):
    """The reference's own cases, plus the reduced config's chunk
    (Q = 8, N = 16, P = 16, H = 8)."""
    arrays = _ssd_case(rng, bcn, h, q, n, p)
    want = ssd_intra_pallas(*(jnp.asarray(a) for a in arrays))
    got = sc.ssd_intra(*_t(*arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        r_ssd(*(jnp.asarray(a) for a in arrays))), **TOL)
    np.testing.assert_allclose(ssd_intra_ref(*_t(*arrays)).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("steps", [(1e-3, 2e-2), None])
def test_ssd_plain_matches_pallas_slow_decay(steps, rng):
    """Decay steps in Mamba-2's dt*A range, and none at all: every column
    of the chunk, the farthest included, adds well above the tolerance
    (checked below), so a wrong far column cannot hide under it."""
    q, n, p, h, bcn = 64, 8, 4, 2, 1
    arrays = _ssd_case(rng, bcn, h, q, n, p, steps)
    want = np.asarray(ssd_intra_pallas(*(jnp.asarray(a) for a in arrays)))
    got = sc.ssd_intra(*_t(*arrays)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the same block without the columns 32 or more positions back
    cc, bc, acum, xd = _t(*arrays)
    i = torch.arange(q)
    far = (i[:, None] - i[None, :]) >= 32
    ell = torch.where(far | (i[None, :] > i[:, None]), 0.0,
                      torch.exp(acum[..., :, None] - acum[..., None, :]))
    near = ((cc @ bc.transpose(-1, -2))[:, None] * ell) @ xd
    assert np.abs(near.numpy() - want).max() > 100 * TOL["atol"]


@pytest.mark.parametrize("t,chunk,with_state", [
    (16, 16, False), (32, 8, False), (29, 8, True), (5, 8, False)])
def test_ssd_chunked_matches_reference(t, chunk, with_state, rng):
    """The port's chunked SSD (intra-chunk block through B4's plain
    version, then the torch inter-chunk recurrence) against the
    reference's: several chunks, ragged T (dt = 0 padding), a carried-in
    state, and T below one chunk."""
    bsz, h, p, n = 2, 3, 4, 5
    x = rng.normal(size=(bsz, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, size=(bsz, t, h)).astype(np.float32)
    a_log = rng.normal(size=(h,)).astype(np.float32)
    b = rng.normal(size=(bsz, t, n)).astype(np.float32)
    c = rng.normal(size=(bsz, t, n)).astype(np.float32)
    s0 = (rng.normal(size=(bsz, h, p, n)).astype(np.float32)
          if with_state else None)
    y_r, s_r = r_ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, b, c)),
                             chunk=chunk,
                             init_state=None if s0 is None
                             else jnp.asarray(s0))
    y_t, s_t = ssd_chunked(*_t(x, dt, a_log, b, c), chunk=chunk,
                           init_state=None if s0 is None
                           else torch.from_numpy(s0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), rtol=2e-4,
                               atol=2e-4)


def test_ssd_cpu_tensor_takes_plain_version(rng):
    before = sc.ssd_intra.launches
    args = _t(*_ssd_case(rng, 2, 2, 8, 4, 4))
    got = sc.ssd_intra(*args)
    assert sc.ssd_intra.launches == before
    torch.testing.assert_close(got, sc.ssd_intra_plain(*args), rtol=0, atol=0)


def test_ssd_other_devices_raise():
    cc = torch.empty((1, 8, 4), device="meta")
    xd = torch.empty((1, 2, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no SSD kernel"):
        sc.ssd_intra(cc, cc, torch.empty((1, 2, 8), device="meta"), xd)


@pytest.mark.parametrize("name,symbol", [
    ("flash_attention", "flash_attention_launch"),
    pytest.param("ssd_chunk_sm90", "ssd_intra_launch",
                 id="ssd_chunk-ssd_intra_launch")])
def test_kernel_sources_ship_with_the_package(name, symbol):
    src = (kbuild.CSRC / f"{name}.cu").read_text()
    assert f'extern "C" int {symbol}' in src
    assert "Replaces:" in src and "What bounds it on the H100" in src
