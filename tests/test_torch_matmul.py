"""Port parity: the blocked matmul with its fused matmul tail (B2).

The port's plain version (``kernels/matmul_blocked.py::matmul_plain``,
reached on CPU tensors through ``matmul_blocked``, ``matmul_padded``,
``dense_softmax`` and ``attention_probs``) against the reference's Pallas
kernel run in interpret mode, over the tail specs and shapes of
``tests/test_lm_fused_epilogues.py``.  Both sum the same fp32 blocks in the
same k order, so the products agree bit for bit here; the softmax's exp
and row sum may round differently by an ulp or two: rtol 2e-6, atol 1e-6.

Against an fp64 product the bound grows with K: each fp32 dot product of
K terms is within K * u * (|a| @ |b|) of the exact one (u = 2^-24, any
summation order), times |scale|; a softmax turns a logit error d into a
relative error of at most exp(2 d) - 1 in each probability, plus the
rounding of its exp, sum (N terms) and division.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.epilogue import EpilogueSpec as REpilogueSpec
from repro.core.epilogue import apply_matmul_epilogue as r_apply
from repro.kernels.matmul_blocked import MatmulSchedule as RSchedule
from repro.kernels.matmul_blocked import matmul_padded as r_padded
from repro.kernels.matmul_blocked import matmul_pallas as r_pallas
from repro.kernels.ops import attention_probs as r_attention_probs
from repro.kernels.ops import dense_softmax as r_dense_softmax
from repro_torch.core.epilogue import (IDENTITY, NEG_INF, EpilogueSpec,
                                       apply_matmul_epilogue)
from repro_torch.kernels import attention_probs, dense_softmax
from repro_torch.kernels import build
from repro_torch.kernels.matmul_blocked import (MatmulSchedule, _route,
                                                matmul_blocked,
                                                matmul_padded, matmul_plain,
                                                pad_operands)

TOL = dict(rtol=2e-6, atol=1e-6)
U = 2.0 ** -24

SPECS = {
    "softmax": dict(softmax=True),
    "scale_softmax": dict(scale=0.125, softmax=True),
    "causal_softmax": dict(mask="causal", softmax=True),
    "attention_tail": dict(scale=0.25, mask="causal", softmax=True),
    "scale_only": dict(scale=2.0),
    "causal_only": dict(mask="causal"),
    "scale_relu": dict(scale=0.5, relu=True),
}
SHAPES = [(128, 128, 128), (96, 64, 80), (40, 32, 200)]


def _ab(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def fp64_reference(a, b, kw):
    """The tail on the fp64 product, and the elementwise error an fp32
    computation of it may carry (see the module docstring)."""
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    k = a64.shape[1]
    x = a64 @ b64
    err = k * U * (np.abs(a64) @ np.abs(b64))
    scale = kw.get("scale")
    if scale is not None:
        x, err = x * scale, err * abs(scale) + U * np.abs(x * scale)
    masked = np.zeros(x.shape, bool)
    if kw.get("mask") == "causal":
        masked = np.arange(x.shape[0])[:, None] < np.arange(x.shape[1])
        # NEG_INF as fp32 stores it: masked entries must match exactly
        x = np.where(masked, float(np.float32(NEG_INF)), x)
        err = np.where(masked, 0.0, err)
    if kw.get("softmax"):
        p = np.exp(x - x.max(-1, keepdims=True))
        x = p / p.sum(-1, keepdims=True)
        rel = np.expm1(2 * err.max(-1, keepdims=True)) \
            + (x.shape[1] + 4) * U
        err = x * rel
    if kw.get("relu"):
        x = np.maximum(x, 0.0)
    return x, err + 1e-30


def _within(got, want, err):
    bad = np.abs(np.asarray(got, np.float64) - want) > err
    assert not bad.any(), (f"{bad.sum()} elements beyond the bound; worst "
                           f"excess {(np.abs(got - want) - err).max()}")


# ---------------------------------------------------------------------------
# the plain version against the reference's kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("shape", SHAPES)
def test_padded_plain_matches_reference_kernel(name, shape):
    """matmul_padded on CPU tensors (pad, plain version over 32-blocks,
    slice) against the reference's matmul_padded in interpret mode,
    including the shapes whose padded softmax columns n_valid masks."""
    m, k, n = shape
    a, b = _ab(m, k, n)
    kw = SPECS[name]
    want = r_padded(jnp.asarray(a), jnp.asarray(b),
                    schedule=RSchedule(32, 32, 32),
                    epilogue=REpilogueSpec(**kw), interpret=True)
    got = matmul_padded(torch.from_numpy(a), torch.from_numpy(b),
                        schedule=MatmulSchedule(32, 32, 32),
                        epilogue=EpilogueSpec(**kw))
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("shape", SHAPES + [(33, 257, 129), (8, 1024, 16)])
def test_plain_within_fp64_bound(name, shape):
    m, k, n = shape
    a, b = _ab(m, k, n, seed=3)
    kw = SPECS[name]
    got = matmul_padded(torch.from_numpy(a), torch.from_numpy(b),
                        epilogue=EpilogueSpec(**kw)).numpy()
    want, err = fp64_reference(a, b, kw)
    _within(got, want, err)
    if kw.get("softmax"):
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_plain_blocks_match_reference_kernel_unpadded():
    """matmul_plain itself, at a schedule of uneven blocks, with an
    explicit n_valid and bf16 operands cast out to float32."""
    a, b = _ab(64, 96, 48, seed=5)
    spec = dict(scale=0.5, mask="causal", softmax=True)
    want = r_pallas(jnp.asarray(a), jnp.asarray(b),
                    schedule=RSchedule(16, 32, 48),
                    epilogue=REpilogueSpec(**spec), n_valid=40,
                    interpret=True)
    got = matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                       schedule=MatmulSchedule(16, 32, 48),
                       epilogue=EpilogueSpec(**spec), n_valid=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[:, 40:] == 0.0)
    abf = torch.from_numpy(a).bfloat16()
    bbf = torch.from_numpy(b).bfloat16()
    out = matmul_plain(abf, bbf, schedule=MatmulSchedule(16, 32, 48))
    assert out.dtype == torch.bfloat16
    out32 = matmul_plain(abf, bbf, schedule=MatmulSchedule(16, 32, 48),
                         out_dtype=torch.float32)
    torch.testing.assert_close(out32, abf.float() @ bbf.float(), rtol=1e-5,
                               atol=1e-4)


def test_dense_softmax_matches_reference():
    """The router / LM-head entry; vocab 50 forces the padded path."""
    x, w = _ab(8, 32, 50)
    want = r_dense_softmax(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = dense_softmax(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n", [(1, 64, 8), (18, 64, 8), (100, 130, 60)])
def test_dense_softmax_on_bf16_operands_with_fp32_out(m, k, n):
    """The bf16 model's router: bf16 operands, fp32 probabilities.  The
    plain version upcasts each k block, so the result is bit for bit that
    of the call on fp32 copies (what the router passed before), and it
    agrees with the reference's router, softmax(x.astype(f32) @
    w.astype(f32)), on the same bf16 values within TOL."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                         ).bfloat16()
    w = torch.from_numpy(rng.normal(0, 0.02 * 8, size=(k, n)).astype(
        np.float32)).bfloat16()
    got = dense_softmax(x, w, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, dense_softmax(x.float(), w.float()))
    xr = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    wr = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    want = jax.nn.softmax(xr.astype(jnp.float32) @ wr.astype(jnp.float32),
                          axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # without out_dtype the output keeps the operands' type
    assert dense_softmax(x, w).dtype == torch.bfloat16


@pytest.mark.parametrize("causal", [True, False])
def test_attention_probs_matches_reference(causal):
    """Scale defaults to 1/sqrt(D); S = 48 pads to one 128-block."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(48, 16)).astype(np.float32)
    k = rng.normal(size=(48, 16)).astype(np.float32)
    want = r_attention_probs(jnp.asarray(q), jnp.asarray(k), causal=causal,
                             interpret=True)
    got = attention_probs(torch.from_numpy(q), torch.from_numpy(k),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if causal:
        assert np.all(np.triu(got.numpy(), 1) == 0.0)


# ---------------------------------------------------------------------------
# the epilogue body, the spec, the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("row0,col0,n_valid", [(0, 0, None), (8, 8, None),
                                               (64, 0, None), (0, 32, 5),
                                               (16, 0, 3)])
def test_apply_matmul_epilogue_matches_reference(name, row0, col0, n_valid):
    """The shared body on one block at absolute (row0, col0)."""
    acc = np.random.default_rng(2).normal(size=(8, 8)).astype(np.float32)
    kw = SPECS[name]
    want = r_apply(jnp.asarray(acc), REpilogueSpec(**kw), row0=row0,
                   col0=col0, n_valid=n_valid)
    got = apply_matmul_epilogue(torch.from_numpy(acc), EpilogueSpec(**kw),
                                row0=row0, col0=col0, n_valid=n_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_matmul_epilogue_block_offsets():
    """row0/col0 place the causal mask correctly for an interior block."""
    acc = torch.zeros((4, 4))
    spec = EpilogueSpec(mask="causal")
    out = apply_matmul_epilogue(acc, spec, row0=8, col0=8)
    want = torch.where(torch.ones(4, 4, dtype=torch.bool).tril(), 0.0,
                       NEG_INF)
    assert torch.equal(out, want)
    out = apply_matmul_epilogue(acc, spec, row0=64, col0=0)
    assert torch.equal(out, torch.zeros(4, 4))


def test_spec_validation():
    with pytest.raises(ValueError):
        EpilogueSpec(mask="sliding")
    with pytest.raises(ValueError):
        EpilogueSpec(softmax=True, relu=True)
    with pytest.raises(ValueError):
        EpilogueSpec(softmax=True, concat_offset=0, concat_total=64)
    a = EpilogueSpec(scale=0.25, mask="causal", softmax=True)
    assert a == EpilogueSpec(scale=0.25, mask="causal", softmax=True)
    assert hash(a) == hash(EpilogueSpec(scale=0.25, mask="causal",
                                        softmax=True))
    assert a.has_matmul_tail and not IDENTITY.has_matmul_tail


def test_softmax_needs_single_n_block():
    a, b = (torch.from_numpy(t) for t in _ab(32, 32, 64))
    for fn in (matmul_plain, matmul_blocked):
        with pytest.raises(ValueError, match="one N-block"):
            fn(a, b, schedule=MatmulSchedule(32, 32, 32),
               epilogue=EpilogueSpec(softmax=True))
    with pytest.raises(ValueError, match="not divisible"):
        matmul_plain(a[:31], b, schedule=MatmulSchedule(32, 32, 64))


@pytest.mark.parametrize("triple", [(128, 128, 128), (32, 64, 16),
                                    (8, 256, 512)])
def test_schedule_matches_reference(triple):
    s, r = MatmulSchedule(*triple), RSchedule(*triple)
    assert s.vmem_bytes == r.vmem_bytes
    for shape in [(256, 256, 512), (96, 64, 80)]:
        try:
            r.validate(*shape)
        except ValueError:
            with pytest.raises(ValueError, match="not divisible"):
                s.validate(*shape)
        else:
            s.validate(*shape)
    assert sorted([MatmulSchedule(64), MatmulSchedule(32)])[0].bm == 32


def test_pad_operands_matches_reference_padding():
    """The padded shapes, the widened bn and n_valid of the reference's
    matmul_padded."""
    a, b = (torch.from_numpy(t) for t in _ab(40, 30, 50))
    s = MatmulSchedule(32, 32, 32)
    ap, bp, s2, nv = pad_operands(a, b, s, EpilogueSpec(softmax=True))
    assert ap.shape == (64, 32) and bp.shape == (32, 64)
    assert s2 == MatmulSchedule(32, 32, 64) and nv == 50
    assert torch.equal(ap[:40, :30], a) and ap[40:].abs().sum() == 0
    _, _, s3, nv3 = pad_operands(a, b, s, IDENTITY)
    assert s3 == s and nv3 is None
    _, _, _, nv4 = pad_operands(a, b[:, :32], s, EpilogueSpec(softmax=True))
    assert nv4 is None


def test_wrapper_routes_cpu_to_plain_and_counts_no_launch():
    a, b = (torch.from_numpy(t) for t in _ab(64, 128, 128))
    before = matmul_blocked.launches
    spec = EpilogueSpec(scale=0.5, relu=True)
    got = matmul_blocked(a, b, schedule=MatmulSchedule(32, 64, 64),
                         epilogue=spec)
    want = matmul_plain(a, b, schedule=MatmulSchedule(32, 64, 64),
                        epilogue=spec)
    assert torch.equal(got, want)
    assert matmul_blocked.launches == before
    with pytest.raises(ValueError, match="no matmul kernel"):
        matmul_blocked(a.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------------
# the wrapper's route rule and the build's key (no card needed)
# ---------------------------------------------------------------------------

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("m,k,n,dtype,route", [
    # arctic-480b's router (K = 7,168, 128 experts): decode, prefill
    (1, 7168, 128, BF, "splitk"), (4, 7168, 128, BF, "splitk"),
    (63, 7168, 128, BF, "splitk"), (2048, 7168, 128, BF, "sm90"),
    (64, 7168, 128, BF, "sm90"),
    # its fp32 parity copy: split K at decode, the FMA kernel at prefill
    (1, 7168, 128, F32, "splitk"), (2048, 7168, 128, F32, "fma"),
    # kimi-k2's router (384 experts)
    (1, 7168, 384, BF, "splitk"), (2048, 7168, 384, BF, "sm90"),
    # ragged K and N that TMA cannot take, rows that bulk copies cannot
    (100, 130, 60, BF, "fma"), (33, 257, 129, F32, "fma"),
    (33, 257, 130, F32, "fma"), (33, 257, 132, F32, "splitk"),
    # wider than a route holds, longer K than splitk stages
    (1, 7168, 4096, BF, "fma"), (2048, 7168, 1024, BF, "fma"),
    (1, 32768, 128, BF, "fma")])
def test_route_rule(m, k, n, dtype, route):
    """The wrapper's choice of kernel, made by shape and dtype before any
    launch."""
    assert _route(m, k, n, dtype) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="share one of"):
        _route(4, 64, 64, dtype)


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """A kernel's build key hashes its source and every csrc header it
    includes, directly or through another header: an edited header builds
    anew instead of loading a stale library."""
    (tmp_path / "k.cu").write_text('#include <math.h>\n#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("int x;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("k")] == ["k.cu", "h.cuh",
                                                    "g.cuh"]
    key = build.digest("k")
    assert build.digest("k") == key
    (tmp_path / "g.cuh").write_text("int y;\n")
    assert build.digest("k") != key
    monkeypatch.undo()
    for name in ("flash_attention_sm90", "matmul_blocked_sm90",
                 "matmul_splitk"):
        assert [p.name for p in build.sources(name)] == [f"{name}.cu",
                                                         "sm90.cuh"]
