"""Port parity: layouts, relayout, pooling and the epilogue spec.

The same numpy inputs, made from a seed, go through the JAX reference and
the PyTorch port on the CPU.  Relayouts move values without arithmetic and
must match exactly; pooling sums or maxes the same values in the same order
and must match exactly too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import epilogue as r_epi
from repro.core import layout as r_lay
from repro.kernels.ops import pad_blocked as r_pad_blocked
from repro_torch.core import epilogue as t_epi
from repro_torch.core import layout as t_lay
from repro_torch.kernels.ops import pad_blocked as t_pad_blocked

LAYOUTS = [("NCHW", 0), ("NHWC", 0), ("NCHWc", 4), ("NCHWc", 8)]


def _pair(kind, block):
    return (r_lay.Layout(r_lay.LayoutKind(kind), block),
            t_lay.Layout(t_lay.LayoutKind(kind), block))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("block", [1, 4, 8, 16])
def test_to_from_nchwc_match_reference(block):
    x = _x((2, 16, 5, 7))
    want = np.asarray(r_lay.to_nchwc(jnp.asarray(x), block))
    got = t_lay.to_nchwc(torch.from_numpy(x), block)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    back = t_lay.from_nchwc(got)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(r_lay.from_nchwc(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("src", LAYOUTS, ids=lambda s: f"{s[0]}{s[1]}")
@pytest.mark.parametrize("dst", LAYOUTS, ids=lambda s: f"{s[0]}{s[1]}")
def test_relayout_matches_reference(src, dst):
    (r_src, t_src), (r_dst, t_dst) = _pair(*src), _pair(*dst)
    x = _x((2, 8, 3, 5), seed=1)
    phys = np.array(r_lay.relayout(jnp.asarray(x), r_lay.NCHW, r_src))
    want = np.asarray(r_lay.relayout(jnp.asarray(phys), r_src, r_dst))
    got = t_lay.relayout(torch.from_numpy(phys), t_src, t_dst)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert t_lay.blocked_shape(x.shape, t_dst) == \
        r_lay.blocked_shape(x.shape, r_dst)
    assert t_lay.transform_bytes(x.shape, t_src, t_dst) == \
        r_lay.transform_bytes(x.shape, r_src, r_dst)


@pytest.mark.parametrize("ic_bn,oc_bn", [(1, 1), (3, 8), (6, 4), (12, 16)])
def test_kernel_layout_matches_reference(ic_bn, oc_bn):
    w = _x((16, 12, 3, 3), seed=2)
    want = np.asarray(r_lay.kernel_to_kcrs_ck(jnp.asarray(w), ic_bn, oc_bn))
    got = t_lay.kernel_to_kcrs_ck(torch.from_numpy(w), ic_bn, oc_bn)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_lay.kernel_from_kcrs_ck(got).numpy(), w)


def test_layout_helpers_match_reference():
    for c in (3, 64, 96, 256, 1000):
        assert t_lay.candidate_blocks(c) == r_lay.candidate_blocks(c)
    with pytest.raises(ValueError):
        t_lay.kernel_to_kcrs_ck(torch.zeros(6, 4, 1, 1), 3, 4)
    with pytest.raises(ValueError):
        t_lay.to_nchwc(torch.zeros(1, 6, 2, 2), 4)
    with pytest.raises(ValueError):
        t_lay.Layout(t_lay.LayoutKind.NCHWc, 0)
    assert str(t_lay.nchwc(8)) == str(r_lay.nchwc(8)) == "NCHW8c"


# pooling: ceil mode pads the far side further than the near one (an
# asymmetric window grid), and max pads with -inf where avg pads with 0
POOLS = [(k, s, p, ceil) for k, s, p in [(3, 2, 1), (2, 2, 0), (3, 1, 1),
                                         (3, 2, 0), (5, 3, 2)]
         for ceil in (False, True)]


@pytest.mark.parametrize("reducer", ["max", "avg"])
@pytest.mark.parametrize("k,stride,pad,ceil", POOLS)
@pytest.mark.parametrize("rank", [4, 5])
def test_pool2d_matches_reference(reducer, k, stride, pad, ceil, rank):
    shape = (2, 3, 11, 8) if rank == 4 else (2, 2, 11, 8, 4)
    # all-negative values: a -inf pad that leaked as 0 would win the max
    x = _x(shape, seed=3) - 10.0
    want = np.asarray(r_epi.pool2d(jnp.asarray(x), k, stride, pad, ceil,
                                   reducer))
    got = t_epi.pool2d(torch.from_numpy(x), k, stride, pad, ceil, reducer)
    assert tuple(got.shape) == want.shape
    assert t_epi.PoolSpec(reducer, k, stride, pad, ceil).out_hw(11, 8) == \
        r_epi.PoolSpec(reducer, k, stride, pad, ceil).out_hw(11, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pad", [0, 1, (0, 2), (2, 0), (1, 3)])
def test_pad_blocked_matches_reference(pad):
    x = _x((2, 3, 5, 6, 4), seed=4)
    want = np.asarray(r_pad_blocked(jnp.asarray(x), pad))
    np.testing.assert_array_equal(
        t_pad_blocked(torch.from_numpy(x), pad).numpy(), want)


@pytest.mark.parametrize("kwargs", [
    dict(relu=True, pool=("max", 3, 2, 1, False)),
    dict(concat_offset=8, concat_total=24),
    dict(softmax=True, relu=True),
    dict(softmax=True, pool=("avg", 2, 2, 0, True)),
    dict(mask="diagonal"),
    dict(scale=0.5, mask="causal", softmax=True),
])
def test_epilogue_spec_validation_matches_reference(kwargs):
    def build(mod):
        kw = dict(kwargs)
        if "pool" in kw:
            kw["pool"] = mod.PoolSpec(*kw["pool"])
        try:
            spec = mod.EpilogueSpec(**kw)
        except ValueError:
            return "ValueError"
        return (spec.has_matmul_tail, spec.writes_concat,
                spec.out_hw(9, 9), spec.out_channels(8))

    assert build(t_epi) == build(r_epi)


def test_pool_spec_rejects_unknown_kind():
    with pytest.raises(ValueError):
        t_epi.PoolSpec("mean", 2, 2)
