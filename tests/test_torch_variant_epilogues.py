"""Port parity: the epilogue modes of ``tests/test_fused_epilogues.py`` on
each of the four conv lowerings (``use_kernel=False``).

The port's ``conv2d_lowered`` against the reference's ``conv2d_block_jnp``
with the same ``variant``, on the same numpy inputs: none, BN, BN+ReLU,
residual, max and avg pool, pool+ReLU and the concat-offset store, at
stride 1 and 2 and with asymmetric pads, and the RGB stem's ic_bn = 3
through the pooled epilogue.  Tolerance 1e-5, as that file holds its
variants: fp32 sums of at most 144 terms in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.epilogue import EpilogueSpec as REpilogue
from repro.core.epilogue import PoolSpec as RPool
from repro.core.layout import kernel_to_kcrs_ck, to_nchwc
from repro.kernels.ops import conv2d_block_jnp
from repro_torch.core.epilogue import EpilogueSpec, PoolSpec
from repro_torch.core.schedule import VARIANTS
from repro_torch.kernels import ops as tops

EPI_TOL = dict(rtol=1e-5, atol=1e-5)

# epilogue mode -> (bn, relu, residual, pool kind, concat), as the
# reference's matrix has it
EPILOGUES = {
    "none":      (False, False, False, None, False),
    "bn":        (True, False, False, None, False),
    "bn_relu":   (True, True, False, None, False),
    "residual":  (False, False, True, None, False),
    "max_pool":  (False, False, False, "max", False),
    "avg_pool":  (False, False, False, "avg", False),
    "pool_relu": (False, True, False, "max", False),
    "concat":    (False, False, False, None, True),
}


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _blocked(x, w, ic_bn, oc_bn):
    return (np.asarray(to_nchwc(jnp.asarray(x), ic_bn)),
            np.asarray(kernel_to_kcrs_ck(jnp.asarray(w), ic_bn, oc_bn)))


def _pads(pad):
    return (pad, pad) if isinstance(pad, int) else pad


def _epilogue_case(variant, mode, stride, pad, *, ic_bn=8, oc_bn=8, hw=9,
                   seed=0):
    bn, relu, residual, pool_kind, concat = EPILOGUES[mode]
    cin, cout = ic_bn * 2, oc_bn * 2
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, cin, hw, hw)).astype(np.float32)
    w = rng.normal(size=(cout, cin, 3, 3)).astype(np.float32)
    xb, wb = _blocked(x, w, ic_bn, oc_bn)
    ph, pw = _pads(pad)
    oh, ow = (hw + 2 * ph - 3) // stride + 1, (hw + 2 * pw - 3) // stride + 1
    pool = (pool_kind, 3, 2, 1) if pool_kind else None
    spec_kw = dict(relu=relu, concat_offset=cout if concat else 0,
                   concat_total=2 * cout if concat else 0)
    r_spec = REpilogue(pool=RPool(*pool) if pool else None, **spec_kw)
    t_spec = EpilogueSpec(pool=PoolSpec(*pool) if pool else None, **spec_kw)

    def vec():
        return rng.normal(size=(cout // oc_bn, oc_bn)).astype(np.float32)

    scale = vec() if bn else None
    shift = vec() if bn else None
    res = rng.normal(size=(2, cout // oc_bn, oh, ow, oc_bn)).astype(
        np.float32) if residual else None
    buf = None
    if concat:
        sh, sw = t_spec.out_hw(oh, ow)
        buf = rng.normal(size=(2, 2 * cout // oc_bn, sh, sw, oc_bn)).astype(
            np.float32)
    want = conv2d_block_jnp(_j(xb), _j(wb), _j(scale), _j(shift), _j(res),
                            _j(buf), stride=stride, pad=pad, epilogue=r_spec,
                            variant=variant)
    got = tops.conv2d_lowered(_t(xb), _t(wb), _t(scale), _t(shift), _t(res),
                              _t(buf), stride=stride, pad=pad,
                              epilogue=t_spec, variant=variant)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EPI_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", sorted(EPILOGUES))
@pytest.mark.parametrize("stride", [1, 2])
def test_epilogue_modes_match_reference(variant, mode, stride):
    _epilogue_case(variant, mode, stride, 1)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", ["bn_relu", "pool_relu", "concat"])
@pytest.mark.parametrize("pad", [(0, 2), (2, 0)], ids=["pad-w", "pad-h"])
def test_epilogue_modes_asym_pad_match_reference(variant, mode, pad):
    _epilogue_case(variant, mode, 1, pad, hw=8, seed=1)


@pytest.mark.parametrize("variant", VARIANTS)
def test_epilogue_stem_channels_match_reference(variant):
    """The RGB-stem shape (ic_bn = 3) through the pooled epilogue."""
    _epilogue_case(variant, "pool_relu", 2, 1, ic_bn=3, seed=2)
