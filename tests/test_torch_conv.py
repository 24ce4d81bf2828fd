"""Port parity: the blocked conv with its fused epilogue.

(f) The port's ``conv2d_block_blocked`` on CPU tensors runs the conv
    kernel's plain version.  It is held against the reference's
    ``conv2d_block_jnp`` (its per-tap lowering) over the epilogue matrix of
    ``tests/test_fused_epilogues.py`` — none, BN, BN+ReLU, residual, max and
    avg pool, pool+ReLU, concat-offset write — with stride 1 and 2 and
    asymmetric pads, and on four tiny cases against the reference's Pallas
    kernel in interpret mode.  Tolerance 1e-5, as the reference's own matrix
    holds its variants: fp32 sums of at most 144 terms in another order.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.epilogue import EpilogueSpec as REpilogue
from repro.core.epilogue import PoolSpec as RPool
from repro.core.layout import kernel_to_kcrs_ck, to_nchwc
from repro.core.schedule import ConvSchedule
from repro_torch.core.schedule import ConvSchedule as TSchedule
from repro.kernels.conv2d_nchwc import conv2d_nchwc_pallas
from repro.kernels.ops import conv2d as r_conv2d
from repro.kernels.ops import conv2d_block_jnp, conv2d_nchwc_jnp, pad_blocked
from repro.kernels.ref import conv2d_nchw_ref as r_ref
from repro_torch.core.epilogue import EpilogueSpec, PoolSpec
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import conv2d_nchwc as kmod
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import conv2d_nchw_ref, conv2d_nchwc_ref

TOL = dict(rtol=1e-5, atol=1e-5)

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


def _case(mode, stride, pad, *, ic_bn=8, oc_bn=8, hw=9, seed=0, batch=2,
          pool_ceil=False):
    """Blocked numpy operands of one conv_block, and both packages' specs."""
    bn, relu, residual, pool_kind, concat = EPILOGUES[mode]
    cin, cout, kh = ic_bn * 2, oc_bn * 2, 3
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, cin, hw, hw)).astype(np.float32)
    w = rng.normal(size=(cout, cin, kh, kh)).astype(np.float32)
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    oh = (hw + 2 * ph - kh) // stride + 1
    ow = (hw + 2 * pw - kh) // stride + 1
    pool = (pool_kind, 3, 2, 1, pool_ceil) if pool_kind else None
    total = cout * 2
    spec_kw = dict(relu=relu, concat_offset=cout if concat else 0,
                   concat_total=total if concat else 0)
    r_spec = REpilogue(pool=RPool(*pool) if pool else None, **spec_kw)
    t_spec = EpilogueSpec(pool=PoolSpec(*pool) if pool else None, **spec_kw)

    def blk(a, block):
        return np.asarray(to_nchwc(jnp.asarray(a), block))

    ops = {
        "x": blk(x, ic_bn),
        "w": np.asarray(kernel_to_kcrs_ck(jnp.asarray(w), ic_bn, oc_bn)),
        "scale": (rng.normal(size=cout).astype(np.float32)
                  .reshape(-1, oc_bn) if bn else None),
        "shift": (rng.normal(size=cout).astype(np.float32)
                  .reshape(-1, oc_bn) if bn else None),
        "residual": (blk(rng.normal(size=(batch, cout, oh, ow))
                         .astype(np.float32), oc_bn) if residual else None),
        "out_buf": None,
    }
    if concat:
        sh, sw = t_spec.out_hw(oh, ow)
        ops["out_buf"] = blk(rng.normal(size=(batch, total, sh, sw))
                             .astype(np.float32), oc_bn)
    return ops, r_spec, t_spec


def _jnp(ops):
    return {k: None if v is None else jnp.asarray(v) for k, v in ops.items()}


def _torch(ops):
    return {k: None if v is None else torch.from_numpy(v.copy())
            for k, v in ops.items()}


def _run_port(ops, stride, pad, spec):
    o = _torch(ops)
    return tops.conv2d_block_blocked(
        o["x"], o["w"], o["scale"], o["shift"], o["residual"], o["out_buf"],
        stride=stride, pad=pad, epilogue=spec).numpy()


def _check(mode, stride, pad, **kw):
    ops, r_spec, t_spec = _case(mode, stride, pad, **kw)
    o = _jnp(ops)
    want = np.asarray(conv2d_block_jnp(
        o["x"], o["w"], o["scale"], o["shift"], o["residual"], o["out_buf"],
        stride=stride, pad=pad, epilogue=r_spec, variant="per_tap"))
    got = _run_port(ops, stride, pad, t_spec)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", sorted(EPILOGUES))
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_matches_reference_epilogue_matrix(mode, stride):
    _check(mode, stride, pad=1)


@pytest.mark.parametrize("mode", ["bn_relu", "pool_relu", "concat",
                                  "avg_pool"])
@pytest.mark.parametrize("pad", [(0, 2), (2, 0)], ids=["pad-w", "pad-h"])
def test_plain_matches_reference_asym_pad(mode, pad):
    _check(mode, 1, pad, hw=8, seed=1)


@pytest.mark.parametrize("mode", ["max_pool", "avg_pool"])
def test_plain_matches_reference_ceil_pool_stem(mode):
    """The RGB-stem shape (ic_bn=3) through a ceil-mode pooled epilogue."""
    _check(mode, 2, 1, ic_bn=3, hw=10, seed=2, pool_ceil=True)


PALLAS_CASES = [("bn_relu", 1, 1, {}), ("max_pool", 2, 1, {"ic_bn": 3}),
                ("concat", 1, (1, 0), {}), ("residual", 1, 1, {})]


@pytest.mark.parametrize("mode,stride,pad,kw", PALLAS_CASES,
                         ids=[c[0] for c in PALLAS_CASES])
def test_plain_matches_pallas_interpret(mode, stride, pad, kw):
    ops, r_spec, t_spec = _case(mode, stride, pad, hw=6, batch=1, **kw)
    o = _jnp(ops)
    ic_bn, oc_bn = ops["x"].shape[-1], ops["w"].shape[-1]
    xp = pad_blocked(o["x"], pad)
    oh = (xp.shape[2] - 3) // stride + 1
    ow = (xp.shape[3] - 3) // stride + 1
    sched = ConvSchedule(ic_bn, oc_bn, ow_bn=ow, oh_bn=oh)
    want = np.asarray(conv2d_nchwc_pallas(
        xp, o["w"], o["scale"], o["shift"], o["residual"], o["out_buf"],
        stride=stride, schedule=sched, epilogue=r_spec, interpret=True))
    np.testing.assert_allclose(_run_port(ops, stride, pad, t_spec), want,
                               **TOL)


@pytest.mark.parametrize("stride,pad", [(1, 0), (2, 1), (1, (2, 1))])
def test_ref_oracles_match_reference(stride, pad):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 7, 6)).astype(np.float32)
    w = rng.normal(size=(12, 4, 3, 3)).astype(np.float32)
    want = np.asarray(r_ref(jnp.asarray(x), jnp.asarray(w), stride, pad, 2))
    got = conv2d_nchw_ref(torch.from_numpy(x), torch.from_numpy(w), stride,
                          pad, 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    xb = np.array(to_nchwc(jnp.asarray(x), 4))
    wb = np.array(kernel_to_kcrs_ck(jnp.asarray(w[:, :4].repeat(2, 1)),
                                      4, 6))
    want_b = np.asarray(conv2d_nchwc_jnp(jnp.asarray(xb), jnp.asarray(wb),
                                         stride=stride, pad=pad))
    got_b = conv2d_nchwc_ref(torch.from_numpy(xb), torch.from_numpy(wb),
                             stride, pad).numpy()
    np.testing.assert_allclose(got_b, want_b, **TOL)


@pytest.mark.parametrize("ic_bn,oc_bn,stride,pad", [(4, 6, 1, 1),
                                                   (8, 12, 2, (0, 1))])
def test_nchw_entry_matches_reference(ic_bn, oc_bn, stride, pad):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 7, 9)).astype(np.float32)
    w = rng.normal(size=(12, 8, 3, 3)).astype(np.float32)
    want = np.asarray(r_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                               pad=pad, schedule=ConvSchedule(ic_bn, oc_bn, 1)))
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                      pad=pad, schedule=TSchedule(ic_bn, oc_bn, 1))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_tensors_take_the_plain_version():
    ops, _, spec = _case("bn_relu", 1, 1)
    before = kmod.conv2d_nchwc.launches
    o = _torch(ops)
    got = kmod.conv2d_nchwc(tops.pad_blocked(o["x"], 1), o["w"], o["scale"],
                            o["shift"], epilogue=spec)
    want = kmod.conv2d_nchwc_plain(tops.pad_blocked(o["x"], 1), o["w"],
                                   o["scale"], o["shift"], epilogue=spec)
    assert kmod.conv2d_nchwc.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_other_devices_raise(monkeypatch):
    """A meta tensor (shapes alone, as ``analysis.flops`` counts) takes the
    plain version and launches nothing; a device that is neither a plain
    one nor CUDA raises (here meta, taken out of the plain set)."""
    x = torch.empty((1, 1, 5, 5, 4), device="meta")
    w = torch.empty((1, 1, 3, 3, 4, 4), device="meta")
    before = kmod.conv2d_nchwc.launches
    got = kmod.conv2d_nchwc(x, w)
    assert got.device.type == "meta" and got.shape == (1, 1, 3, 3, 4)
    assert kmod.conv2d_nchwc.launches == before
    monkeypatch.setattr(kbuild, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="no conv kernel"):
        kmod.conv2d_nchwc(x, w)
    with pytest.raises(ValueError, match="matmul-tail"):
        kmod.conv2d_nchwc(x, w, epilogue=EpilogueSpec(softmax=True))


def test_kernel_source_ships_with_the_package():
    src = (kbuild.CSRC / "conv2d_nchwc_sm90.cu").read_text()
    assert 'extern "C" int conv2d_sm90_launch' in src
    assert (kbuild.CSRC / "sm90.cuh") in kbuild.sources("conv2d_nchwc_sm90")
    # the tf32 wgmma lives in the shared header, which B1 compiles and calls
    built = "".join(f.read_text()
                    for f in kbuild.sources("conv2d_nchwc_sm90"))
    assert "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32" in built
    assert "wgmma_tf32(" in src
    assert "sm_90a" in " ".join(kbuild.NVCC_FLAGS)
