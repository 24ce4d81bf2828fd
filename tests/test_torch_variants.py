"""Port parity: the four conv lowerings (``use_kernel=False``).

The port's ``conv2d_lowered`` (and the engine entries that reach it with
``use_kernel=False``) against the reference's ``conv2d_block_jnp`` /
``conv2d_nchwc_jnp`` with the same ``variant``, on the same numpy inputs:

* the reference's variant matrix (``tests/test_template_variants.py``: 4
  variants x ic_bn {3, 8, 16} x stride {1, 2} x epilogue on/off, and the
  asymmetric pads) at rtol = atol = 1e-4, as that file holds them;
* ``prelay_patch_gemm_weight`` and the pre-laid patch_gemm path;
* ResNet-18 at (2, 3, 32, 32): the reference's plan crossed as JSON, run
  with ``use_kernel=False`` and the reference's weights, against the
  reference's ``predict`` (rtol 1e-4, atol 1e-5, equal argmax, as
  ``tests/test_torch_e2e.py``); folded and unfolded BN agree on both paths.

The epilogue modes on each variant are ``tests/test_torch_variant_epilogues.py``.

Which path a predict takes is checked by counts: the lowerings count their
calls (``conv2d_lowered.calls``), and on the card the kernel its launches
(``tests/test_torch_cuda.py``).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layout import kernel_to_kcrs_ck, to_nchwc
from repro.engine import compile as r_compile
from repro.engine.session import _plan_to_json as r_plan_json
from repro.kernels.ops import (conv2d_block_jnp, conv2d_nchwc_jnp,
                               prelay_patch_gemm_weight as r_prelay)
from repro_torch.core.schedule import VARIANTS, ConvSchedule
from repro_torch.engine import compile as t_compile
from repro_torch.engine import compile_model, params_from_numpy
from repro_torch.engine.session import _plan_from_json
from repro_torch.kernels import ops as tops

MATRIX_TOL = dict(rtol=1e-4, atol=1e-4)
PRELAID_TOL = dict(rtol=1e-5, atol=1e-5)
E2E_TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (2, 3, 32, 32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _blocked(x, w, ic_bn, oc_bn):
    return (np.asarray(to_nchwc(jnp.asarray(x), ic_bn)),
            np.asarray(kernel_to_kcrs_ck(jnp.asarray(w), ic_bn, oc_bn)))


# ---------------------------------------------------------------------------
# The variant matrix of tests/test_template_variants.py
# ---------------------------------------------------------------------------

def _matrix_case(variant, ic_bn, stride, pad, epilogue, hw, seed, oc_bn=8):
    cin = ic_bn * 2 if ic_bn >= 8 else ic_bn      # ic_bn=3 -> cin=3 (stem)
    cout = oc_bn * 2
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, cin, hw, hw)).astype(np.float32)
    w = rng.normal(size=(cout, cin, 3, 3)).astype(np.float32)
    xb, wb = _blocked(x, w, ic_bn, oc_bn)
    before = tops.conv2d_lowered.calls[f"{variant}/fp32"]
    if not epilogue:
        want = conv2d_nchwc_jnp(_j(xb), _j(wb), stride=stride, pad=pad,
                                variant=variant)
        got = tops.conv2d_blocked(
            _t(xb), _t(wb), stride=stride, pad=pad, use_kernel=False,
            schedule=ConvSchedule(ic_bn, oc_bn, 1, variant=variant))
    else:
        ph, pw = _pads(pad)
        oh, ow = ((hw + 2 * ph - 3) // stride + 1,
                  (hw + 2 * pw - 3) // stride + 1)
        scale = rng.normal(size=(cout // oc_bn, oc_bn)).astype(np.float32)
        shift = rng.normal(size=(cout // oc_bn, oc_bn)).astype(np.float32)
        res = rng.normal(size=(2, cout // oc_bn, oh, ow, oc_bn)).astype(
            np.float32)
        want = conv2d_block_jnp(_j(xb), _j(wb), _j(scale), _j(shift),
                                _j(res), stride=stride, pad=pad, relu=True,
                                variant=variant)
        got = tops.conv2d_block_blocked(
            _t(xb), _t(wb), _t(scale), _t(shift), _t(res), stride=stride,
            pad=pad, relu=True, use_kernel=False,
            schedule=ConvSchedule(ic_bn, oc_bn, 1, variant=variant))
    assert tops.conv2d_lowered.calls[f"{variant}/fp32"] == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATRIX_TOL)


def _pads(pad):
    return (pad, pad) if isinstance(pad, int) else pad


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("ic_bn", [3, 8, 16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("epilogue", [False, True],
                         ids=["plain", "fused-epilogue"])
def test_variant_matrix_matches_reference(variant, ic_bn, stride, epilogue):
    _matrix_case(variant, ic_bn, stride, 1, epilogue, hw=9, seed=0)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("pad", [(0, 2), (2, 0)], ids=["pad-w", "pad-h"])
def test_variant_asymmetric_pad_matches_reference(variant, pad):
    _matrix_case(variant, 8, 1, pad, True, hw=8, seed=1)


def test_auto_resolves_as_the_schedule_does():
    """"auto" runs the variant ``ConvSchedule.resolved_variant`` names:
    tap_stack below ic_bn 8, per_tap from 8."""
    rng = np.random.default_rng(4)
    for ic_bn, expect in ((3, "tap_stack"), (8, "per_tap")):
        x = rng.normal(size=(1, ic_bn, 6, 6)).astype(np.float32)
        w = rng.normal(size=(8, ic_bn, 3, 3)).astype(np.float32)
        xb, wb = _blocked(x, w, ic_bn, 8)
        assert ConvSchedule(ic_bn, 8, 1).resolved_variant() == expect
        before = dict(tops.conv2d_lowered.calls)
        got = tops.conv2d_lowered(_t(xb), _t(wb), pad=1)
        assert {k: v - before[k] for k, v in
                tops.conv2d_lowered.calls.items() if v != before[k]} \
            == {f"{expect}/fp32": 1}
        want = conv2d_nchwc_jnp(_j(xb), _j(wb), pad=1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MATRIX_TOL)


# ---------------------------------------------------------------------------
# patch_gemm's bind-time pre-layout
# ---------------------------------------------------------------------------

def test_prelay_matches_reference_and_feeds_patch_gemm():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 7, 7)).astype(np.float32)
    w = rng.normal(size=(24, 16, 3, 3)).astype(np.float32)
    xb, wb = _blocked(x, w, 8, 8)
    prelaid = tops.prelay_patch_gemm_weight(_t(wb))
    np.testing.assert_array_equal(prelaid.numpy(),
                                  np.asarray(r_prelay(_j(wb))))
    assert prelaid.is_contiguous()
    sched = ConvSchedule(8, 8, 1, variant="patch_gemm")
    got = tops.conv2d_blocked(_t(xb), prelaid, stride=2, pad=1,
                              schedule=sched, use_kernel=False,
                              w_prelaid=True)
    want = conv2d_nchwc_jnp(_j(xb), r_prelay(_j(wb)), stride=2, pad=1,
                            variant="patch_gemm", w_prelaid=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRELAID_TOL)
    np.testing.assert_array_equal(
        got.numpy(), tops.conv2d_blocked(_t(xb), _t(wb), stride=2, pad=1,
                                         schedule=sched,
                                         use_kernel=False).numpy())


def test_refusals():
    """A pre-laid weight needs patch_gemm; the kernel path takes neither a
    pre-laid weight nor an int8 schedule; an unknown variant raises."""
    rng = np.random.default_rng(0)
    xb, wb = _blocked(rng.normal(size=(1, 8, 5, 5)).astype(np.float32),
                      rng.normal(size=(8, 8, 3, 3)).astype(np.float32), 8, 8)
    x, w = _t(xb), _t(wb)
    with pytest.raises(ValueError, match="patch_gemm"):
        tops.conv2d_lowered(x, tops.prelay_patch_gemm_weight(w),
                            variant="scan", w_prelaid=True)
    with pytest.raises(ValueError, match="pre-laid"):
        tops.conv2d_blocked(x, w, schedule=ConvSchedule(8, 8, 1),
                            w_prelaid=True)
    with pytest.raises(ValueError, match="use_kernel=False"):
        tops.conv2d_block_blocked(
            x, w, torch.ones(1, 8),
            schedule=ConvSchedule(8, 8, 1, variant="tap_stack",
                                  dtype="int8"))
    with pytest.raises(ValueError, match="variant"):
        tops.conv2d_lowered(x, w, variant="im2col")


# ---------------------------------------------------------------------------
# End to end: ResNet-18 on the lowerings
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    sess = r_compile("resnet-18", SHAPE, seed=0)
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    return sess, x, np.asarray(sess.predict(jnp.asarray(x)))


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **E2E_TOL)
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


def _blocked_convs(plan):
    p = plan.planned
    return [n.name for n in p.graph.topo_order()
            if n.op in ("conv_block", "conv2d") and p.layouts[n.name].is_blocked]


def test_reference_plan_on_the_lowerings_matches_reference(reference):
    sess, x, want = reference
    js = json.loads(json.dumps(r_plan_json(sess.plan_for(SHAPE[0]))))
    plan = _plan_from_json(js)
    variants = {s.resolved_variant() for s in plan.planned.schedules.values()}
    assert len(variants) >= 2
    params = params_from_numpy(sess._params, device="cpu")
    model = compile_model(plan, params, use_kernel=False)
    before = sum(tops.conv2d_lowered.calls.values())
    _close(model.predict(torch.from_numpy(x)).numpy(), want)
    assert sum(tops.conv2d_lowered.calls.values()) - before \
        == len(_blocked_convs(plan)) > 0
    # patch_gemm weights are bound pre-laid, the others as KCRS[x]c[y]k,
    # as the kernel path binds every weight
    kernel = compile_model(plan, params)
    for name in _blocked_convs(plan):
        w = kernel.params[name]["w"]
        if plan.planned.schedules[name].resolved_variant() == "patch_gemm":
            w = tops.prelay_patch_gemm_weight(w)
        torch.testing.assert_close(model.params[name]["w"], w, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "lowerings"])
def test_own_session_on_each_path_matches_reference(reference, use_kernel):
    """The port's own H100 plan: with ``use_kernel`` no lowering runs (B1's
    plain version on the CPU), without it every blocked conv runs its
    schedule's lowering; both match the reference's predict."""
    sess, x, want = reference
    port = t_compile("resnet-18", SHAPE, seed=0, device="cpu",
                     use_kernel=use_kernel)
    plan = port.plan_for(SHAPE[0])
    before = dict(tops.conv2d_lowered.calls)
    _close(port.predict(torch.from_numpy(x)).numpy(), want)
    ran = {k: v - before[k] for k, v in tops.conv2d_lowered.calls.items()
           if v != before[k]}
    if use_kernel:
        assert ran == {}
    else:
        want_ran: dict = {}
        for name in _blocked_convs(plan):
            s = plan.planned.schedules[name]
            key = f"{s.resolved_variant()}/{s.dtype}"
            want_ran[key] = want_ran.get(key, 0) + 1
        assert ran == want_ran


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "lowerings"])
def test_folded_and_unfolded_bn_agree(reference, use_kernel):
    """``fold_bn=False`` keeps the BN scale in the epilogue's scale operand
    instead of the weights; the two bindings agree on either path, and
    with the reference's unfolded binding."""
    sess, x, want = reference
    js = json.loads(json.dumps(r_plan_json(sess.plan_for(SHAPE[0]))))
    params = params_from_numpy(sess._params, device="cpu")
    outs = {}
    for fold in (True, False):
        model = compile_model(_plan_from_json(js), params,
                              use_kernel=use_kernel, fold_bn=fold)
        has_scale = any("scale" in model.params[n]
                        for n in _blocked_convs(model.plan))
        assert has_scale is not fold
        outs[fold] = model.predict(torch.from_numpy(x)).numpy()
        _close(outs[fold], want)
    np.testing.assert_allclose(outs[False], outs[True], **E2E_TOL)
    from repro.engine import compile_model as r_compile_model
    r_unfolded = np.asarray(r_compile_model(
        sess.plan_for(SHAPE[0]), sess._params, fold_bn=False).predict(
            jnp.asarray(x)))
    _close(outs[False], r_unfolded)
