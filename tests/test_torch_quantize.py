"""Port parity: W8 int8 weights (``core/quantize.py``, the int8 forms of
``kernels/ops.py``, int8 binding and ``dtype="int8"`` sessions).

* the round-trip properties of ``tests/test_quantize.py`` on the port's
  copy, and its int8 codes and scales equal to the reference's bit for bit;
* the int8 forms (tap_stack, patch_gemm) against the reference's
  ``conv2d_block_jnp(dtype="int8")`` on the same codes at rtol = atol =
  1e-4, as the reference's own int8 matrix holds them, and their refusals;
* the quantize axis of the planner priced and keyed as the reference's
  (the plan under the reference's machine constants equal to its plan);
* an int8 plan made by the reference, crossed as JSON with its weights,
  against the reference's int8 ``predict`` (rtol 1e-4, atol 1e-5, equal
  argmax, as ``tests/test_torch_e2e.py``);
* the port's own int8 session on the reference's ``_block_net``: at least
  one int8 conv, equal top-1 and logits within 5% of its fp32 twin, as
  ``tests/test_quantize.py`` asks of the reference's; and
  ``compile(dtype="int8")`` refused on the kernel path.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost as r_cost
from repro.core.layout import kernel_to_kcrs_ck, to_nchwc
from repro.core.pipeline import Pipeline as RPipeline
from repro.core.quantize import quantize_per_channel as r_quantize
from repro.engine import compile as r_compile
from repro.engine.session import _plan_to_json as r_plan_json
from repro.kernels.ops import conv2d_block_jnp
from repro.models.cnn import build as r_build
from repro_torch.core import cost as t_cost
from repro_torch.core.epilogue import fold_dequant_scale
from repro_torch.core.local_search import _wl_key as t_wl_key
from repro_torch.core.pipeline import Pipeline as TPipeline
from repro_torch.core.quantize import (QMAX, dequantize_per_channel,
                                       quantization_error_bound,
                                       quantize_per_channel)
from repro_torch.core.schedule import (INT8_VARIANTS, ConvSchedule,
                                       ConvWorkload)
from repro_torch.engine import (SESSION_DTYPES, InferenceSession,
                                compile as t_compile, compile_model,
                                params_from_numpy)
from repro_torch.engine.session import _plan_from_json, _plan_to_json
from repro_torch.kernels import ops as tops
from repro_torch.models.cnn import build as t_build

MATRIX_TOL = dict(rtol=1e-4, atol=1e-4)
E2E_TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (2, 3, 32, 32)
# the reference's TPU constants, under which the port plans as it does
REF_MACHINE = t_cost.MachineModel(
    peak_flops=r_cost.PEAK_FLOPS_FP32, mem_bw=r_cost.HBM_BW,
    link_bw=r_cost.ICI_BW_PER_LINK, fast_mem_bytes=r_cost.VMEM_BYTES)


# ---------------------------------------------------------------------------
# Round-trip properties (tests/test_quantize.py) and the reference's codes
# ---------------------------------------------------------------------------

def test_roundtrip_within_half_step(rng):
    w = rng.normal(size=(8, 4, 3, 3)).astype(np.float32)
    q, scale = quantize_per_channel(w)
    assert q.dtype == np.int8 and scale.shape == (8,)
    assert np.abs(q).max() <= QMAX
    err = np.abs(dequantize_per_channel(q, scale) - w)
    bound = quantization_error_bound(scale)
    assert np.all(err <= bound[:, None, None, None] + 1e-7)


def test_per_channel_scales_are_independent(rng):
    w = rng.normal(size=(4, 4, 3, 3)).astype(np.float32)
    w[0] *= 1e6
    q, scale = quantize_per_channel(w)
    assert scale[0] > 1e3 * scale[1:].max()
    err = np.abs(dequantize_per_channel(q, scale) - w)
    assert err[1:].max() <= quantization_error_bound(scale)[1:].max() + 1e-7


def test_zero_channels_roundtrip_exactly(rng):
    w = rng.normal(size=(4, 2, 3, 3)).astype(np.float32)
    w[1] = 0.0
    w[3] = 0.0
    q, scale = quantize_per_channel(w)
    assert scale[1] == 1.0 and scale[3] == 1.0      # no divide-by-zero
    wd = dequantize_per_channel(q, scale)
    assert np.all(wd[1] == 0.0) and np.all(wd[3] == 0.0)


def test_extreme_dynamic_range(rng):
    w = rng.normal(size=(3, 2, 3, 3)).astype(np.float32)
    w[0] *= 1e-8
    w[2] *= 1e8
    q, scale = quantize_per_channel(w)
    err = np.abs(dequantize_per_channel(q, scale) - w)
    bound = quantization_error_bound(scale)
    for k in range(3):
        assert err[k].max() <= bound[k] * (1 + 1e-5) + 1e-30


def test_max_code_weights_are_exact():
    w = np.array([[[[127., -3.], [2., 0.]]],
                  [[[5., -127.], [1., -1.]]]], np.float32)
    q, scale = quantize_per_channel(w)
    np.testing.assert_array_equal(scale, [1.0, 1.0])
    np.testing.assert_array_equal(q.astype(np.float32), w)


@pytest.mark.parametrize("shape,axis,spread", [
    ((64, 32, 3, 3), 0, 0.0), ((16, 8, 1, 1), 0, 12.0),
    ((12, 7), 0, 30.0), ((5, 9), 1, 4.0), ((7,), 0, 0.0)])
def test_codes_and_scales_equal_the_reference(shape, axis, spread):
    rng = np.random.default_rng(11)
    w = rng.normal(size=shape).astype(np.float32)
    w *= np.exp2(rng.uniform(-spread, spread, size=shape[axis])).reshape(
        [-1 if i == axis else 1 for i in range(len(shape))]).astype(
            np.float32)
    w.reshape(-1)[::5] = 0.0
    q, s = quantize_per_channel(w, axis=axis)
    rq, rs = r_quantize(w, axis=axis)
    assert q.dtype == rq.dtype == np.int8
    assert q.tobytes() == rq.tobytes() and s.tobytes() == rs.tobytes()


def test_fold_dequant_scale():
    s, ws = torch.tensor([2.0, 3.0]), np.array([0.5, 0.25], np.float32)
    assert fold_dequant_scale(s, None) is s
    torch.testing.assert_close(fold_dequant_scale(None, ws),
                               torch.tensor([0.5, 0.25]))
    torch.testing.assert_close(fold_dequant_scale(s, torch.from_numpy(ws)),
                               torch.tensor([1.0, 0.75]))


# ---------------------------------------------------------------------------
# The int8 forms against the reference's
# ---------------------------------------------------------------------------

def _int8_operands(ic_bn, stride, seed, hw=9, oc_bn=8):
    cin, cout = ic_bn * 2, oc_bn * 2
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, cin, hw, hw)).astype(np.float32)
    q, w_scale = quantize_per_channel(
        rng.normal(size=(cout, cin, 3, 3)).astype(np.float32))
    shift = rng.normal(size=cout).astype(np.float32)
    xb = np.array(to_nchwc(jnp.asarray(x), ic_bn))
    wb = np.array(kernel_to_kcrs_ck(jnp.asarray(q), ic_bn, oc_bn))
    assert wb.dtype == np.int8
    return (xb, wb, w_scale.reshape(-1, oc_bn), shift.reshape(-1, oc_bn))


@pytest.mark.parametrize("variant", INT8_VARIANTS)
@pytest.mark.parametrize("ic_bn", [4, 8, 16])
@pytest.mark.parametrize("stride", [1, 2])
def test_int8_matrix_matches_reference(variant, ic_bn, stride):
    xb, wb, scale, shift = _int8_operands(ic_bn, stride, seed=0)
    want = conv2d_block_jnp(*(jnp.asarray(a) for a in (xb, wb, scale,
                                                       shift)),
                            None, None, stride=stride, pad=1, relu=True,
                            variant=variant, dtype="int8")
    sched = ConvSchedule(ic_bn, 8, 1, variant=variant, dtype="int8")
    before = tops.conv2d_lowered.calls[f"{variant}/int8"]
    got = tops.conv2d_block_blocked(
        *(torch.from_numpy(a) for a in (xb, wb, scale, shift)),
        stride=stride, pad=1, relu=True, schedule=sched, use_kernel=False)
    assert tops.conv2d_lowered.calls[f"{variant}/int8"] == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATRIX_TOL)
    if variant == "patch_gemm":      # the pre-laid codes give the same sums
        pre = tops.conv2d_block_blocked(
            torch.from_numpy(xb),
            tops.prelay_patch_gemm_weight(torch.from_numpy(wb)),
            torch.from_numpy(scale), torch.from_numpy(shift), stride=stride,
            pad=1, relu=True, schedule=sched, use_kernel=False,
            w_prelaid=True)
        torch.testing.assert_close(pre, got, rtol=0, atol=0)


def test_int8_exact_on_integer_weights():
    """Integer weights with per-channel amax 127 quantize losslessly: the
    int8 form is bit-identical to the fp32 one."""
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, size=(1, 8, 8, 8)).astype(np.float32)
    w = rng.integers(-3, 4, size=(16, 8, 3, 3)).astype(np.float32)
    w[:, 0, 0, 0] = 127.0
    q, w_scale = quantize_per_channel(w)
    np.testing.assert_array_equal(w_scale, np.ones(16, np.float32))
    xb = torch.from_numpy(np.array(to_nchwc(jnp.asarray(x), 8)))

    def wblk(a):
        return torch.from_numpy(np.array(kernel_to_kcrs_ck(
            jnp.asarray(a), 8, 8)))

    f32 = tops.conv2d_lowered(xb, wblk(w), pad=1, variant="tap_stack")
    i8 = tops.conv2d_lowered(xb, wblk(q), torch.from_numpy(
        w_scale.reshape(2, 8)), pad=1, variant="tap_stack", dtype="int8")
    assert i8.numpy().tobytes() == f32.numpy().tobytes()


def test_int8_refusals():
    """The dequantize scale is required, only tap_stack and patch_gemm
    have int8 forms, the weight must be int8 codes, and the kernel path
    takes no int8 schedule."""
    xb, wb, scale, _ = _int8_operands(8, 1, seed=0)
    x, w, s = (torch.from_numpy(a) for a in (xb, wb, scale))
    with pytest.raises(ValueError, match="scale"):
        tops.conv2d_lowered(x, w, pad=1, variant="tap_stack", dtype="int8")
    for variant in ("per_tap", "scan"):
        with pytest.raises(ValueError, match="int8"):
            tops.conv2d_lowered(x, w, s, pad=1, variant=variant,
                                dtype="int8")
    with pytest.raises(TypeError, match="int8"):
        tops.conv2d_lowered(x, w.float(), s, pad=1, variant="patch_gemm",
                            dtype="int8")
    with pytest.raises(ValueError, match="use_kernel=False"):
        tops.conv2d_block_blocked(
            x, w, s, pad=1,
            schedule=ConvSchedule(8, 8, 1, variant="tap_stack",
                                  dtype="int8"))


# ---------------------------------------------------------------------------
# The planner's quantize axis
# ---------------------------------------------------------------------------

def test_quantized_plan_matches_reference():
    """Under the reference's machine constants the port's quantized plan
    is the reference's: int8 priced by its 1-byte weights, quantized
    workloads keyed apart, only conv_block nodes eligible."""
    rg, rs = r_build("resnet-18", batch=2, image=64)
    want = r_plan_json(RPipeline.preset("fusion").run(rg, rs, quantize=True))
    tg, ts = t_build("resnet-18", batch=2, image=64)
    got = _plan_to_json(TPipeline.preset("fusion").run(
        tg, ts, quantize=True, machine=REF_MACHINE))
    for js in (want, got):
        js.pop("report")
        js.pop("predicted")
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert any(s["dtype"] == "int8" for s in got["schedules"].values())
    wl = ConvWorkload(batch=1, in_channels=256, out_channels=512, height=2,
                      width=2, kh=3, kw=3, pad=1, fused_bn=True,
                      fused_relu=True, quantize=True)
    assert t_wl_key(wl) != t_wl_key(dataclasses.replace(wl, quantize=False))
    f32, i8 = (t_cost.conv_schedule_cost(
        wl, ConvSchedule(16, 16, 1, variant="tap_stack", dtype=d))
        for d in ("fp32", "int8"))
    assert i8.memory_s < f32.memory_s and i8.compute_s == f32.compute_s


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_int8():
    sess = r_compile("resnet-18", SHAPE, seed=0, dtype="int8")
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    return sess, x, np.asarray(sess.predict(jnp.asarray(x)))


def test_reference_int8_plan_crosses_as_json(reference_int8):
    sess, _, _ = reference_int8
    js = json.loads(json.dumps(r_plan_json(sess.plan_for(SHAPE[0]))))
    plan = _plan_from_json(js)
    want = {n: (s["variant"], s["dtype"]) for n, s in js["schedules"].items()}
    got = {n: (s.variant, s.dtype)
           for n, s in plan.planned.schedules.items()}
    assert got == want and "int8" in {d for _, d in got.values()}


def test_reference_int8_plan_matches_reference_predict(reference_int8):
    """The reference's int8 plan and weights through the port's binding
    (codes quantized on the host, the reference's bit for bit) and its
    lowerings match the reference's int8 predict."""
    sess, x, want = reference_int8
    plan = _plan_from_json(json.loads(json.dumps(
        r_plan_json(sess.plan_for(SHAPE[0])))))
    model = compile_model(plan, params_from_numpy(sess._params, device="cpu"),
                          use_kernel=False)
    ref_bound = sess.specialize(SHAPE[0]).params
    for name, s in plan.planned.schedules.items():
        if s.dtype == "int8":
            got_w = model.params[name]["w"]
            want_w = np.asarray(ref_bound[name]["w"])
            assert got_w.dtype == torch.int8
            assert got_w.numpy().tobytes() == want_w.tobytes()
            np.testing.assert_array_equal(model.params[name]["scale"].numpy(),
                                          np.asarray(ref_bound[name]["scale"]))
    before = tops.conv2d_lowered.calls["tap_stack/int8"] \
        + tops.conv2d_lowered.calls["patch_gemm/int8"]
    got = model.predict(torch.from_numpy(x)).numpy()
    assert tops.conv2d_lowered.calls["tap_stack/int8"] \
        + tops.conv2d_lowered.calls["patch_gemm/int8"] > before
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **E2E_TOL)
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


def _block_net():
    from repro_torch.core.graph import Graph
    g = Graph()
    g.add("in", "input")
    g.add("c1", "conv2d", ["in"], in_channels=3, out_channels=16, kh=3,
          kw=3, stride=1, pad=1)
    g.add("b1", "batch_norm", ["c1"])
    g.add("r1", "relu", ["b1"])
    g.add("c2", "conv2d", ["r1"], in_channels=16, out_channels=32, kh=3,
          kw=3, stride=2, pad=1)
    g.add("b2", "batch_norm", ["c2"])
    g.add("r2", "relu", ["b2"])
    g.add("gap", "global_avg_pool", ["r2"])
    g.add("fl", "flatten", ["gap"])
    g.add("fc", "dense", ["fl"], units=10)
    g.mark_output("fc")
    return g, {"in": (2, 3, 16, 16)}


def test_own_int8_session_agrees_with_fp32_twin(rng):
    g, shapes = _block_net()
    g2, _ = _block_net()
    f32 = t_compile(g, shapes, seed=7, device="cpu", use_kernel=False)
    i8 = t_compile(g2, shapes, seed=7, device="cpu", use_kernel=False,
                   dtype="int8")
    assert i8.dtype == "int8" and i8.use_kernel is False
    sch = i8.plan_for(2).planned.schedules
    int8 = [n for n, s in sch.items() if s.dtype == "int8"]
    assert int8
    model = i8.specialize(2)
    for n in int8:
        assert model.params[n]["w"].dtype == torch.int8
        assert "scale" in model.params[n]
    x = torch.from_numpy(rng.normal(size=shapes["in"]).astype(np.float32))
    yf, yq = f32.predict(x).numpy(), i8.predict(x).numpy()
    assert np.array_equal(np.argmax(yf, 1), np.argmax(yq, 1))
    assert float(np.max(np.abs(yf - yq))) < 0.05 * float(np.max(np.abs(yf)))
    # the bound conv weights are int8 codes: about a quarter of the bytes
    nbytes = [sum(m.params[n]["w"].nbytes for n in sch)
              for m in (f32.specialize(2), model)]
    assert nbytes[1] < 0.55 * nbytes[0]


def test_int8_needs_the_lowerings():
    g, shapes = _block_net()
    assert SESSION_DTYPES == ("fp32", "int8")
    with pytest.raises(ValueError, match="use_kernel=False"):
        t_compile(g, shapes, device="cpu", dtype="int8")
    with pytest.raises(ValueError, match="dtype"):
        t_compile(g, shapes, device="cpu", dtype="fp16", use_kernel=False)
    sess = t_compile(g, shapes, device="cpu", eager=False,
                     use_kernel=False, dtype="int8")
    assert isinstance(sess, InferenceSession) and sess.batch_sizes == []
