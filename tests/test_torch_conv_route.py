"""B1's route and arithmetic, on the CPU.

* ``_route`` sends every conv of ResNet-50's plan (batch 1 and 8) and
  both of ``chip_smoke.extra_cases()`` to one of B1's two kernels, and its
  launch plans fit the card: shared memory, grid, cluster split, and the
  stem's pooled patch recomputing at most 1.25x its conv work.
* The wide route's choice, conv by conv, at ``resnet50.offline``'s batch
  (ResNet-50 at 32) and ``vgg16.single_stream``'s (VGG-16 at 1): which
  route, which tile, the grid against the card's SMs; the pooled, RGB and
  small-M launches keep the sm90 plan.
* The kernel's arithmetic, emulated in numpy: each fp32 operand split into
  ``hi = tf32(a)`` and ``lo = tf32(a - hi)`` with ``cvt.rna`` semantics
  (round to nearest, ties away from zero, 10 stored mantissa bits), the
  products ``lo*hi + hi*lo + hi*hi`` summed in fp32, then the port's
  epilogue.  Held against the reference's Pallas kernel in interpret mode
  at ``chip_smoke.KERNEL_TOL`` on the stem's blocks, a 7x7 layer with
  K = 4,608 and a stride-2 layer; one TF32 product alone misses that
  tolerance at K = 4,608, which is why the kernel takes three.
* The wide route's loop, emulated: B split once (``split_weight``) in its
  k order, A split the same way in registers, each stage's 12 products
  (three for each k step of 8, in the stage's k order) summed toward zero
  from zero and the stages to nearest; held against the Pallas kernel
  and within the drift test's bounds.
* B3's fp32 route takes the head dim of every ``ARCHS`` entry with
  attention.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.epilogue import EpilogueSpec as REpilogue
from repro.core.epilogue import PoolSpec as RPool
from repro.core.schedule import ConvSchedule
from repro.kernels.conv2d_nchwc import conv2d_nchwc_pallas
from repro_torch.configs import ARCHS
from repro_torch.core.epilogue import EpilogueSpec, PoolSpec
from repro_torch.kernels import conv2d_nchwc as kmod
from repro_torch.kernels import flash_attention as fa


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()
KERNEL_TOL = SMOKE.KERNEL_TOL


# ---------------------------------------------------------------------------
# the route table and the launch plans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 8], ids=["batch1", "batch8"])
def resnet_convs(request):
    convs = SMOKE.plan_convs("resnet-50", request.param, 224)
    assert sum(c["count"] for c in convs) == 53
    return convs


def test_route_takes_every_resnet50_plan_conv(resnet_convs):
    # distinct convs of the H100 plan (B1's tile): 25 at batch 1, 24 at 8;
    # the wide route takes 4 of a batch-1 predict's 53 (the 56x56 layers
    # with 256 columns) and 36 of a batch-8 one's
    batch = resnet_convs[0]["wl"].batch
    assert len(resnet_convs) == {1: 25, 8: 24}[batch]
    wide = 0
    for c in resnet_convs:
        route = kmod._route(*SMOKE.plan_shapes(c))
        assert route in ("sm90", "sm90_wide"), SMOKE.wl_name(c)
        assert route == kmod.launch_plan(*SMOKE.plan_shapes(c))["route"]
        wide += c["count"] * (route == "sm90_wide")
    assert wide == {1: 4, 8: 36}[batch]


@pytest.mark.parametrize("name", ["densenet_concat", "avgpool_ceil_asym"])
def test_route_takes_the_extra_cases(name):
    (c,) = [c for c in SMOKE.extra_cases() if c["name"] == name]
    assert kmod._route(*SMOKE.plan_shapes(c)) == "sm90"


@pytest.mark.parametrize("name,bn", [("densenet_concat_b32", 64),
                                     ("inception_1x7_b32", 128)])
def test_wide_route_takes_the_wide_cases(name, bn):
    """chip_smoke's edges of the wide route: a concat write with its
    copy-through (32 columns: the 64-column tile) and Inception's 1x7."""
    (c,) = [c for c in SMOKE.wide_cases() if c["name"] == name]
    p = kmod.launch_plan(*SMOKE.plan_shapes(c))
    assert kmod._route(*SMOKE.plan_shapes(c)) == "sm90_wide"
    assert (p["bm"], p["bn"], p["cs"]) == (128, bn, 1)
    assert 2 * p["tiles_m"] * p["tiles_n"] >= kmod.SMS


def test_launch_plans_fit_the_card(resnet_convs):
    for c in resnet_convs + SMOKE.extra_cases():
        x, w, stride, spec = SMOKE.plan_shapes(c)
        p = kmod.launch_plan(x, w, stride, spec)
        kt = -(-x[1] * w[2] * w[3] * x[4] // kmod.BK)
        assert p["smem"] <= kmod.SMEM_MAX
        assert p["tiles_m"] <= 65535
        assert p["cs"] in (1, 2, 4, 8)
        assert p["kt_per"] * p["cs"] >= kt > (p["cs"] - 1) * p["kt_per"]
        assert p["tiles_n"] * p["bn"] >= w[0] * w[5]
        if spec.pool is not None:
            assert p["cs"] == 1
        assert p["vec"] == (4 if x[4] % 4 == 0 else 1)
        if p["route"] == "sm90_wide":
            assert p["cs"] == 1 and p["bm"] == kmod.WIDE_BM
            assert p["smem"] == kmod.wide_smem_bytes(p["bn"])
            assert p["tiles_m"] * kmod.WIDE_BM >= x[0] * (
                (x[2] - w[2]) // stride + 1) * ((x[3] - w[3]) // stride + 1)


def test_small_layers_split_k_to_fill_the_card():
    """A 7x7 layer at batch 1 has one row tile: K is split over a cluster
    of 8 (c512 -> k512, K = 4,608), and the grid has 64 blocks where the
    output tiles alone give 8."""
    c = [c for c in SMOKE.plan_convs("resnet-50", 1, 224)
         if SMOKE.wl_name(c) == "c512_k512_h7_r3_s1_p1_ic64_oc64"][0]
    p = kmod.launch_plan(*SMOKE.plan_shapes(c))
    assert (p["tiles_m"], p["cs"]) == (1, 8)
    assert p["tiles_m"] * p["tiles_n"] * p["cs"] == 64


@pytest.mark.parametrize("batch", [1, 8])
def test_stem_pooled_patch_recomputes_at_most_1_25x(batch):
    (stem,) = [c for c in SMOKE.plan_convs("resnet-50", batch, 224)
               if c["wl"].fused_pool]
    p = kmod.launch_plan(*SMOKE.plan_shapes(stem))
    assert (p["pph"], p["ppw"], p["ch"], p["cw"]) == (8, 8, 17, 17)
    assert p["recompute"] <= 1.25 and p["mma_rows"] <= 1.25
    assert p["tiles_m"] == batch * 49


def test_route_refuses_other_dtypes():
    spec = EpilogueSpec()
    with pytest.raises(TypeError, match="float32"):
        kmod._route((1, 1, 5, 5, 4), (1, 1, 3, 3, 4, 4), 1, spec,
                    torch.float64)
    with pytest.raises(ValueError, match="matmul-tail"):
        kmod._route((1, 1, 5, 5, 4), (1, 1, 3, 3, 4, 4), 1,
                    EpilogueSpec(softmax=True))


def test_smem_bytes_is_the_kernels_layout():
    """Two stages of (64 + 64) rows x 128 bytes, hi and lo; three row
    tables of 64 ints; the k-offset table; the patch rows of 64 + 4
    floats; 1,024 bytes of slack.  The wide route: six stages of B's hi
    and lo (BN rows x 128 bytes each), two 8-byte barriers a stage, 1,024
    bytes of slack."""
    assert kmod.smem_bytes(5, 289) == \
        65536 + 768 + 640 + 289 * 68 * 4 + 1024
    assert kmod.smem_bytes(2, 0) == 65536 + 768 + 256 + 1024
    assert kmod.wide_smem_bytes(128) == 6 * 2 * 16384 + 96 + 1024
    assert kmod.wide_smem_bytes(64) == 6 * 2 * 8192 + 96 + 1024
    assert max(map(kmod.wide_smem_bytes, kmod.WIDE_BN)) <= kmod.SMEM_MAX


# ---------------------------------------------------------------------------
# the wide route's choice at the benchmark's two cells
# ---------------------------------------------------------------------------

# ResNet-50 at batch 32 (resnet50.offline): every distinct conv of the
# plan, its route and tile width.  The RGB stem (pooled, 4-byte loads)
# keeps the sm90 route; the other 52 convs of a predict take the wide one:
# 64 columns where N is 64, and where 128 would leave a grid of 1-2 waves
# worse filled (the 7x7 stage's 52 tiles become 104; 196 become 392).
RESNET50_B32 = {
    "c3_k64_h224_r7_s2_p3_ic3_oc64_maxpool": ("sm90", 64),
    "c64_k64_h56_r1_s1_p0_ic64_oc64": ("sm90_wide", 64),
    "c64_k64_h56_r3_s1_p1_ic64_oc64": ("sm90_wide", 64),
    "c64_k256_h56_r1_s1_p0_ic64_oc256": ("sm90_wide", 128),
    "c64_k256_h56_r1_s1_p0_ic64_oc256_res": ("sm90_wide", 128),
    "c256_k64_h56_r1_s1_p0_ic256_oc64": ("sm90_wide", 64),
    "c256_k128_h56_r1_s1_p0_ic256_oc128": ("sm90_wide", 128),
    "c128_k128_h56_r3_s2_p1_ic128_oc128": ("sm90_wide", 64),
    "c256_k512_h56_r1_s2_p0_ic256_oc512": ("sm90_wide", 128),
    "c128_k512_h28_r1_s1_p0_ic128_oc512_res": ("sm90_wide", 128),
    "c512_k128_h28_r1_s1_p0_ic512_oc128": ("sm90_wide", 64),
    "c128_k128_h28_r3_s1_p1_ic128_oc128": ("sm90_wide", 64),
    "c512_k256_h28_r1_s1_p0_ic512_oc128": ("sm90_wide", 128),
    "c256_k256_h28_r3_s2_p1_ic128_oc128": ("sm90_wide", 128),
    "c512_k1024_h28_r1_s2_p0_ic512_oc1024": ("sm90_wide", 128),
    "c256_k1024_h14_r1_s1_p0_ic128_oc1024_res": ("sm90_wide", 128),
    "c1024_k256_h14_r1_s1_p0_ic1024_oc128": ("sm90_wide", 128),
    "c256_k256_h14_r3_s1_p1_ic128_oc128": ("sm90_wide", 128),
    "c1024_k512_h14_r1_s1_p0_ic1024_oc128": ("sm90_wide", 64),
    "c512_k512_h14_r3_s2_p1_ic128_oc512": ("sm90_wide", 64),
    "c1024_k2048_h14_r1_s2_p0_ic1024_oc2048": ("sm90_wide", 128),
    "c512_k2048_h7_r1_s1_p0_ic512_oc2048_res": ("sm90_wide", 128),
    "c2048_k512_h7_r1_s1_p0_ic2048_oc512": ("sm90_wide", 64),
    "c512_k512_h7_r3_s1_p1_ic32_oc512": ("sm90_wide", 64),
}
# VGG-16 at batch 1 (vgg16.single_stream): the pooled convs and the RGB
# first keep the sm90 route, so do the 28x28 and 14x14 ones (too few
# 128-row tiles); s2c1, s3c1 and s3c2 take the wide one
VGG16_B1 = {
    "c3_k64_h224_r3_s1_p1_ic3_oc64": ("sm90", 64),
    "c64_k64_h224_r3_s1_p1_ic64_oc64_maxpool": ("sm90", 64),
    "c64_k128_h112_r3_s1_p1_ic64_oc128": ("sm90_wide", 128),
    "c128_k128_h112_r3_s1_p1_ic128_oc128_maxpool": ("sm90", 64),
    "c128_k256_h56_r3_s1_p1_ic128_oc64": ("sm90_wide", 64),
    "c256_k256_h56_r3_s1_p1_ic64_oc64": ("sm90_wide", 64),
    "c256_k256_h56_r3_s1_p1_ic64_oc64_maxpool": ("sm90", 64),
    "c256_k512_h28_r3_s1_p1_ic64_oc64": ("sm90", 64),
    "c512_k512_h28_r3_s1_p1_ic64_oc64": ("sm90", 64),
    "c512_k512_h28_r3_s1_p1_ic64_oc64_maxpool": ("sm90", 64),
    "c512_k512_h14_r3_s1_p1_ic64_oc64": ("sm90", 64),
    "c512_k512_h14_r3_s1_p1_ic64_oc64_maxpool": ("sm90", 64),
}
CELL_PLANS = {("resnet-50", 32): RESNET50_B32, ("vgg-16", 1): VGG16_B1}


@functools.lru_cache(maxsize=None)
def _cell_convs(model: str, batch: int) -> dict:
    return {SMOKE.wl_name(c): c for c in SMOKE.plan_convs(model, batch, 224)}


@pytest.mark.parametrize("model,batch", sorted(CELL_PLANS))
def test_cell_plans_have_these_convs(model, batch):
    convs = _cell_convs(model, batch)
    assert set(convs) == set(CELL_PLANS[model, batch])
    wide = sum(c["count"] for name, c in convs.items()
               if CELL_PLANS[model, batch][name][0] == "sm90_wide")
    assert (wide, sum(c["count"] for c in convs.values())) == \
        {"resnet-50": (52, 53), "vgg-16": (3, 13)}[model]


@pytest.mark.parametrize("model,batch,name", [
    (m, b, name) for (m, b), table in sorted(CELL_PLANS.items())
    for name in table])
def test_cell_conv_route_and_tile(model, batch, name):
    """The route and tile width of one conv of a cell's plan; a wide grid
    fills half the card or more, each tile width's shared memory fits, and
    the wide plan covers the conv's M and N."""
    route, bn = CELL_PLANS[model, batch][name]
    c = _cell_convs(model, batch)[name]
    x, w, stride, spec = SMOKE.plan_shapes(c)
    p = kmod.launch_plan(x, w, stride, spec)
    assert kmod._route(x, w, stride, spec) == route
    assert (p["route"], p["bn"]) == (route, bn)
    assert p["smem"] <= kmod.SMEM_MAX
    oh, ow = (x[2] - w[2]) // stride + 1, (x[3] - w[3]) // stride + 1
    m, ncols = x[0] * oh * ow, w[0] * w[5]
    if route == "sm90_wide":
        assert p["bm"] == 128 and p["cs"] == 1
        assert p["tiles_m"] == -(-m // 128)
        assert p["tiles_n"] == -(-ncols // bn)
        assert 2 * p["tiles_m"] * p["tiles_n"] >= kmod.SMS
        assert p["smem"] == kmod.wide_smem_bytes(bn)
        assert kmod.wide_tile(m, ncols) == bn
    else:
        assert (p["bm"], p["bn"]) == (kmod.BM, kmod.BN)
        assert spec.pool is not None or x[4] % 32 or \
            kmod.wide_tile(m, ncols) == 0


@pytest.mark.parametrize("m,ncols,bn", [
    (1568, 512, 64),     # 7x7 at 32: 52 tiles of 128 columns, 104 of 64
    (1568, 2048, 128),   # 208 tiles: 2 waves at 128 or 4 at 64
    (6272, 256, 128),    # 14x14 at 32: 98 tiles, a wave, kept at 128
    (25088, 128, 64),    # 28x28 at 32: 196 tiles (2 waves) or 392 (3)
    (100352, 64, 64),    # 64 columns: the 64-column tile alone
    (392, 512, 0),       # 7x7 at 8: 32 tiles of 64, too few
    (49, 2048, 0),       # 7x7 at 1: one row tile
])
def test_wide_tile_by_shape(m, ncols, bn):
    assert kmod.wide_tile(m, ncols) == bn


# the sm90 plans that the wide route leaves as they were: (model, batch,
# conv) -> (cs, tiles_m, tiles_n, kt_per, smem)
KEPT_PLANS = {
    # the RGB stem, pooled, 4-byte loads, at 32 and 1
    ("resnet-50", 32, "c3_k64_h224_r7_s2_p3_ic3_oc64_maxpool"):
        (1, 32 * 49, 1, 5, 146576),
    ("resnet-50", 1, "c3_k64_h224_r7_s2_p3_ic3_oc64_maxpool"):
        (1, 49, 1, 5, 146576),
    # VGG-16's pooled 14x14 conv: K = 4,608 never split
    ("vgg-16", 1, "c512_k512_h14_r3_s1_p1_ic64_oc64_maxpool"):
        (1, 1, 8, 144, 139072),
    # batch 1's small layers, K split over a cluster
    ("resnet-50", 1, "c512_k512_h7_r3_s1_p1_ic64_oc64"):
        (8, 1, 8, 18, 69632),
    ("resnet-50", 1, "c2048_k512_h7_r1_s1_p0_ic64_oc64"):
        (8, 1, 8, 8, 68352),
    ("resnet-50", 1, "c1024_k2048_h14_r1_s2_p0_ic128_oc64"):
        (4, 1, 32, 8, 68352),
    ("vgg-16", 1, "c512_k512_h14_r3_s1_p1_ic64_oc64"):
        (4, 4, 8, 36, 71936),
}


@pytest.mark.parametrize("key", sorted(KEPT_PLANS),
                         ids=lambda k: f"{k[0]}-b{k[1]}-{k[2]}")
def test_pooled_rgb_and_small_layers_keep_the_sm90_plan(key):
    model, batch, name = key
    convs = {SMOKE.wl_name(c): c
             for c in SMOKE.plan_convs(model, batch, 224)}
    p = kmod.launch_plan(*SMOKE.plan_shapes(convs[name]))
    assert p["route"] == "sm90" and (p["bm"], p["bn"]) == (64, 64)
    assert (p["cs"], p["tiles_m"], p["tiles_n"], p["kt_per"],
            p["smem"]) == KEPT_PLANS[key]


# ---------------------------------------------------------------------------
# the 3xTF32 arithmetic, emulated
# ---------------------------------------------------------------------------

def rna_tf32(a: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: keep 10 stored mantissa bits, rounding to
    nearest with ties away from zero (add half of the dropped 13 bits'
    range to the magnitude, then cut them)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a: np.ndarray):
    hi = rna_tf32(a)
    return hi, rna_tf32((a - hi).astype(np.float32))


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                 # tf32's step at 1
    vals = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                     1 + 3 * 2.0 ** -12, 3.0], np.float32)
    np.testing.assert_array_equal(
        rna_tf32(vals), np.array([one + ulp, one, -(one + ulp), one + ulp,
                                  3.0], np.float32))
    a = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    hi, lo = split(a)
    assert np.all(np.abs(a - hi) <= 2.0 ** -11 * np.abs(a))
    assert np.all(np.abs(a - hi - lo) <= 2.0 ** -22 * np.abs(a))


def _gemm_operands(x, w, stride):
    """A (pixels, K) and B (K, channels) of the implicit GEMM, K in the
    weight's order (ci, dh, dw, ic)."""
    n, ci, hp, wp, icb = x.shape
    ko, _, kh, kw, _, ocb = w.shape
    oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    cols = [x[:, c, dh:dh + oh * stride:stride, dw:dw + ow * stride:stride]
            for c in range(ci) for dh in range(kh) for dw in range(kw)]
    a = np.concatenate(cols, axis=-1).reshape(n * oh * ow, -1)
    b = w.transpose(1, 2, 3, 4, 0, 5).reshape(ci * kh * kw * icb, ko * ocb)
    return a, b, (n, oh, ow, ko, ocb)


def emulate(x: np.ndarray, w: np.ndarray, stride: int, products: int = 3):
    """The kernel's implicit GEMM on blocked numpy operands: A (pixels, K)
    and B (K, channels) in the weight's K order (ci, dh, dw, ic), each
    split into tf32 hi and lo, and ``lo@hi + hi@lo + hi@hi`` in fp32
    (``products=1``: ``hi@hi`` alone).  Returns the fp32 sums as
    (n, Ko, oh, ow, oc_bn)."""
    a, b, shape = _gemm_operands(x, w, stride)
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    acc = a_hi @ b_hi
    if products == 3:
        acc = (a_lo @ b_hi + a_hi @ b_lo) + acc
    return acc.astype(np.float32).reshape(shape).transpose(0, 3, 1, 2, 4)


# (name, batch, cin, cout, hw, k, stride, pad, ic_bn, oc_bn, pool):
# ResNet-50's stem blocks (K = 147, max pool) at a 32x32 image, its
# c512 -> k512 7x7 layer (K = 4,608) and its stride-2 c256 -> k256 layer
EMU_CASES = [
    ("stem_ic3_maxpool", 1, 3, 64, 32, 7, 2, 3, 3, 64, "max"),
    ("c512_k512_h7_k4608", 1, 512, 512, 7, 3, 1, 1, 32, 128, None),
    ("c256_k256_h28_s2", 1, 256, 256, 28, 3, 2, 1, 16, 256, None),
]


def _emu_operands(case):
    _, batch, cin, cout, hw, k, stride, pad, icb, ocb, pool = case
    rng = np.random.default_rng(3)
    x = rng.normal(size=(batch, cin // icb, hw + 2 * pad, hw + 2 * pad, icb))
    x[:, :, :pad] = x[:, :, -pad:] = 0
    x[:, :, :, :pad] = x[:, :, :, -pad:] = 0
    w = rng.normal(0, np.sqrt(2.0 / (cin * k * k)),
                   size=(cout // ocb, cin // icb, k, k, icb, ocb))
    shift = rng.normal(0, 0.1, size=(cout // ocb, ocb))
    return [np.asarray(v, np.float32) for v in (x, w, shift)]


def _pallas(x, w, shift, stride, pool):
    oh = (x.shape[2] - w.shape[2]) // stride + 1
    ow = (x.shape[3] - w.shape[3]) // stride + 1
    spec = REpilogue(relu=True,
                     pool=RPool(pool, 3, 2, 1) if pool else None)
    sched = ConvSchedule(x.shape[-1], w.shape[-1], ow_bn=ow, oh_bn=oh)
    return np.asarray(conv2d_nchwc_pallas(
        jnp.asarray(x), jnp.asarray(w), None, jnp.asarray(shift), None,
        None, stride=stride, schedule=sched, epilogue=spec, interpret=True))


def _port_epilogue(acc, shift, pool):
    spec = EpilogueSpec(relu=True,
                        pool=PoolSpec(pool, 3, 2, 1) if pool else None)
    return kmod.apply_epilogue_fp32(torch.from_numpy(acc), None,
                                    torch.from_numpy(shift), None,
                                    spec).numpy()


@pytest.fixture(scope="module", params=EMU_CASES, ids=[c[0] for c in
                                                       EMU_CASES])
def emu_case(request):
    case = request.param
    x, w, shift = _emu_operands(case)
    stride, pool = case[6], case[10]
    return {"case": case, "x": x, "w": w, "shift": shift,
            "want": _pallas(x, w, shift, stride, pool)}


def test_3xtf32_emulation_matches_pallas(emu_case):
    c = emu_case
    _, _, _, _, _, _, stride, _, _, _, pool = c["case"]
    got = _port_epilogue(emulate(c["x"], c["w"], stride), c["shift"], pool)
    np.testing.assert_allclose(got, c["want"], **KERNEL_TOL)


def test_1xtf32_misses_the_tolerance_at_k4608(emu_case):
    """The precision decision: at K = 4,608 one TF32 product (hi@hi) is
    outside KERNEL_TOL of the reference, so the kernel takes three; at the
    stem's K = 147 all three are within it."""
    c = emu_case
    name, _, _, _, _, _, stride, _, _, _, pool = c["case"]
    got = _port_epilogue(emulate(c["x"], c["w"], stride, products=1),
                         c["shift"], pool)
    excess = np.abs(got - c["want"]) - (KERNEL_TOL["atol"]
                                        + KERNEL_TOL["rtol"]
                                        * np.abs(c["want"]))
    if name == "c512_k512_h7_k4608":
        assert excess.max() > 0
    three = _port_epilogue(emulate(c["x"], c["w"], stride), c["shift"],
                           pool)
    assert np.abs(three - c["want"]).max() < np.abs(got - c["want"]).max()


def rz32(x: np.ndarray) -> np.ndarray:
    """fp64 to fp32 rounding toward zero, as the tensor cores add into
    their fp32 accumulator."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def test_round_toward_zero_accumulator_drifts_per_stage_sums_hold():
    """Why each stage's 12 wgmmas start from zero.  A model of the tensor
    cores (every wgmma's k = 8 sum added to the fp32 accumulator rounding
    toward zero) on the 7x7 layer with K = 4,608: one accumulator over all
    1,728 wgmmas shrinks the outputs toward zero (by ~3e-5 of their
    magnitude, weighted: the drift that cost ResNet-50's logits 4e-5 on
    the card); per-stage sums (12 wgmmas, then added rounding to nearest)
    drift a tenth as much and stay well inside KERNEL_TOL."""
    x, w, _ = _emu_operands(EMU_CASES[1])
    n, ci, hp, wp, icb = x.shape
    ko, _, kh, kw, _, ocb = w.shape
    oh, ow = hp - kh + 1, wp - kw + 1
    cols = [x[:, c, dh:dh + oh, dw:dw + ow] for c in range(ci)
            for dh in range(kh) for dw in range(kw)]
    a = np.concatenate(cols, axis=-1).reshape(n * oh * ow, -1)
    b = w.transpose(1, 2, 3, 4, 0, 5).reshape(ci * kh * kw * icb, ko * ocb)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    one = np.zeros(exact.shape, np.float32)
    staged = np.zeros(exact.shape, np.float32)
    for k0 in range(0, a.shape[1], 32):          # a stage: 4 steps of 8
        stage = np.zeros(exact.shape, np.float32)
        for k in range(k0, k0 + 32, 8):
            for pa, pb in pairs:
                prod = pa[:, k:k + 8].astype(np.float64) \
                    @ pb[k:k + 8].astype(np.float64)
                one = rz32(one + prod)
                stage = rz32(stage + prod)
        staged = staged + stage                  # fp32, to nearest
    def outward(v):    # signed error away from zero, over sum |exact|
        return float(((v - exact) * np.sign(exact)).sum()
                     / np.abs(exact).sum())

    drift, staged_drift = outward(one), outward(staged)
    assert drift < -1e-5                          # toward zero
    assert abs(staged_drift) < abs(drift) / 10
    assert np.abs(staged - exact).max() < np.abs(one - exact).max() / 4
    np.testing.assert_allclose(staged, exact, **KERNEL_TOL)


# ---------------------------------------------------------------------------
# the wide route's loop, emulated
# ---------------------------------------------------------------------------

def _stage_order(k: int) -> np.ndarray:
    """The wide route's k slots: stage g's slot p holds k 32 g +
    WIDE_K_ORDER[p]."""
    return np.concatenate([32 * g + np.array(kmod.WIDE_K_ORDER)
                           for g in range(k // 32)])


def emulate_wide(x, w, stride):
    """The wide route's loop: A split into hi and lo in registers, B from
    ``split_weight`` (hi and lo, each stage's k in ``WIDE_K_ORDER``), each
    stage of 32 k slots summed from zero on a model of the tensor cores
    (every product of a k step of 8 slots added rounding toward zero:
    lo*hi, hi*lo, hi*hi), the stage sums added to the fp32 sums rounding to
    nearest.  Returns the sums as (n, Ko, oh, ow, oc_bn)."""
    a, _, shape = _gemm_operands(x, w, stride)
    bs = kmod.split_weight(torch.from_numpy(w)).numpy()
    b_hi, b_lo = bs[0].T, bs[1].T                   # (K in slots, N)
    a_hi, a_lo = (t[:, _stage_order(a.shape[1])] for t in split(a))
    acc = np.zeros((a.shape[0], b_hi.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 32):
        stage = np.zeros_like(acc)
        for k in range(k0, k0 + 32, 8):
            for pa, pb in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                stage = rz32(stage + pa[:, k:k + 8].astype(np.float64)
                             @ pb[k:k + 8].astype(np.float64))
        acc = acc + stage
    return acc.reshape(shape).transpose(0, 3, 1, 2, 4)


def test_wide_k_order_is_each_threads_loads():
    """Every k of a stage once; thread c's slots c and c + 4 over the four
    k steps are the 8 values it loads, k 4c .. 4c + 3 then 16 + 4c ..
    16 + 4c + 3, two of them a step."""
    order = np.array(kmod.WIDE_K_ORDER).reshape(4, 8)     # (kk, slot)
    assert sorted(order.ravel()) == list(range(32))
    for c in range(4):
        got = [v for kk in range(4) for v in (order[kk, c], order[kk, c + 4])]
        assert got == [4 * c + i for i in range(4)] + \
            [16 + 4 * c + i for i in range(4)]


def test_split_weight_is_the_routes_b():
    """``split_weight``'s hi and lo are the threads' split of the sm90
    route (``cvt.rna`` twice) bit for bit, each output channel's K in a row,
    each stage's k in the wide order."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(2, 3, 3, 3, 32, 16)).astype(np.float32)
    bs = kmod.split_weight(torch.from_numpy(w)).numpy()
    b = w.transpose(0, 5, 1, 2, 3, 4).reshape(32, -1)       # (N, K)
    hi, lo = split(b)
    order = _stage_order(b.shape[1])
    assert bs.shape == (2, 32, 864)
    np.testing.assert_array_equal(bs[0], hi[:, order])
    np.testing.assert_array_equal(bs[1], lo[:, order])
    np.testing.assert_array_equal(
        kmod.rna_tf32(torch.from_numpy(b)).numpy(), hi)


# the wide route's cases (ic_bn % 32 == 0): the 7x7 layer with K = 4,608,
# and a stride-2 14x14 3x3 layer (K = 2,304)
WIDE_EMU_CASES = [
    EMU_CASES[1],
    ("c256_k256_h14_s2_ic32", 1, 256, 256, 14, 3, 2, 1, 32, 128, None),
]


@pytest.fixture(scope="module", params=WIDE_EMU_CASES,
                ids=[c[0] for c in WIDE_EMU_CASES])
def wide_case(request):
    case = request.param
    x, w, shift = _emu_operands(case)
    return {"case": case, "x": x, "w": w, "shift": shift,
            "want": _pallas(x, w, shift, case[6], None)}


def test_wide_loop_emulation_matches_pallas(wide_case):
    c = wide_case
    got = _port_epilogue(emulate_wide(c["x"], c["w"], c["case"][6]),
                         c["shift"], None)
    np.testing.assert_allclose(got, c["want"], **KERNEL_TOL)


def test_wide_loop_drifts_no_more_than_the_sm90_loop():
    """The wide order changes which products meet in which k step, not how
    often the sums are rounded: on the 7x7 layer (K = 4,608) its drift
    toward zero, like the sm90 route's per-stage sums, stays a tenth of
    one accumulator's (``test_round_toward_zero_accumulator_...``)."""
    x, w, _ = _emu_operands(EMU_CASES[1])
    a, b, shape = _gemm_operands(x, w, 1)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    wide = emulate_wide(x, w, 1).transpose(0, 2, 3, 1, 4).reshape(
        exact.shape)
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    one = np.zeros(exact.shape, np.float32)
    for k in range(0, a.shape[1], 8):
        for pa, pb in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            one = rz32(one + pa[:, k:k + 8].astype(np.float64)
                       @ pb[k:k + 8].astype(np.float64))

    def outward(v):
        return float(((v - exact) * np.sign(exact)).sum()
                     / np.abs(exact).sum())

    assert abs(outward(wide)) < abs(outward(one)) / 10
    np.testing.assert_allclose(wide, exact, **KERNEL_TOL)


# ---------------------------------------------------------------------------
# B3's fp32 route: every head dim of ARCHS (ROADMAP C1)
# ---------------------------------------------------------------------------

ATTN_ARCHS = sorted(name for name, cfg in ARCHS.items()
                    if cfg.n_heads and cfg.head_dim)


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_fp32_attention_route_takes_every_arch_head_dim(name):
    d = ARCHS[name].head_dim
    assert fa._route(torch.float32, d) == "fma"
    assert fa._route(torch.bfloat16, d) == "sm90"


def test_fp32_attention_route_takes_every_multiple_of_16():
    assert fa.HEAD_DIMS["fma"] == fa.HEAD_DIMS["sm90"] == tuple(
        range(16, 257, 16))
