"""B1's route and arithmetic, on the CPU.

* ``_route`` sends every conv of ResNet-50's plan (batch 1 and 8) and
  both of ``chip_smoke.extra_cases()`` to the sm90 kernel, and its launch
  plans fit the card: shared memory, grid, cluster split, and the stem's
  pooled patch recomputing at most 1.25x its conv work.
* The kernel's arithmetic, emulated in numpy: each fp32 operand split into
  ``hi = tf32(a)`` and ``lo = tf32(a - hi)`` with ``cvt.rna`` semantics
  (round to nearest, ties away from zero, 10 stored mantissa bits), the
  products ``lo*hi + hi*lo + hi*hi`` summed in fp32, then the port's
  epilogue.  Held against the reference's Pallas kernel in interpret mode
  at ``chip_smoke.KERNEL_TOL`` on the stem's blocks, a 7x7 layer with
  K = 4,608 and a stride-2 layer; one TF32 product alone misses that
  tolerance at K = 4,608, which is why the kernel takes three.
* B3's fp32 route takes the head dim of every ``ARCHS`` entry with
  attention.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""
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
    # distinct convs of the H100 plan (B1's tile): 25 at batch 1, 24 at 8
    assert len(resnet_convs) == {1: 25, 8: 24}[resnet_convs[0]["wl"].batch]
    for c in resnet_convs:
        assert kmod._route(*SMOKE.plan_shapes(c)) == "sm90", \
            SMOKE.wl_name(c)


@pytest.mark.parametrize("name", ["densenet_concat", "avgpool_ceil_asym"])
def test_route_takes_the_extra_cases(name):
    (c,) = [c for c in SMOKE.extra_cases() if c["name"] == name]
    assert kmod._route(*SMOKE.plan_shapes(c)) == "sm90"


def test_launch_plans_fit_the_card(resnet_convs):
    for c in resnet_convs + SMOKE.extra_cases():
        x, w, stride, spec = SMOKE.plan_shapes(c)
        p = kmod.launch_plan(x, w, stride, spec)
        kt = -(-x[1] * w[2] * w[3] * x[4] // kmod.BK)
        assert p["smem"] <= kmod.SMEM_MAX
        assert p["tiles_m"] <= 65535
        assert p["cs"] in (1, 2, 4, 8)
        assert p["kt_per"] * p["cs"] >= kt > (p["cs"] - 1) * p["kt_per"]
        assert p["tiles_n"] * kmod.BN >= w[0] * w[5]
        if spec.pool is not None:
            assert p["cs"] == 1
        assert p["vec"] == (4 if x[4] % 4 == 0 else 1)


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
    floats; 1,024 bytes of slack."""
    assert kmod.smem_bytes(5, 289) == \
        65536 + 768 + 640 + 289 * 68 * 4 + 1024
    assert kmod.smem_bytes(2, 0) == 65536 + 768 + 256 + 1024


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


def emulate(x: np.ndarray, w: np.ndarray, stride: int, products: int = 3):
    """The kernel's implicit GEMM on blocked numpy operands: A (pixels, K)
    and B (K, channels) in the weight's K order (ci, dh, dw, ic), each
    split into tf32 hi and lo, and ``lo@hi + hi@lo + hi@hi`` in fp32
    (``products=1``: ``hi@hi`` alone).  Returns the fp32 sums as
    (n, Ko, oh, ow, oc_bn)."""
    n, ci, hp, wp, icb = x.shape
    ko, _, kh, kw, _, ocb = w.shape
    oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    cols = [x[:, c, dh:dh + oh * stride:stride, dw:dw + ow * stride:stride]
            for c in range(ci) for dh in range(kh) for dw in range(kw)]
    a = np.concatenate(cols, axis=-1).reshape(n * oh * ow, -1)
    b = w.transpose(1, 2, 3, 4, 0, 5).reshape(ci * kh * kw * icb, ko * ocb)
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    acc = a_hi @ b_hi
    if products == 3:
        acc = (a_lo @ b_hi + a_hi @ b_lo) + acc
    return acc.astype(np.float32).reshape(n, oh, ow, ko, ocb) \
        .transpose(0, 3, 1, 2, 4)


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
