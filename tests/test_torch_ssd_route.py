"""B4's launch plan and arithmetic, on the CPU.

* ``launch_plan`` fits the card at mamba2-130m's prefill shapes (BC = 2, 4
  and 8), the reduced config's chunk (Q = 8) and the card tests' ragged
  cases: shared memory, grid, heads a block, and at least 132 blocks at
  BC = 8.
* The kernel's arithmetic, emulated in numpy: each fp32 operand split into
  ``hi = tf32(a)`` and ``lo = tf32(a - hi)`` with ``cvt.rna`` semantics,
  the products ``lo*hi + hi*lo + hi*hi`` in k steps of 8, each stage's
  wgmmas (k = N for a score tile, 64 for a head's product) summed afresh
  (rounding toward zero, as the tensor cores add) and the stages added in
  fp32 to nearest; the score tile formed once per
  column tile for every head of a group; the mask applied to the exponent
  before the exponential.  Held against the reference's Pallas kernel in
  interpret mode at ``chip_smoke.SSD_TOL`` at mamba2-130m's chunk with
  slow, steep and no decay.  One TF32 product alone misses that
  tolerance, which is why the kernel takes three.
* A model of the round-toward-zero accumulator: per-stage sums hold.

The kernel itself runs only on the card: ``tests/test_torch_lm_cuda.py``.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ssd_intra_pallas
from repro_torch.kernels import ssd_chunk as sc


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()
SSD_TOL = SMOKE.SSD_TOL

# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

# (BC, H, Q, N, P): mamba2-130m's prefill at 512, 1,024 and 2,048 tokens,
# the reduced config's chunk, and the card tests' cases
PLAN_CASES = [(2, 24, 256, 128, 64), (4, 24, 256, 128, 64),
              (8, 24, 256, 128, 64), (3, 8, 8, 16, 16),
              (1, 24, 256, 128, 64), (1, 3, 100, 20, 40),
              (8, 23, 256, 128, 64)]


@pytest.mark.parametrize("bcn,h,q,n,p", PLAN_CASES)
def test_launch_plan_fits_the_card(bcn, h, q, n, p):
    plan = sc.launch_plan(bcn, h, q, n, p)
    assert plan["smem"] <= sc.SMEM_MAX
    assert plan["heads"] in sc.HEADS
    g = plan["groups"]
    assert g * plan["heads"] >= h > (g - 1) * plan["heads"]
    assert plan["tiles"] * sc.T >= q > (plan["tiles"] - 1) * sc.T
    assert n <= sc.MAX_N
    assert plan["grid"] == (g, bcn, plan["tiles"])
    assert plan["blocks"] == g * bcn * plan["tiles"]
    assert max(plan["grid"][1:]) <= 65535
    assert plan["threads"] == 256


def test_smem_is_the_kernels_layout():
    """Two stages and the block's C_i, each 64 x 128 fp32 in tf32 hi and
    lo, the fp32 score tile in rows of 68 floats, column decays (2 stages x
    2 heads x 132 floats) and row decays (4 heads x 64), plus 1,024 bytes
    that align them: within the 227 KB a block may have."""
    assert sc.SMEM == 3 * 2 * 64 * 128 * 4 + 64 * 68 * 4 \
        + 2 * 2 * 132 * 4 + 4 * 64 * 4 + 1024 == 218176
    assert sc.SMEM <= sc.SMEM_MAX


@pytest.mark.parametrize("bcn,heads", [(8, 4), (4, 2), (2, 2)])
def test_plan_fills_the_card_at_mamba2_shapes(bcn, heads):
    """The scores are shared by 4 heads at 2,048 tokens, where the grid
    has blocks to spare (192 for 132 SMs), and by 2 where BC leaves fewer
    (chunk, row tile) pairs; at 512 tokens the 96 blocks leave SMs idle,
    but the longest block sets the time either way."""
    plan = sc.launch_plan(bcn, 24, 256, 128, 64)
    assert plan["heads"] == heads
    assert plan["blocks"] >= (sc.SMS if bcn > 2 else 96)
    # where the SMs are full, the longest block (row tile 3: 4 column
    # tiles) takes at most twice the stages an SM runs on average
    if bcn > 2:
        assert plan["longest"] <= 2 * plan["stages"] / sc.SMS


def test_plan_takes_a_head_group_that_does_not_divide_h():
    plan = sc.launch_plan(8, 23, 256, 128, 64)
    assert 23 % plan["heads"] != 0


# ---------------------------------------------------------------------------
# the 3xTF32 arithmetic, emulated
# ---------------------------------------------------------------------------

def rna_tf32(a: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: keep 10 stored mantissa bits, rounding to
    nearest with ties away from zero."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a: np.ndarray):
    hi = rna_tf32(a)
    return hi, rna_tf32((a - hi).astype(np.float32))


def rz32(x: np.ndarray) -> np.ndarray:
    """fp64 to fp32 rounding toward zero, as the tensor cores add into
    their fp32 accumulator."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def wgmmas(a: np.ndarray, b: np.ndarray, products: int):
    """One stage's wgmmas, in the kernel's order: per k step of 8 the
    products lo*hi, hi*lo, hi*hi (``products=1``: hi*hi alone) of a (M, K)
    and b (K, N), each exact (tf32 products are exact in fp64)."""
    (ah, al), (bh, bl) = split(a), split(b)
    pairs = [(al, bh), (ah, bl), (ah, bh)] if products == 3 else [(ah, bh)]
    for k in range(0, a.shape[1], 8):
        for pa, pb in pairs:
            yield pa[:, k:k + 8].astype(np.float64) \
                @ pb[k:k + 8].astype(np.float64)


def add_stage(acc, a, b, products=3, rounding="stage"):
    """acc (fp32) plus one stage: ``stage``, the kernel: each wgmma into a
    fresh sum rounding toward zero, the stage's sum added to acc in fp32 to
    nearest; ``one``: each wgmma into acc itself rounding toward zero."""
    if rounding == "one":
        for prod in wgmmas(a, b, products):
            acc = rz32(acc + prod)
        return acc
    st = np.zeros(acc.shape, np.float32)
    for prod in wgmmas(a, b, products):
        st = rz32(st + prod)
    return (acc + st).astype(np.float32)


def pad_to(a: np.ndarray, shape) -> np.ndarray:
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def emulate(cc, bc, acum, xd, heads, products=3, rounding="stage"):
    """The kernel on numpy fp32 operands, block by block: for each chunk,
    row tile and group of ``heads`` heads, each column tile's scores S
    (one stage, k = N) formed once for the group, then per head
    P X in one stage, added to the head's sums.  On the diagonal tile
    P = S * exp(d) with d = acum_i - acum_j where j <= i < Q and -inf
    elsewhere (the mask before the exponential); below it P = S times the
    column factors exp(acum_ref - acum_j), and the stage's sums are scaled
    by the row factors exp(acum_i - acum_ref), ref the tile's last column
    (the kernel's exp is ex2.approx, within ~2^-22 of this one, and it
    adds the scaled sums in one fma).  Ragged shapes are zeros, as in
    shared memory."""
    bcn, q, n = cc.shape
    _, h, _, p = xd.shape
    t = sc.T
    tiles = -(-q // t)
    qq = tiles * t
    cp, bp = (pad_to(a, (bcn, qq, -(-n // 8) * 8)) for a in (cc, bc))
    ap = pad_to(acum, (bcn, h, qq))
    xp = pad_to(xd, (bcn, h, qq, 64))
    y = np.zeros((bcn, h, qq, 64), np.float32)
    for g in range(bcn):
        for rt in range(tiles):
            i0 = rt * t
            rows = np.arange(i0, i0 + t)[:, None]
            for h0 in range(0, h, heads):
                group = range(h0, min(h0 + heads, h))
                acc = {k: np.zeros((t, 64), np.float32) for k in group}
                for jt in range(rt + 1):
                    j0 = jt * t
                    cols = np.arange(j0, j0 + t)[None, :]
                    s = add_stage(np.zeros((t, t), np.float32),
                                  cp[g, i0:i0 + t], bp[g, j0:j0 + t].T,
                                  products, rounding)
                    for k in group:
                        ai, aj = ap[g, k, i0:i0 + t], ap[g, k, j0:j0 + t]
                        if jt == rt:
                            d = np.where((cols <= rows) & (rows < q),
                                         ai[:, None] - aj[None, :], -np.inf)
                            pm = s * np.exp(d.astype(np.float32))
                            rf = np.ones((t, 1), np.float32)
                        else:
                            ref = aj[-1]
                            pm = s * np.exp(ref - aj)[None, :]
                            rf = np.exp(ai - ref)[:, None]
                        if rounding == "one":   # no stage sums at all
                            acc[k] = add_stage(acc[k], (pm * rf).astype(
                                np.float32), xp[g, k, j0:j0 + t], products,
                                rounding)
                            continue
                        part = add_stage(np.zeros((t, 64), np.float32),
                                         pm.astype(np.float32),
                                         xp[g, k, j0:j0 + t], products,
                                         rounding)
                        acc[k] = (acc[k] + rf * part).astype(np.float32)
                for k in group:
                    y[g, k, i0:i0 + t] = acc[k]
    return y[:, :, :q, :p]


# mamba2-130m's chunk (Q = 256, N = 128, P = 64), one chunk, 3 heads in
# groups of 2 (the second group ragged), on chip_smoke's inputs
EMU_SHAPE = (1, 3, 256, 128, 64)
EMU_HEADS = 2


@pytest.fixture(scope="module", params=["slow", "steep", "none"])
def emu_case(request):
    args = [a.numpy() for a in SMOKE.ssd_inputs(*EMU_SHAPE, "cpu",
                                                 request.param)]
    want = np.asarray(ssd_intra_pallas(*(jnp.asarray(a) for a in args)))
    return {"decay": request.param, "args": args, "want": want}


def _excess(got, want):
    return np.abs(got - want) - (SSD_TOL["atol"]
                                 + SSD_TOL["rtol"] * np.abs(want))


def test_3xtf32_emulation_matches_pallas(emu_case):
    got = emulate(*emu_case["args"], EMU_HEADS)
    np.testing.assert_allclose(got, emu_case["want"], **SSD_TOL)
    # and with room: within half the tolerance (2-17% of it is used)
    assert _excess(2 * got - emu_case["want"], emu_case["want"]).max() <= 0


def test_1xtf32_misses_the_tolerance(emu_case):
    """The precision decision: one TF32 product (hi*hi) of each fp32 one
    is outside SSD_TOL of the reference, at every decay."""
    got = emulate(*emu_case["args"], EMU_HEADS, products=1)
    assert _excess(got, emu_case["want"]).max() > 0


def test_heads_a_block_do_not_change_the_result():
    """The score tile is the same whichever heads share it: groups of 1,
    2 and 3 heads give the same bits."""
    args = [a.numpy() for a in SMOKE.ssd_inputs(1, 3, 72, 20, 16, "cpu")]
    one = emulate(*args, 1)
    for heads in (2, 3):
        np.testing.assert_array_equal(emulate(*args, heads), one)


def test_mask_before_exp_keeps_overflowing_decays_finite():
    """With chip_smoke's "cliff" decay, acum_i - acum_j passes 88 for
    j > i, where fp32 exp overflows; the masked exponent is -inf, its
    weight 0, and the output stays finite and within SSD_TOL of the
    plain version."""
    args = [a.numpy() for a in SMOKE.ssd_inputs(1, 2, 256, 32, 16, "cpu",
                                                 "cliff")]
    acum = args[2]
    assert (acum[..., :1] - acum[..., -1:]).max() > 88
    got = emulate(*args, 2)
    want = sc.ssd_intra_plain(*(torch.from_numpy(a) for a in args)).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **SSD_TOL)


def test_round_toward_zero_accumulator_per_stage_sums_hold():
    """Why each stage's wgmmas start from zero.  The tensor cores add
    each k = 8 product into their fp32 accumulator rounding toward zero; one
    accumulator across all of a head's stages (up to 4 x 24 wgmmas at
    Q = 256) drifts toward zero.  Per-stage sums (24 wgmmas, then added to
    nearest) drift less and hold SSD_TOL against the exact (fp64) block;
    the score tile is one stage of 48 wgmmas (N = 128) either way."""
    args = [a.numpy() for a in SMOKE.ssd_inputs(1, 2, 256, 128, 64, "cpu",
                                                 "none")]
    cc, bc, acum, xd = (a.astype(np.float64) for a in args)
    exact = np.einsum("ij,hjp->hip", np.tril(cc[0] @ bc[0].T), xd[0])[None]
    staged = emulate(*args, 2)
    one = emulate(*args, 2, rounding="one")

    def outward(v):    # signed error away from zero, over sum |exact|
        return float(((v - exact) * np.sign(exact)).sum()
                     / np.abs(exact).sum())

    assert outward(one) < 0                       # toward zero
    assert abs(outward(staged)) < abs(outward(one))
    np.testing.assert_allclose(staged, exact, **SSD_TOL)
