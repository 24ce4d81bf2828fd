"""The port's roofline machinery (``repro_torch.analysis``) against the
reference's ``repro.analysis``: the aten-op FLOP counter on the cases of
``tests/test_analysis.py`` (a Python loop in place of ``lax.scan``), the
roofline terms at the H100's constants, ``model_flops`` and
``model_bytes`` for every architecture and kind, and the counts of a
reduced and a full-width LM prefill on the meta device against the
reference's jaxpr walker on the same prefill.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import flops as RF
from repro.analysis import roofline as RR
from repro.configs import ARCHS as R_ARCHS, reduced as r_reduced
from repro.models.lm import model as r_model
from repro_torch.analysis import flops as TF
from repro_torch.analysis import roofline as TR
from repro_torch.analysis.flops import count_costs
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.cost import MachineModel
from repro_torch.models.lm import model

# The totals of a reduced prefill: the port's count against the reference's,
# relative.  Measured: qwen2-1.5b 0.0052, mamba2-130m 0.043 (the SSD's
# segment sums, exp and masks are elementwise work laid out differently in
# the two packages: JAX's (B, C, Q, Q, H) segsum, the port's B4 plain
# version); 0.00045 and 0.0039 at full width and 2,048 tokens.
TOTAL_REL = 0.05
KINDS = ("train", "prefill", "decode")


def _ones(*shape):
    return torch.ones(shape, device="meta")


def test_flops_matmul_exact():
    c = count_costs(lambda a, b: a @ b, torch.ones(64, 128),
                    torch.ones(128, 32))
    assert c["flops"] == 2 * 64 * 128 * 32
    # a, b and the product's bytes, once each
    assert c["heavy_bytes"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)


def test_flops_python_loop_counts_every_trip():
    """The reference multiplies a ``scan`` body by its length; a Python
    loop runs (and is counted) trip by trip, the trip's weights selected
    by a view, which costs nothing."""
    def f(w_stack, x):
        for w in w_stack:
            x = x @ w
        return x

    c = count_costs(f, torch.ones(8, 32, 32), torch.ones(4, 32))
    ideal = 2 * 4 * 32 * 32 * 8
    assert abs(c["flops"] - ideal) / ideal < 0.01


def test_flops_grad_roughly_3x_forward():
    x = _ones(8, 64)

    def loss(w):
        return torch.sum((x @ w) ** 2)

    def grad(w):
        w = w.detach().requires_grad_()
        return torch.autograd.grad(loss(w), w)

    fwd = count_costs(loss, torch.ones(64, 64))["flops"]
    bwd = count_costs(grad, torch.ones(64, 64))["flops"]
    assert 1.8 * fwd < bwd < 3.5 * fwd


def test_flops_checkpoint_counts_recompute():
    """A checkpointed backward must count MORE flops than the plain one
    (the recompute is real work the useful-flops ratio should see)."""
    from torch.utils.checkpoint import checkpoint

    def f(w1, w2, x):
        h = torch.tanh(x @ w1)
        return torch.sum(torch.tanh(h @ w2))

    def grad(body):
        def g(w1, w2, x):
            w1, w2 = (w.detach().requires_grad_() for w in (w1, w2))
            return torch.autograd.grad(body(w1, w2, x), (w1, w2))
        return g

    args = (torch.ones(64, 64), torch.ones(64, 64), torch.ones(8, 64))
    plain = count_costs(grad(f), *args)["flops"]
    ck = count_costs(grad(lambda a, b, x: checkpoint(
        f, a, b, x, use_reentrant=False)), *args)["flops"]
    assert ck > plain


def test_flops_conv():
    c = count_costs(lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
                    torch.ones(1, 8, 16, 16), torch.ones(16, 8, 3, 3))
    ideal = 2 * 16 * 16 * 16 * 8 * 9   # out_elems x 2 x cin x k x k
    assert abs(c["flops"] - ideal) / ideal < 0.01


def test_flops_match_reference_on_the_simple_cases():
    """The same small functions through both counters: the products
    exactly, the grad's total within 5%: measured 3.3%, the reference's
    VJP of ``x ** 2`` multiplying by a broadcast constant 2 that torch's
    ``pow_backward`` folds into fewer ops."""
    a, b = np.ones((64, 128), np.float32), np.ones((128, 32), np.float32)
    assert count_costs(lambda a, b: a @ b, torch.from_numpy(a),
                       torch.from_numpy(b)) == RF.count_costs(
                           lambda a, b: a @ b, a, b)
    x = np.ones((8, 64), np.float32)
    w = np.ones((64, 64), np.float32)
    want = RF.count_costs(jax.grad(lambda w: jnp.sum((x @ w) ** 2)),
                          w)["flops"]
    xt = _ones(8, 64)

    def grad(w):
        w = w.detach().requires_grad_()
        return torch.autograd.grad(torch.sum((xt @ w) ** 2), w)

    got = count_costs(grad, torch.from_numpy(w))["flops"]
    assert abs(got - want) / want < 0.05


def test_count_costs_moves_arguments_to_meta():
    """Nested arguments go to meta, so nothing is computed or allocated:
    the function sees only meta tensors."""
    seen = []

    def f(tree):
        seen.extend(t.device.type for t in (tree["a"], *tree["b"]))
        return tree["a"] @ tree["b"][0]

    c = count_costs(f, {"a": torch.ones(4, 8), "b": [torch.ones(8, 2)]})
    assert seen == ["meta", "meta"] and c["flops"] == 2 * 4 * 8 * 2


# ---------------------------------------------------------------------------
# roofline terms at the H100's constants
# ---------------------------------------------------------------------------

def test_h100_constants_are_stated_once():
    assert (TR.PEAK_FLOPS, TR.PEAK_TF32, TR.PEAK_FP32, TR.HBM_BW,
            TR.NVLINK_BW) == (989e12, 495e12, 67e12, 3.35e12, 450e9)
    h = MachineModel.h100()
    assert (h.peak_flops, h.mem_bw, h.link_bw) == (TR.PEAK_FP32, TR.HBM_BW,
                                                   TR.NVLINK_BW)


def test_roofline_report_terms():
    r = TR.RooflineReport(
        arch="x", shape="train_4k", mesh="1", chips=4,
        flops_per_device=989e12, bytes_per_device=3.35e12,
        collective_bytes_per_device=450e9, collectives={},
        model_flops_total=989e12 * 4)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0)
    assert r.bottleneck in ("compute", "memory")
    assert r.step_time_s == pytest.approx(2.0)
    assert r.roofline_fraction == pytest.approx(0.5)
    assert r.useful_flops_ratio == pytest.approx(1.0)
    assert r.ideal_step_s == pytest.approx(1.0)
    r.model_bytes_total = 2 * 4 * 3.35e12        # the memory roofline binds
    assert r.ideal_step_s == pytest.approx(2.0)
    assert r.roofline_fraction == pytest.approx(1.0)
    d = r.to_dict()
    ref = RR.RooflineReport(**{f.name: getattr(r, f.name)
                               for f in dataclasses.fields(r)}).to_dict()
    assert set(d) == set(ref)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_model_flops_and_bytes_equal_the_reference(name):
    """Pure arithmetic on the config, so equal exactly, for every kind and
    both the production and the reduced config."""
    for cfg, rcfg in ((ARCHS[name], R_ARCHS[name]),
                      (reduced(ARCHS[name]), r_reduced(R_ARCHS[name]))):
        for kind in KINDS:
            for batch, seq in ((1, 2048), (4, 1), (2, 10)):
                assert TR.model_flops(cfg, kind, batch, seq) == \
                    RR.model_flops(rcfg, kind, batch, seq)
                assert TR.model_bytes(cfg, kind, batch, seq) == \
                    RR.model_bytes(rcfg, kind, batch, seq)


def test_model_flops_kinds():
    cfg = ARCHS["qwen2-1.5b"]
    n = cfg.active_param_count()
    assert TR.model_flops(cfg, "train", 2, 10) == 6.0 * n * 20
    assert TR.model_flops(cfg, "prefill", 2, 10) == 2.0 * n * 20
    assert TR.model_flops(cfg, "decode", 2, 10) == 2.0 * n * 2


# ---------------------------------------------------------------------------
# an LM prefill, the port's counter against the reference's walker
# ---------------------------------------------------------------------------

def _ref_products(jaxpr, mult: int = 1) -> int:
    """The reference's FLOPs of its dot_generals that contract over at
    least one dim (scan bodies times their length, as its walker counts).
    Its einsums also emit dot_generals that contract nothing (the SSD's
    decay factors): elementwise products, which the port runs as ``mul``
    at one FLOP an element, so they are left out here."""
    if hasattr(jaxpr, "jaxpr"):
        jaxpr = jaxpr.jaxpr
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            total += _ref_products(eqn.params["jaxpr"],
                                   mult * eqn.params["length"])
            continue
        sub = [k for k in RF._SUBJAXPR_KEYS if k in eqn.params]
        if sub:
            total += _ref_products(eqn.params[sub[0]], mult)
        elif name == "dot_general" and \
                eqn.params["dimension_numbers"][0][0]:
            total += RF._dot_flops(eqn) * mult
    return total


def _counts(name: str, seq: int, cut):
    """(reference flops, heavy bytes, products; port flops, products) of a
    batch-1 ``seq``-token prefill of ``cut(ARCHS[name])``, both from
    shapes alone, the port's plus the head over the other ``seq - 1``
    positions: its prefill computes the last position's logits only, the
    reference's all of them."""
    rcfg, cfg = cut(R_ARCHS[name]), cut(ARCHS[name])
    rp = jax.eval_shape(lambda: r_model.init_params(rcfg,
                                                    jax.random.PRNGKey(0)))
    jp = jax.make_jaxpr(lambda p, t: r_model.prefill(p, rcfg, t,
                                                     max_len=seq))(
        rp, jax.ShapeDtypeStruct((1, seq), jnp.int32))
    r_flops, r_bytes = RF.jaxpr_cost(jp)
    params = model.init_params(cfg, 0, "meta")
    with TF.CostCounter() as c:
        model.prefill(params, cfg, torch.zeros((1, seq), dtype=torch.long,
                                               device="meta"), max_len=seq)
    head = 2 * (seq - 1) * cfg.d_model * cfg.vocab
    return (r_flops, r_bytes, _ref_products(jp), c.flops + head,
            c.product_flops + head)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-130m"])
def test_reduced_prefill_counts_match_the_reference(name):
    r_flops, _, r_products, flops, products = _counts(name, 32, _cut)
    assert products == r_products
    assert abs(flops - r_flops) / r_flops < TOTAL_REL


def _cut(cfg):
    """``reduced`` of whichever package's config it is given."""
    return (reduced if type(cfg).__module__.startswith("repro_torch")
            else r_reduced)(cfg)


def test_full_width_prefill_counts_on_meta_in_seconds():
    """qwen2-1.5b at full width, a 2,048-token prefill: 28 layers of
    products counted from shapes alone, equal to the reference's."""
    t0 = time.perf_counter()
    r_flops, _, r_products, flops, products = _counts(
        "qwen2-1.5b", 2048, lambda c: c)
    assert time.perf_counter() - t0 < 60
    assert products == r_products
    assert abs(flops - r_flops) / r_flops < TOTAL_REL
