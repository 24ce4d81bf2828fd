"""The port on the card: the conv kernel against its plain version, the
conv lowerings (``use_kernel=False``) against their CPU runs, and the
launches of a predict.  B1's sm90 route (3xTF32 on wgmma) at every conv of
ResNet-50's plan at batch 1 and 8 (the stem with its max pool, stride 2,
the 7x7 layers that split K over a cluster, oc_bn = 512) and at
``chip_smoke.extra_cases()`` (the concat store, the ceil-mode avg pool
behind asymmetric pads), two launches bit-identical, and predicts that
launch only that route.  Each fp32 lowering and each int8 form on the card
against the same torch ops on the CPU; a ``use_kernel=False`` predict (fp32
and int8) launches the kernel no time, a default predict once per conv and
no lowering; folded and unfolded BN agree on both paths.  An artifact
saved on the card (the kernel path and int8 on the lowerings) loads on the
card with its weights and outputs bit for bit and no schedule search, and
onto the CPU within the CPU session's tolerance.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor the reference, so it also runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.epilogue import EpilogueSpec, PoolSpec
from repro_torch.core.layout import (kernel_from_kcrs_ck, kernel_to_kcrs_ck,
                                     to_nchwc)
from repro_torch.core.quantize import quantize_per_channel
from repro_torch.core.schedule import INT8_VARIANTS, VARIANTS
from repro_torch.engine import compile, compile_model
from repro_torch.kernels import conv2d_nchwc as kmod
from repro_torch.kernels.ops import conv2d_lowered, pad_blocked

pytestmark = pytest.mark.cuda

# kernel vs plain on one card: fp32 sums in another order
TOL = dict(rtol=1e-4, atol=1e-4)
# a lowering on the card vs the same torch ops on the CPU (TF32 off): fp32
# sums of at most 144 terms in another order.  An int8 form sums the codes
# (up to 127 times the weight over its channel's scale) before the
# dequantize scale, so its rounding is that much larger against the output:
# the reference's own int8 matrix holds it to 1e-4
LOWERING_TOL = {"fp32": dict(rtol=1e-5, atol=1e-5),
                "int8": dict(rtol=1e-4, atol=1e-4)}
# a predict on the card vs a CPU session: probabilities of a saturated
# softmax after 20 layers
E2E_TOL = dict(rtol=1e-3, atol=1e-5)
LOWERINGS = [(v, "fp32") for v in VARIANTS] + [(v, "int8")
                                               for v in INT8_VARIANTS]

# epilogue mode -> (bn, relu, residual, pool kind, concat)
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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(mode, stride, pad, device, *, ic_bn=8, oc_bn=8, hw=11,
              batch=2, seed=0):
    bn, relu, residual, pool_kind, concat = EPILOGUES[mode]
    cin, cout = 2 * ic_bn, 2 * oc_bn
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape)
                                .astype(np.float32)).to(device)

    oh = (hw + 2 * pad[0] - 3) // stride + 1
    ow = (hw + 2 * pad[1] - 3) // stride + 1
    spec = EpilogueSpec(
        relu=relu,
        pool=PoolSpec(pool_kind, 3, 2, 1, True) if pool_kind else None,
        concat_offset=cout if concat else 0,
        concat_total=2 * cout if concat else 0)
    ph, pw = spec.out_hw(oh, ow)
    args = (pad_blocked(to_nchwc(t((batch, cin, hw, hw)), ic_bn), pad),
            kernel_to_kcrs_ck(t((cout, cin, 3, 3)), ic_bn, oc_bn),
            t((cout // oc_bn, oc_bn)) if bn else None,
            t((cout // oc_bn, oc_bn)) if bn else None,
            to_nchwc(t((batch, cout, oh, ow)), oc_bn) if residual else None,
            to_nchwc(t((batch, 2 * cout, ph, pw)), oc_bn) if concat else None)
    return args, spec


@pytest.mark.parametrize("mode", sorted(EPILOGUES))
@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_matches_plain_on_card(card, mode, stride):
    args, spec = _operands(mode, stride, (1, 2), card)
    before = kmod.conv2d_nchwc.launches
    got = kmod.conv2d_nchwc(*args, stride=stride, epilogue=spec)
    torch.cuda.synchronize()
    assert kmod.conv2d_nchwc.launches == before + 1
    want = kmod.conv2d_nchwc_plain(*args, stride=stride, epilogue=spec)
    torch.testing.assert_close(got, want, **TOL)


def test_kernel_stem_shape_on_card(card):
    """ic_bn = 3, as the RGB stem has it, through the pooled epilogue."""
    args, spec = _operands("pool_relu", 2, (3, 3), card, ic_bn=3, oc_bn=16,
                           hw=30, batch=1)
    got = kmod.conv2d_nchwc(*args, stride=2, epilogue=spec)
    want = kmod.conv2d_nchwc_plain(*args, stride=2, epilogue=spec)
    torch.testing.assert_close(got, want, **TOL)


def test_wrapper_rejects_what_the_kernel_cannot_take(card):
    args, spec = _operands("residual", 1, (1, 1), card)
    x, w, _, _, res, _ = args
    with pytest.raises(ValueError, match="contiguous"):
        kmod.conv2d_nchwc(x.transpose(2, 3), w)
    with pytest.raises(TypeError, match="float32"):
        kmod.conv2d_nchwc(x, w.double())
    with pytest.raises(ValueError, match="shape"):
        kmod.conv2d_nchwc(x, w, residual=res[:, :, 1:])
    with pytest.raises(ValueError, match="is on"):
        kmod.conv2d_nchwc(x, w.cpu())
    with pytest.raises(ValueError, match="out_buf"):
        kmod.conv2d_nchwc(x, w, epilogue=EpilogueSpec(concat_offset=16,
                                                      concat_total=32))


def test_predict_on_card_launches_once_per_blocked_conv(card):
    sess = compile("resnet-18", (1, 3, 64, 64), device=card)
    plan = sess.plan_for(1).planned
    n_blocked = sum(1 for n in plan.graph.topo_order()
                    if n.op == "conv_block" and plan.layouts[n.name].is_blocked)
    x = torch.randn(1, 3, 64, 64, device=card)
    before = kmod.conv2d_nchwc.launches
    y = sess.predict(x)
    torch.cuda.synchronize()
    assert kmod.conv2d_nchwc.launches - before == n_blocked > 0
    ref = compile("resnet-18", (1, 3, 64, 64), device="cpu")
    np.testing.assert_allclose(y.cpu().numpy(),
                               ref.predict(x.cpu()).numpy(), rtol=1e-3,
                               atol=1e-5)


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("batch", [1, 8])
def test_sm90_route_at_every_resnet50_plan_conv(card, batch):
    smoke = _smoke()
    convs = smoke.plan_convs("resnet-50", batch, 224)
    names = {smoke.wl_name(c) for c in convs}
    # the stem with its max pool, stride 2, oc_bn = 512, the 7x7 layers
    # (the H100 plan blocks them by batch size)
    seven = {1: "c512_k512_h7_r3_s1_p1_ic64_oc64",
             8: "c512_k512_h7_r3_s1_p1_ic64_oc512"}[batch]
    assert {"c3_k64_h224_r7_s2_p3_ic3_oc64_maxpool",
            "c256_k512_h56_r1_s2_p0_ic256_oc512", seven} <= names
    # each on the route _route names (sm90, or sm90_wide where the grid
    # fills the card), bit-identical twice, within KERNEL_TOL
    smoke.phase_kernels(card, convs)


def test_sm90_split_k_layers_use_clusters(card):
    """The 7x7 layers at batch 1 split K over clusters of 4 or 8 and still
    match plain, bit-identical over two launches."""
    smoke = _smoke()
    small = [c for c in smoke.plan_convs("resnet-50", 1, 224)
             if c["wl"].out_hw == (7, 7)]
    plans = [kmod.launch_plan(*smoke.plan_shapes(c)) for c in small]
    assert len(small) == 5 and all(p["cs"] >= 4 for p in plans)
    smoke.phase_kernels(card, small)


@pytest.mark.parametrize("name", ["densenet_concat", "avgpool_ceil_asym"])
def test_sm90_route_at_the_extra_cases(card, name):
    smoke = _smoke()
    smoke.phase_kernels(card, [c for c in smoke.extra_cases()
                               if c["name"] == name])


@pytest.mark.parametrize("name", ["densenet_concat_b32",
                                  "inception_1x7_b32"])
def test_sm90_wide_route_at_the_wide_cases(card, name):
    smoke = _smoke()
    smoke.phase_kernels(card, [c for c in smoke.wide_cases()
                               if c["name"] == name])


def test_resnet50_batch32_predict_takes_the_wide_route(card):
    """resnet50.offline's batch: 52 of a predict's 53 convs on the wide
    route, the pooled RGB stem on sm90; the probabilities held to the
    plain version's session."""
    sess = compile("resnet-50", (32, 3, 224, 224), device=card)
    x = torch.randn(32, 3, 224, 224, device=card)
    sess.predict(x)
    before = dict(kmod.conv2d_nchwc.launches_by_route)
    y = sess.predict(x)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in
            kmod.conv2d_nchwc.launches_by_route.items()} == {
        "sm90": 1, "sm90_wide": 52}
    plain = compile("resnet-50", (32, 3, 224, 224), device=card,
                    use_kernel=False)
    np.testing.assert_allclose(y.cpu().numpy(), plain.predict(x).cpu()
                               .numpy(), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 8])
def test_resnet50_predict_launches_only_the_sm90_route(card, batch):
    sess = compile("resnet-50", (batch, 3, 64, 64), device=card)
    plan = sess.plan_for(batch).planned
    n_blocks = sum(1 for n in plan.graph.topo_order() if n.op == "conv_block")
    x = torch.randn(batch, 3, 64, 64, device=card)
    before = dict(kmod.conv2d_nchwc.launches_by_route)
    y = sess.predict(x)
    torch.cuda.synchronize()
    # at 64 pixels every grid is too small for the wide route
    assert kmod.conv2d_nchwc.launches_by_route == {
        "sm90": before["sm90"] + n_blocks,
        "sm90_wide": before["sm90_wide"]} and n_blocks == 53
    ref = compile("resnet-50", (batch, 3, 64, 64), device="cpu")
    np.testing.assert_allclose(y.cpu().numpy(),
                               ref.predict(x.cpu()).numpy(), rtol=1e-3,
                               atol=1e-5)


# the zoo's shapes that ResNet-50 does not reach: (model, image, a test on
# a plan_convs entry)
ZOO_CASES = {
    # SSD's 3x3 heads on the 2,048-channel map: K = 18,432, no epilogue
    "ssd_head_k18432": ("ssd-resnet-50", 512, lambda c: not c["shift"] and
                        c["wl"].in_channels * c["wl"].kh * c["wl"].kw
                        == 18432),
    # VGG-16's s5c3: the max pool fused, so K (4,608) is never split
    "vgg16_s5c3_pool": ("vgg-16", 224, lambda c: c["wl"].fused_pool == "max"
                        and c["wl"].in_channels == 512
                        and c["wl"].height == 14),
    "inception_1x7": ("inception-v3", 299,
                      lambda c: (c["wl"].kh, c["wl"].kw) == (1, 7)),
    "inception_7x1": ("inception-v3", 299,
                      lambda c: (c["wl"].kh, c["wl"].kw) == (7, 1)),
    # the concat store at offset 992 of 1,024 channels (the last layer of
    # dense blocks 3 and 4)
    "densenet_concat_992": ("densenet-121", 224,
                            lambda c: c["wl"].concat_offset == 992),
}


@pytest.mark.parametrize("name", sorted(ZOO_CASES))
def test_sm90_route_at_zoo_plan_convs(card, name):
    model, image, pick = ZOO_CASES[name]
    smoke = _smoke()
    convs = [c for c in smoke.plan_convs(model, 1, image) if pick(c)]
    assert convs
    smoke.phase_kernels(card, convs)


def test_densenet121_predict_launches_only_the_sm90_route(card):
    """Every conv of a densenet-121 predict launches B1's sm90 route, and
    the probabilities and the logits (marked as a second output, since a
    random network saturates the softmax) match a CPU session's: the
    logits to 1e-5 of the largest, with the same top-1."""
    smoke = _smoke()
    sess = compile("densenet-121", (1, 3, 64, 64), device=card)
    plan = sess.plan_for(1).planned
    n_convs = sum(1 for n in plan.graph.topo_order()
                  if n.op in ("conv_block", "conv2d"))
    x = torch.randn(1, 3, 64, 64, device=card)
    before = dict(kmod.conv2d_nchwc.launches_by_route)
    probs, logits = smoke.with_logits(sess.specialize(1)).predict(x)
    torch.cuda.synchronize()
    assert kmod.conv2d_nchwc.launches_by_route == {
        "sm90": before["sm90"] + n_convs,
        "sm90_wide": before["sm90_wide"]} and n_convs == 120
    ref = compile("densenet-121", (1, 3, 64, 64), device="cpu")
    want_p, want_l = (t.numpy() for t in
                      smoke.with_logits(ref.specialize(1)).predict(x.cpu()))
    np.testing.assert_allclose(probs.cpu().numpy(), want_p, rtol=1e-3,
                               atol=1e-5)
    got_l = logits.cpu().numpy()
    scale = float(np.abs(want_l).max())
    np.testing.assert_allclose(got_l, want_l, rtol=smoke.LOGIT_TOL,
                               atol=smoke.LOGIT_TOL * scale)
    assert got_l.argmax() == want_l.argmax()


@pytest.mark.parametrize("variant,dtype", LOWERINGS,
                         ids=[f"{v}-{d}" for v, d in LOWERINGS])
@pytest.mark.parametrize("mode", ["bn_relu", "residual", "pool_relu",
                                  "concat"])
def test_lowering_on_card_matches_its_cpu_run(card, variant, dtype, mode):
    """Each lowering (cuBLAS on the card, TF32 off) against the same torch
    ops on the CPU; an int8 form on per-channel int8 codes with the
    dequantize scale in the epilogue's scale."""
    args, spec = _operands(mode, 2, (1, 2), card)
    x, w, scale, shift, res, buf = args
    if dtype == "int8":
        q, w_scale = quantize_per_channel(
            kernel_from_kcrs_ck(w).cpu().numpy())
        w = kernel_to_kcrs_ck(torch.from_numpy(q), 8, 8).to(card)
        ws = torch.from_numpy(w_scale).reshape(-1, 8).to(card)
        scale = ws if scale is None else scale * ws
    args = (x, w, scale, shift, res, buf)
    kw = dict(stride=2, epilogue=spec, variant=variant, dtype=dtype)
    before = kmod.conv2d_nchwc.launches
    got = conv2d_lowered(*args, **kw)
    torch.cuda.synchronize()
    assert kmod.conv2d_nchwc.launches == before
    want = conv2d_lowered(*(None if a is None else a.cpu() for a in args),
                          **kw)
    torch.testing.assert_close(got.cpu(), want, **LOWERING_TOL[dtype])


@pytest.mark.parametrize("use_kernel,dtype", [(True, "fp32"),
                                              (False, "fp32"),
                                              (False, "int8")])
def test_predict_runs_one_path_only(card, use_kernel, dtype):
    """A default predict launches the kernel once per conv and runs no
    lowering; a ``use_kernel=False`` predict (fp32 or int8) runs one
    lowering per conv and launches the kernel no time.  Both match a CPU
    session of the same plan."""
    shape = (1, 3, 64, 64)
    sess = compile("resnet-18", shape, device=card, use_kernel=use_kernel,
                   dtype=dtype)
    plan = sess.plan_for(1).planned
    n_convs = sum(1 for n in plan.graph.topo_order()
                  if n.op in ("conv_block", "conv2d"))
    x = torch.randn(*shape, device=card)
    launches = kmod.conv2d_nchwc.launches
    lowered = sum(conv2d_lowered.calls.values())
    y = sess.predict(x)
    torch.cuda.synchronize()
    assert kmod.conv2d_nchwc.launches - launches == (
        n_convs if use_kernel else 0)
    assert sum(conv2d_lowered.calls.values()) - lowered == (
        0 if use_kernel else n_convs)
    ref = compile("resnet-18", shape, device="cpu", use_kernel=use_kernel,
                  dtype=dtype)
    np.testing.assert_allclose(y.cpu().numpy(), ref.predict(x.cpu()).numpy(),
                               **E2E_TOL)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "lowerings"])
def test_folded_and_unfolded_bn_agree_on_card(card, use_kernel):
    sess = compile("resnet-18", (1, 3, 64, 64), device=card)
    plan = sess.plan_for(1)
    x = torch.randn(1, 3, 64, 64, device=card)
    folded, unfolded = (compile_model(plan, sess._params,
                                      use_kernel=use_kernel, fold_bn=fold)
                        .predict(x).cpu().numpy() for fold in (True, False))
    np.testing.assert_allclose(unfolded, folded, **E2E_TOL)


@pytest.mark.parametrize("use_kernel,dtype", [(True, "fp32"),
                                              (False, "int8")])
def test_artifact_saved_and_loaded_on_card(card, tmp_path, use_kernel,
                                           dtype):
    """An artifact saved on the card loads on the card with every weight
    leaf and every output bit for bit, the same launches a predict and no
    schedule search; loaded onto the CPU, it predicts within the CPU
    session's tolerance."""
    from repro_torch.core.local_search import search_calls
    from repro_torch.engine import InferenceSession

    shape = (1, 3, 64, 64)
    sess = compile("resnet-18", shape, device=card, use_kernel=use_kernel,
                   dtype=dtype)
    x = torch.randn(*shape, device=card)
    y = sess.predict(x).cpu()
    sess.save(tmp_path / "art")
    n = search_calls()
    loaded = InferenceSession.load(tmp_path / "art", device=card)
    for node, leaves in sess.specialize(1).params.items():
        for leaf, t in leaves.items():
            got = loaded.specialize(1).params[node][leaf]
            assert got.device.type == "cuda" and got.dtype == t.dtype
            assert torch.equal(got, t), (node, leaf)
    launches = kmod.conv2d_nchwc.launches
    got = loaded.predict(x).cpu()
    torch.cuda.synchronize()
    n_convs = sum(1 for nd in sess.plan_for(1).planned.graph.topo_order()
                  if nd.op in ("conv_block", "conv2d"))
    assert kmod.conv2d_nchwc.launches - launches == (
        n_convs if use_kernel else 0)
    assert search_calls() == n
    assert got.numpy().tobytes() == y.numpy().tobytes()
    on_cpu = InferenceSession.load(tmp_path / "art", device="cpu")
    np.testing.assert_allclose(on_cpu.predict(x.cpu()).numpy(), y.numpy(),
                               **E2E_TOL)


@pytest.mark.parametrize("workers", [1, 2])
def test_served_on_card_bit_identical_at_the_fixed_bucket(card, workers):
    """``AsyncServer`` on a card session, each worker on its own stream:
    every response equals ``padded_predict`` at the fixed bucket bit for
    bit, whichever worker ran it, and B1 launches once per conv node per
    executed batch."""
    from repro_torch.engine import (AsyncServer, DynamicBatchPolicy,
                                    padded_predict)

    sess = compile("resnet-18", (1, 3, 64, 64), device=card)
    sess.specialize(4)
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(int(rng.integers(1, 3)), 3, 64, 64))
          .astype(np.float32) for _ in range(12)]
    refs = [padded_predict(sess, x, bucket=4).cpu().numpy() for x in xs]
    n_convs = sum(1 for nd in sess.plan_for(4).planned.graph.topo_order()
                  if nd.op in ("conv_block", "conv2d"))
    launches = kmod.conv2d_nchwc.launches
    with AsyncServer(sess, DynamicBatchPolicy(max_batch=4, max_wait_ms=2.0,
                                              fixed_bucket=4),
                     workers=workers) as srv:
        futs = [srv.submit(x if i % 2 else torch.from_numpy(x).to(card))
                for i, x in enumerate(xs)]
        got = [f.result(timeout=120).cpu().numpy() for f in futs]
    for g, r in zip(got, refs):
        assert g.tobytes() == r.tobytes()
    st = srv.stats
    assert st.n_completed == len(xs) and st.n_failed == 0
    assert kmod.conv2d_nchwc.launches - launches == n_convs * st.n_batches
