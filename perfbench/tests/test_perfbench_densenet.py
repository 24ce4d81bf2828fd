"""DenseNet-121's cell on the CPU: the reference's operation count against
the paper's layer table, its outputs against the program's, whole runs of
the cell at 32 pixels (sound, and with each fault planted), and the
readers of the work between the convs."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from perfbench import reference as references
from perfbench.harness import between_convs, compare, spec
from perfbench.harness.costs import count_products
from perfbench.harness.weights import draw_images, draw_params, generator
from perfbench.tests.test_perfbench_faults import FAULTS
from perfbench.tests.test_perfbench_reference import _config, _table_flops

CELL = "densenet121.offline"
SMALL = {"config": {"image": 32}, "traffic": {"batch": 4}}


def densenet121_convs():
    """DenseNet-121 at 224 (Huang et al. 2017, Table 1: k = 32, BC,
    θ = 0.5): (in ch, out ch, k, output side, how many such convs)."""
    convs = [(3, 64, 7, 112, 1)]                           # stem
    c = 64
    for layers, side in ((6, 56), (12, 28), (24, 14), (16, 7)):
        for _ in range(layers):
            convs += [(c, 128, 1, side, 1), (128, 32, 3, side, 1)]
            c += 32
        if side != 7:                                      # transition
            convs.append((c, c // 2, 1, side, 1))
            c //= 2
    return convs


DENSE = [(1024, 1000)]


@pytest.mark.parametrize("batch", [1, 64])
def test_meta_count_equals_layer_table(batch):
    mod = references.load("densenet")
    specs = mod.param_specs(image=224, classes=1000, depth=121)
    ops = count_products(mod, specs, batch, 224, {"depth": 121})
    convs = densenet121_convs()
    assert sum(o["op"] == "conv" for o in ops) == len(convs) == 120
    assert sum(o["op"] == "dense" for o in ops) == 1
    assert sum(o["flops"] for o in ops) == _table_flops(convs, DENSE, batch)
    # 2.833 GMACs an image in the convs, 2.834 with the fc's
    conv_macs = sum(o["flops"] for o in ops if o["op"] == "conv") // 2
    assert conv_macs == 2_833_137_664 * batch
    assert round(sum(o["flops"] for o in ops) / 2e9 / batch, 3) == 2.834


def test_reference_equals_cpu_session():
    """At 32 pixels, on parameters drawn as the cell draws them, the
    reference's probabilities are a CPU session's of densenet-121: the
    names, the pre-activations, the concat order and the transitions'
    pools agree."""
    from repro_torch.engine.session import compile

    torch.manual_seed(0)
    cfg = _config("densenet121")
    mod = references.load(cfg["reference"])
    args = cfg["reference_args"]
    dev = torch.device("cpu")
    specs = mod.param_specs(image=32, classes=cfg["classes"], **args)
    g = generator(2**31 + 3, dev)
    params = draw_params(specs, cfg["weights"], g, dev)
    x = draw_images(4, 32, g, dev)
    session = compile(cfg["zoo"], (4, 3, 32, 32), params=params,
                      device="cpu")
    y = session.predict(x)
    want = compare.reference_outputs(mod, params, [x], args, dev)
    assert compare.logprob_gap([(0, y)], want) < 1e-4


def _run(monkeypatch, fault=None):
    from perfbench.harness.cell import run_cell
    from repro_torch.engine.executor import CompiledModel

    torch.set_num_threads(2)
    if fault is not None:
        predict = CompiledModel.predict
        monkeypatch.setattr(CompiledModel, "predict",
                            lambda self, x: fault(predict(self, x)))
    return run_cell(CELL, 2**31 + 17, 0.5, False, device="cpu",
                    overrides=SMALL)["result"]


@pytest.mark.parametrize("fault", [None, "half_batch", "altered_answer"])
def test_whole_run_is_correct_only_when_sound(fault, monkeypatch):
    r = _run(monkeypatch, FAULTS.get(fault))
    gap = r["checks"]["logprob_gap"]
    if fault is None:
        assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
        assert gap["value"] <= gap["limit"]
    else:
        assert not r["correct"] and gap["value"] > gap["limit"]


def _window(images=64, batches=None):
    return SimpleNamespace(images=images, batches=batches or {64: 1},
                           enqueue_ms=[1.0], seconds=1.0, serving=None)


def test_plan_reader_reads_the_cells_plan(monkeypatch):
    """The ``plan`` note of the cell's bucket, read after a whole run on
    the CPU: the GB of its relayouts, BN, ReLU and seeds."""
    from repro_torch import trace

    read = spec.metric_reader("plan.between_convs_gb.densenet")
    with trace.use(trace.Recorder()):
        assert _run(monkeypatch)["correct"]
        note = between_convs.plan_note(4)
        gb = read(SimpleNamespace(window=_window(4, {4: 1})))
    assert note["concat_seeds"] == 58 and note["concat_writes"] == 58
    assert gb == pytest.approx(sum(note[k] for k in between_convs.PLAN_BYTES)
                               / 1e9)
    assert gb > 0


def test_plan_reader_is_none_without_a_note():
    """A program whose ``plan`` span has no note of the work between the
    convs (the parent's), or a bucket never planned, reads None."""
    from repro_torch import trace

    run = SimpleNamespace(window=_window(), trace=None, costs=None)
    with trace.use(trace.Recorder()):
        with trace.span("specialize", "64", 64):
            with trace.span("plan") as i:
                trace.note(i, passes=[("fusion", 0.1)])
        assert between_convs.plan_gb(run) is None
        with trace.span("specialize", "32", 32):
            with trace.span("plan") as i:
                trace.note(i, relayout_bytes=1, eltwise_bytes=2,
                           concat_seed_bytes=3)
        assert between_convs.plan_gb(run) is None
        run.window.batches = {32: 5}
        assert between_convs.plan_gb(run) == 6e-9


def test_card_reader_leaves_out_b1_and_the_hosts_copies():
    trace = {"batches": {64: 4}, "device_s_by_name": {
        "void conv_sm90_kernel<4, 0>(Conv)": 1.0,
        "void conv_sm90_kernel_wide<64>(Conv, CUtensorMap)": 2.0,
        "Memcpy HtoD (Pinned -> Device)": 0.5,
        "Memcpy DtoH (Device -> Pinned)": 0.25,
        "Memset (Device)": 0.125,
        "Memcpy DtoD (Device -> Device)": 0.004,
        "void at::native::elementwise_kernel<128, 2>(...)": 0.016}}
    run = SimpleNamespace(window=_window(), trace=trace, costs=None)
    assert between_convs.card_ms(run) == pytest.approx(5.0)
    for empty in (None, {}, {"batches": {}, "device_s_by_name": {}}):
        run.trace = empty
        assert between_convs.card_ms(run) is None
