"""The plain references: their operation counts against the networks'
published layer tables, their outputs against the program's on the CPU,
and the check's control (TF32) against each cell's limit."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from perfbench import reference as references
from perfbench.harness import compare, spec
from perfbench.harness.costs import count_products
from perfbench.harness.weights import draw_images, draw_params, generator

ROOT = Path(__file__).resolve().parents[2]

# ResNet-50 at 224 (He et al. 2016, Table 1): (in ch, out ch, k, output
# side, how many such convs)
RESNET50_CONVS = [
    (3, 64, 7, 112, 1),                                    # stem
    (64, 64, 1, 56, 1), (64, 64, 3, 56, 3), (64, 256, 1, 56, 3),
    (64, 256, 1, 56, 1), (256, 64, 1, 56, 2),              # stage 1
    (256, 128, 1, 56, 1), (128, 128, 3, 28, 4), (128, 512, 1, 28, 4),
    (256, 512, 1, 28, 1), (512, 128, 1, 28, 3),            # stage 2
    (512, 256, 1, 28, 1), (256, 256, 3, 14, 6), (256, 1024, 1, 14, 6),
    (512, 1024, 1, 14, 1), (1024, 256, 1, 14, 5),          # stage 3
    (1024, 512, 1, 14, 1), (512, 512, 3, 7, 3), (512, 2048, 1, 7, 3),
    (1024, 2048, 1, 7, 1), (2048, 512, 1, 7, 2),           # stage 4
]
RESNET50_DENSE = [(2048, 1000)]
# VGG-16 at 224 (Simonyan and Zisserman 2014, Table 1, D)
VGG16_CONVS = [
    (3, 64, 3, 224, 1), (64, 64, 3, 224, 1),
    (64, 128, 3, 112, 1), (128, 128, 3, 112, 1),
    (128, 256, 3, 56, 1), (256, 256, 3, 56, 2),
    (256, 512, 3, 28, 1), (512, 512, 3, 28, 2),
    (512, 512, 3, 14, 3),
]
VGG16_DENSE = [(25088, 4096), (4096, 4096), (4096, 1000)]


def _table_flops(convs, dense, batch):
    conv = sum(2 * cout * side * side * cin * k * k * n
               for cin, cout, k, side, n in convs)
    return batch * (conv + sum(2 * i * o for i, o in dense))


@pytest.mark.parametrize("ref,args,convs,dense", [
    ("resnet", {"depth": 50}, RESNET50_CONVS, RESNET50_DENSE),
    ("vgg", {"depth": 16}, VGG16_CONVS, VGG16_DENSE),
])
@pytest.mark.parametrize("batch", [1, 32])
def test_meta_count_equals_layer_table(ref, args, convs, dense, batch):
    mod = references.load(ref)
    specs = mod.param_specs(image=224, classes=1000, **args)
    ops = count_products(mod, specs, batch, 224, args)
    assert sum(o["op"] == "conv" for o in ops) == sum(c[-1] for c in convs)
    assert sum(o["op"] == "dense" for o in ops) == len(dense)
    assert sum(o["flops"] for o in ops) == _table_flops(convs, dense, batch)


def _config(name):
    bench = spec.load_benchmark()
    (c,) = [c for c in bench["configs"] if c["name"] == name]
    return json.loads((ROOT / c["file"]).read_text())


@pytest.mark.parametrize("config", ["resnet50", "vgg16"])
def test_reference_equals_cpu_session(config):
    """At 32 pixels, on parameters drawn as a cell draws them, the
    reference's probabilities are the CPU session's: the parameter
    mapping, the BN fold, the pools and the flatten order agree."""
    from repro_torch.engine.session import compile

    torch.manual_seed(0)
    cfg = _config(config)
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


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_limit(cell, seed):
    """The control, the reference in TF32 (operands rounded to 10 mantissa
    bits as the card's TF32 does), fails each cell's limit at 32 pixels."""
    c = spec.resolve(cell)
    cfg = c.config
    mod = references.load(cfg["reference"])
    args = cfg["reference_args"]
    dev = torch.device("cpu")
    specs = mod.param_specs(image=32, classes=cfg["classes"], **args)
    g = generator(seed, dev)
    params = draw_params(specs, cfg["weights"], g, dev)
    x = draw_images(8, 32, g, dev)
    want = compare.reference_outputs(mod, params, [x], args, dev)
    got = compare.reference_outputs(mod, params, [x], args, dev, "tf32")
    gap = compare.logprob_gap([(0, got[0])], want)
    assert gap > c.workload["limits"]["logprob_gap"]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11 + 2.0 ** -12,
                      -3.0 - 2.0 ** -12, 1.0 + 2.0 ** -12])
    assert references.round_tf32(x).tolist() == [
        1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0, 1.0]
