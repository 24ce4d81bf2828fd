"""Port parity for the paper's whole CNN zoo: graphs, parameters, plans.

(c) every one of the 15 networks serializes to the reference's graph JSON;
(b) ``init_params`` is bit-equal to the reference's for one network of each
    family that is not a ResNet (VGG, DenseNet, Inception, SSD);
(d) under the reference's TPU constants the port's "fusion" plan is the
    reference's for those four, at small images;
and, on the port's own H100 machine model at each network's published
resolution, the plan's structure: every conv blocked, with the concat
stores, fused pools and unfused convs that B1's launches then run.
"""
import json

import numpy as np
import pytest
import torch

from repro.engine.session import _graph_to_json as r_graph_json
from repro.models.cnn import MODELS as R_MODELS, build as r_build
from repro.nn.init import init_params as r_init
from repro_torch.core.pipeline import Pipeline as TPipeline
from repro_torch.engine import compile as t_compile
from repro_torch.engine.session import _graph_to_json
from repro_torch.models.cnn import build as t_build
from repro_torch.nn.init import init_params as t_init

from test_torch_plan import _plans, _split

# the smallest images at which every stride of a family still leaves a map
SMALL = {"inception-v3": 75, "ssd-resnet-50": 64}
FAMILIES = [("vgg-11", 32), ("densenet-121", 32), ("inception-v3", 75),
            ("ssd-resnet-50", 64)]


@pytest.mark.parametrize("model", sorted(R_MODELS))
def test_graph_json_matches_reference(model):
    image = SMALL.get(model, 32)
    rg, rs = r_build(model, batch=2, image=image)
    tg, ts = t_build(model, batch=2, image=image)
    assert rs == ts
    rg.infer_shapes(rs)
    tg.infer_shapes(ts)
    assert json.loads(json.dumps(_graph_to_json(tg))) == \
        json.loads(json.dumps(r_graph_json(rg)))


@pytest.mark.parametrize("model,image", FAMILIES)
def test_init_params_bit_equal(model, image):
    rg, rs = r_build(model, batch=1, image=image)
    tg, ts = t_build(model, batch=1, image=image)
    want = r_init(rg, rs, seed=2)
    got = t_init(tg, ts, seed=2, device="cpu")
    assert sorted(want) == sorted(got)
    for node, leaves in want.items():
        assert sorted(leaves) == sorted(got[node]), node
        for leaf, arr in leaves.items():
            g = got[node][leaf]
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(arr),
                                          err_msg=f"{node}.{leaf}")


@pytest.mark.parametrize("model,image", FAMILIES)
def test_plan_matches_reference(model, image):
    want, got = _plans(model, image, 1, "fusion")
    (want_js, want_pred), (got_js, got_pred) = _split(want), _split(got)
    assert got_js == want_js
    assert got_pred == pytest.approx(want_pred, rel=1e-9)
    assert got["report"]["n_fused_blocks"] == want["report"]["n_fused_blocks"]


# model, image -> conv nodes, concat-offset stores, fused pools, unfused
# conv2d nodes (SSD's multibox heads)
H100_PLANS = {
    ("vgg-16", 224): (13, 0, 5, 0),
    ("densenet-121", 224): (120, 58, 4, 0),
    ("inception-v3", 299): (94, 33, 2, 0),
    ("ssd-resnet-50", 512): (73, 0, 1, 12),
}


@pytest.mark.parametrize("model,image", sorted(H100_PLANS))
def test_h100_plan_blocks_every_conv(model, image):
    g, s = t_build(model, batch=1, image=image)
    planned = TPipeline.preset("fusion").run(g, s).planned
    nodes = planned.graph.topo_order()
    convs = [n for n in nodes if n.op in ("conv_block", "conv2d")]
    assert all(planned.layouts[n.name].is_blocked and
               n.name in planned.schedules for n in convs)
    blocks = [n for n in convs if n.op == "conv_block"]
    got = (len(convs), sum(bool(n.attrs.get("concat_into")) for n in blocks),
           sum(bool(n.attrs.get("pool_kind")) for n in blocks),
           len(convs) - len(blocks))
    assert got == H100_PLANS[(model, image)]


@pytest.mark.parametrize("model,image", [("densenet-121", 224),
                                         ("inception-v3", 299),
                                         ("ssd-resnet-50", 512)])
def test_compile_takes_the_builders_default_resolution(model, image):
    sess = t_compile(model, device="cpu", eager=False)
    assert sess.input_spec == {"data": (1, 3, image, image)}
    assert sess.batch_sizes == []
