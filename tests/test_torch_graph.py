"""Port parity: graphs, parameters and bound parameters.

(b) ``init_params`` draws the reference's numpy ``default_rng(seed)``
    values in the same order, so the parameters are bit-equal;
(c) the zoo graphs serialize to the reference's graph JSON;
(e) ``bind_params`` on a plan that crossed from the reference as JSON
    gives the reference's bound parameters bit for bit (the BN fold is one
    fp32 multiply per element on both sides).
"""
import json

import numpy as np
import pytest
import torch

from repro.core.pipeline import MODES, Pipeline as RPipeline
from repro.engine.executor import bind_params as r_bind
from repro.engine.session import _graph_to_json as r_graph_json
from repro.engine.session import _plan_from_json as r_plan_from_json
from repro.engine.session import _plan_to_json as r_plan_json
from repro.models.cnn import build as r_build
from repro.nn.init import init_params as r_init
from repro_torch.engine import (CompiledModel, bind_params as t_bind,
                                params_from_numpy)
from repro_torch.engine.session import (_graph_from_json, _graph_to_json,
                                        _plan_from_json, _plan_to_json)
from repro_torch.models.cnn import MODELS, build as t_build
from repro_torch.nn.init import init_params as t_init


def _leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for node in want:
        assert sorted(want[node]) == sorted(got[node]), node
        for leaf, arr in want[node].items():
            g = got[node][leaf]
            assert isinstance(g, torch.Tensor)
            assert g.numpy().dtype == np.asarray(arr).dtype, (node, leaf)
            np.testing.assert_array_equal(g.numpy(), np.asarray(arr),
                                          err_msg=f"{node}.{leaf}")


@pytest.mark.parametrize("model,image", [("resnet-18", 32),
                                         ("resnet-50", 224)])
def test_graph_json_matches_reference(model, image):
    rg, rs = r_build(model, batch=2, image=image)
    tg, ts = t_build(model, batch=2, image=image)
    assert rs == ts
    rg.infer_shapes(rs)
    tg.infer_shapes(ts)
    want = json.loads(json.dumps(r_graph_json(rg)))
    got = json.loads(json.dumps(_graph_to_json(tg)))
    assert got == want
    # and it reads back into the same graph
    assert _graph_to_json(_graph_from_json(got)) == got


@pytest.mark.parametrize("model,image", [("resnet-18", 32),
                                         ("resnet-50", 224)])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_bit_equal(model, image, seed):
    rg, rs = r_build(model, batch=1, image=image)
    tg, ts = t_build(model, batch=1, image=image)
    want = r_init(rg, rs, seed=seed)
    got = t_init(tg, ts, seed=seed, device="cpu")
    _leaves_equal(want, got)


def test_zoo_holds_the_resnets():
    """The ResNets among the paper's 15 networks (Table 2), and nothing
    else: an unknown name raises."""
    assert sorted(MODELS) == sorted(
        [f"resnet-{d}" for d in (18, 34, 50, 101, 152)]
        + [f"vgg-{d}" for d in (11, 13, 16, 19)]
        + [f"densenet-{d}" for d in (121, 161, 169, 201)]
        + ["inception-v3", "ssd-resnet-50"])
    with pytest.raises(KeyError):
        t_build("vgg-17")


@pytest.mark.parametrize("mode", MODES)
def test_bind_params_match_reference_on_crossed_plan(mode):
    rg, rs = r_build("resnet-18", batch=2, image=32)
    params = r_init(rg, rs, seed=1)
    plan = RPipeline.preset(mode).run(rg, rs)
    crossed = _plan_from_json(json.loads(json.dumps(r_plan_json(plan))))
    want = r_bind(plan, params)
    got = t_bind(crossed, params_from_numpy(params, device="cpu"))
    _leaves_equal(want, got)
    # the plan reads back to the same JSON it came from
    got_js = _plan_to_json(crossed)
    want_js = r_plan_json(plan)
    for js in (got_js, want_js):
        js.pop("report")
    assert json.loads(json.dumps(got_js)) == json.loads(json.dumps(want_js))


def test_bind_rejects_int8_schedules():
    """An int8 schedule binds to the reference's per-channel int8 codes and
    dequantize scale, bit for bit; the kernel path, which has no int8
    instantiation, rejects it at predict, naming ``use_kernel=False``."""
    rg, rs = r_build("resnet-18", batch=1, image=32)
    params = r_init(rg, rs, seed=0)
    js = json.loads(json.dumps(r_plan_json(
        RPipeline.preset("fusion").run(rg, rs))))
    name = next(iter(js["schedules"]))
    js["schedules"][name].update(dtype="int8", variant="tap_stack")
    want = r_bind(r_plan_from_json(json.loads(json.dumps(js))), params)
    crossed = _plan_from_json(js)
    got = t_bind(crossed, params_from_numpy(params, device="cpu"))
    _leaves_equal(want, got)
    assert got[name]["w"].dtype == torch.int8 and "scale" in got[name]
    model = CompiledModel(plan=crossed, params=got)
    with pytest.raises(ValueError, match="use_kernel=False"):
        model.predict(torch.zeros(rs[model.input_name]))
