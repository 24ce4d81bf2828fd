"""Port parity end to end for the zoo's other families, on the CPU.

Each network's CPU session against the reference's ``compile(...).predict``
on the same numpy input: once on the port's own plan for the H100 machine
model, once on the reference's plan (crossed as JSON) with the reference's
weights (through ``params_from_numpy``); and ``chip_smoke.phase_main``, the
card's serving phase, rehearsed at the same size with no kernel launches.
Tolerance: rtol=1e-4, atol=1e-5 on the softmax probabilities, with equal
argmax, as ``test_torch_e2e.py``; SSD's two outputs (box offsets and class
scores, of order 1e3 with random weights) to the same rtol and 1e-5 of
their largest value.  fp32 sums of up to 4,608 terms (SSD: 18,432) in
another order, compounded through up to 120 convs.

vgg-11 is here, with the checks the other families' files share
(``test_torch_zoo_e2e_{densenet,inception,ssd}.py``): one network a file
keeps each file under a minute.
"""
import functools
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import compile as r_compile
from repro.engine.session import _plan_to_json as r_plan_json
from repro_torch.engine import compile as t_compile, compile_model
from repro_torch.engine import params_from_numpy
from repro_torch.engine.session import _plan_from_json

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 2
# model -> (image, conv nodes of its H100 plan at that image)
SIZES = {"vgg-11": (32, 8), "densenet-121": (32, 120),
         "inception-v3": (75, 94), "ssd-resnet-50": (64, 73)}
RAW_OUTPUTS = {"ssd-resnet-50"}      # outputs that are not probabilities


def _shape(model):
    image = SIZES[model][0]
    return (BATCH, 3, image, image)


def _outputs(y):
    return [np.asarray(t) for t in (y if isinstance(y, tuple) else (y,))]


@functools.lru_cache(maxsize=None)
def reference(model):
    sess = r_compile(model, _shape(model), seed=0)
    x = np.random.default_rng(1).normal(size=_shape(model)).astype(
        np.float32)
    return sess, x, _outputs(sess.predict(jnp.asarray(x)))


def close(model, y, want):
    got = _outputs(y)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        if model in RAW_OUTPUTS:
            np.testing.assert_allclose(
                g, w, rtol=TOL["rtol"], atol=TOL["atol"] * np.abs(w).max())
        else:
            np.testing.assert_allclose(g, w, **TOL)
            np.testing.assert_array_equal(g.argmax(axis=1),
                                          w.argmax(axis=1))


def check_own_h100_plan(model):
    _, x, want = reference(model)
    port = t_compile(model, _shape(model), seed=0, device="cpu")
    assert port.input_spec == {"data": _shape(model)}
    close(model, port.predict(torch.from_numpy(x)), want)


def check_reference_plan_and_weights(model):
    sess, x, want = reference(model)
    js = json.loads(json.dumps(r_plan_json(sess.plan_for(BATCH))))
    port = compile_model(_plan_from_json(js),
                         params_from_numpy(sess._params, device="cpu"))
    close(model, port.predict(torch.from_numpy(x)), want)


def check_chip_smoke_phase(model):
    """chip_smoke's serving phase for a zoo network at a tiny size: on CPU
    tensors the wrappers take the plain versions, so no kernel launches."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    image, n_convs = SIZES[model]
    out = smoke.phase_main("cpu", image=image, requests=1, big_batch=2,
                           model=model)
    assert out["conv_nodes"] == n_convs and out["launches"] == 0
    assert out["requests"] == [1, 2]


MODELS = ["vgg-11"]


@pytest.mark.parametrize("model", MODELS)
def test_own_h100_plan_matches_reference(model):
    check_own_h100_plan(model)


@pytest.mark.parametrize("model", MODELS)
def test_reference_plan_and_weights_match_reference(model):
    check_reference_plan_and_weights(model)


@pytest.mark.parametrize("model", MODELS)
def test_chip_smoke_zoo_phase_runs_on_cpu(model):
    check_chip_smoke_phase(model)
