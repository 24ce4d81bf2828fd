"""Port parity end to end, and the session around it.

(g) The port's ResNet-18 at (2, 3, 32, 32) on the CPU against the
    reference's ``compile(...).predict``: once on the reference's own plan
    (crossed as JSON) with the reference's weights (through
    ``params_from_numpy``), once on the port's own plan for the H100
    machine model.  Tolerance rtol=1e-4, atol=1e-5 on the softmax
    probabilities, with equal argmax: fp32 sums over up to 4,608 terms
    (512 channels x 3 x 3), taken in another order by each package's GEMMs,
    compounded through 20 layers.

The launch count of a predict on the card is checked in
``tests/test_torch_cuda.py``.
"""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import compile as r_compile
from repro.engine.session import _plan_to_json as r_plan_json
from repro_torch.engine import (CompiledModel, compile as t_compile,
                                compile_model, params_from_numpy)
from repro_torch.engine.session import _plan_from_json, _plan_to_json

TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (2, 3, 32, 32)


@pytest.fixture(scope="module")
def reference():
    sess = r_compile("resnet-18", SHAPE, seed=0)
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    return sess, x, np.asarray(sess.predict(jnp.asarray(x)))


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


@pytest.mark.parametrize("dispatch", ["whole", "op"])
def test_reference_plan_and_weights_match_reference(reference, dispatch):
    sess, x, want = reference
    js = json.loads(json.dumps(r_plan_json(sess.plan_for(SHAPE[0]))))
    model = compile_model(_plan_from_json(js),
                          params_from_numpy(sess._params, device="cpu"),
                          dispatch=dispatch)
    _close(model.predict(torch.from_numpy(x)).numpy(), want)


def test_own_h100_plan_matches_reference(reference):
    sess, x, want = reference
    port = t_compile("resnet-18", SHAPE, seed=0, device="cpu")
    assert port.input_spec == {"data": SHAPE}
    _close(port.predict(torch.from_numpy(x)).numpy(), want)
    # the same weights handed over explicitly give the same answer
    again = t_compile("resnet-18", SHAPE, device="cpu",
                      params=params_from_numpy(sess._params, device="cpu"))
    np.testing.assert_array_equal(
        again.predict(torch.from_numpy(x)).numpy(),
        port.predict(torch.from_numpy(x)).numpy())


def test_session_specializes_per_batch_once():
    sess = t_compile("resnet-18", (1, 3, 32, 32), device="cpu", eager=False)
    assert sess.batch_sizes == []
    models = []

    def spec():
        models.append(sess.specialize(3))

    threads = [threading.Thread(target=spec) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(models) == 4 and all(m is models[0] for m in models)
    assert sess.batch_sizes == [3]
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 3, 32, 32)).astype(np.float32))
    y = sess.predict(x)
    assert tuple(y.shape) == (3, 1000)
    torch.testing.assert_close(y, sess({"data": x}), rtol=0, atol=0)
    assert sess.plan_for(3) is models[0].plan


def test_plan_json_round_trips():
    sess = t_compile("resnet-18", (1, 3, 32, 32), device="cpu")
    js = json.loads(json.dumps(_plan_to_json(sess.plan_for(1))))
    again = _plan_to_json(_plan_from_json(js))
    again.pop("report")
    js.pop("report")
    assert json.loads(json.dumps(again)) == js


def test_compile_rejects_what_it_cannot_run():
    with pytest.raises(ValueError, match="square RGB"):
        t_compile("resnet-18", (1, 3, 32, 16), device="cpu")
    with pytest.raises(ValueError, match="NCHW"):
        t_compile("resnet-18", (1, 3, 32), device="cpu")
    with pytest.raises(ValueError, match="tuning"):
        t_compile("resnet-18", (1, 3, 32, 32), device="cpu",
                  tuning="guess")
    sess = t_compile("resnet-18", (1, 3, 32, 32), device="cpu")
    with pytest.raises(ValueError, match="dispatch"):
        CompiledModel(plan=sess.plan_for(1), params={}, dispatch="jit")


def test_chip_smoke_main_phase_runs_on_cpu():
    """chip_smoke's end-to-end phase at a tiny size: on CPU tensors the
    wrappers take the plain versions, so no kernel launches."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.phase_main("cpu", image=32, requests=2, big_batch=2)
    assert out["conv_blocks"] == 53 and out["launches"] == 0
    assert out["requests"] == [1, 1, 2]


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_chip_smoke_main_phase_on_the_lowerings_runs_on_cpu(dtype):
    """The ``variants`` phase's sessions at a tiny size: ``use_kernel=False``
    runs one lowering per conv node a predict, in the plan's variants and
    dtypes, and no kernel."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.phase_main("cpu", image=32, requests=1, big_batch=2,
                           use_kernel=False, dtype=dtype)
    assert out["launches"] == 0 and out["dtype"] == dtype
    assert sum(out["plan_variants"].values()) == out["conv_nodes"] == 53
    assert sum(out["lowering_calls"].values()) == 2 * 53
    assert (dtype == "int8") == any(k.endswith("/int8")
                                    for k in out["lowering_calls"])
