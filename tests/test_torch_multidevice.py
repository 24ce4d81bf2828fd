"""Batch-sharded CNN sessions (``devices=D``) against the reference's.

* The reference's ``tests/test_multicore.py`` cases for the port:
  ``test_specialize_rejects_indivisible_bucket``,
  ``test_compile_eager_rejects_indivisible_base_batch`` and
  ``test_missing_devices_error_names_the_fix`` (here: cards asked for on
  a host without them).
* The port's ``devices=2`` predict, its D shards run in turn on the CPU,
  against the reference's ``devices=2`` predict (``shard_map`` over two
  forced host devices, in a child process as its own test runs it) on the
  same seeded graph and inputs: rtol = atol = 1e-5.
* An artifact saved at ``devices=2`` by either package loads in the other,
  re-targeted to 1, and, re-saved at 1, back to 2.
* An ``AsyncServer`` over a 2-device session answers bit-identical to its
  ``padded_predict``; ``--devices 2`` reaches the session through the
  serving command line on ``--device cpu``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.graph import Graph
from repro_torch.engine import (AsyncServer, CompiledModel,
                                DynamicBatchPolicy, InferenceSession,
                                compile, padded_predict)
from repro_torch.engine.executor import shard_devices
from repro_torch.launch import serve
from repro_torch.launch.cpu import check_devices

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _mini_net(batch=1):
    """The reference's ``test_multicore._mini_net``."""
    g = Graph()
    g.add("in", "input")
    g.add("c1", "conv2d", ["in"], in_channels=3, out_channels=16, kh=3,
          kw=3, stride=2, pad=1)
    g.add("bn1", "batch_norm", ["c1"])
    g.add("r1", "relu", ["bn1"])
    g.add("gap", "global_avg_pool", ["r1"])
    g.add("fl", "flatten", ["gap"])
    g.add("fc", "dense", ["fl"], units=10)
    g.mark_output("fc")
    return g, {"in": (batch, 3, 16, 16)}


def _x(batch, seed=0):
    return np.random.default_rng(seed).normal(
        size=(batch, 3, 16, 16)).astype(np.float32)


def test_specialize_rejects_indivisible_bucket():
    g, shapes = _mini_net()
    sess = compile(g, shapes, devices=2, eager=False, device="cpu")
    with pytest.raises(ValueError, match="not divisible by devices"):
        sess.specialize(3)


def test_compile_eager_rejects_indivisible_base_batch():
    g, shapes = _mini_net(batch=3)
    with pytest.raises(ValueError, match="not divisible by devices"):
        compile(g, shapes, devices=2, device="cpu")


def test_missing_devices_error_names_the_fix():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("host already exposes two cards")
    g, shapes = _mini_net(batch=2)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for call in (lambda: compile(g, shapes, devices=2, eager=False),
                 lambda: check_devices(2),
                 lambda: shard_devices(2, "cuda")):
        with pytest.raises(RuntimeError) as e:
            call()
        msg = str(e.value)
        assert f"2 CUDA device(s) requested, {seen} visible" in msg
        assert "CUDA_VISIBLE_DEVICES" in msg and "device='cpu'" in msg
    assert check_devices(2, "cpu") == 2
    with pytest.raises(ValueError, match=">= 1"):
        check_devices(0, "cpu")


def test_sharded_model_plans_the_sub_batch_and_runs_each_shard():
    g, shapes = _mini_net(batch=2)
    s1 = compile(g, shapes, device="cpu")
    s2 = compile(g, shapes, devices=2, device="cpu")
    m = s2.specialize(4)
    assert s2.devices == m.devices == 2 and s2.batch_sizes == [2, 4]
    # the plan is the per-device sub-batch's
    assert m.plan.planned.graph.nodes["in"].shape[0] == 2
    assert s1.plan_for(4).planned.graph.nodes["in"].shape[0] == 4
    assert m.replica("cpu") is m
    seen = []
    real = CompiledModel._walk

    def spy(self, inputs):
        seen.append(tuple(inputs["in"].shape))
        return real(self, inputs)

    x = torch.from_numpy(_x(4))
    CompiledModel._walk = spy
    try:
        y2 = s2.predict(x)
    finally:
        CompiledModel._walk = real
    assert seen == [(2, 3, 16, 16)] * 2
    np.testing.assert_allclose(y2.numpy(), s1.predict(x).numpy(), **TOL)
    assert s2.predict(x).numpy().tobytes() == y2.numpy().tobytes()
    with pytest.raises(ValueError, match="not divisible by devices=2"):
        m.predict(torch.from_numpy(_x(3)))
    with pytest.raises(ValueError, match=">= 1"):
        CompiledModel(plan=m.plan, params=m.params, devices=0)
    with pytest.raises(ValueError, match="whole-graph dispatch"):
        CompiledModel(plan=m.plan, params=m.params, devices=2,
                      dispatch="op")


_REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.core.graph import Graph
    from repro.engine import InferenceSession, compile as compile_session

    assert len(jax.devices()) == 2, jax.devices()
    work = sys.argv[1]
    g = Graph()
    g.add("in", "input")
    g.add("c1", "conv2d", ["in"], in_channels=3, out_channels=16, kh=3,
          kw=3, stride=2, pad=1)
    g.add("bn1", "batch_norm", ["c1"])
    g.add("r1", "relu", ["bn1"])
    g.add("gap", "global_avg_pool", ["r1"])
    g.add("fl", "flatten", ["gap"])
    g.add("fc", "dense", ["fl"], units=10)
    g.mark_output("fc")
    x = jnp.asarray(np.load(work + "/x.npy"))
    s2 = compile_session(g, {"in": (2, 3, 16, 16)}, devices=2, seed=0)
    s2.specialize(4)
    out = {"ref_d2": np.asarray(s2.predict(x))}
    s2.save(work + "/ref_d2")
    # the port's devices=2 artifact: re-targeted to 1, then back to 2
    port = InferenceSession.load(work + "/port_d2", devices=1)
    assert port.devices == 1 and port.batch_sizes == []
    out["ref_loads_port_d1"] = np.asarray(port.predict(x))
    port.save(work + "/ref_resaved_d1")
    back = InferenceSession.load(work + "/ref_resaved_d1", devices=2)
    assert back.devices == 2
    out["ref_loads_port_back_d2"] = np.asarray(back.predict(x))
    as_saved = InferenceSession.load(work + "/port_d2")
    assert as_saved.devices == 2
    out["ref_loads_port_d2"] = np.asarray(as_saved.predict(x))
    np.savez(work + "/out.npz", **out)
    print("REFERENCE-OK")
""")


def test_devices2_predict_and_artifacts_cross_the_packages(tmp_path):
    g, shapes = _mini_net(batch=2)
    x = _x(4, seed=1)
    np.save(tmp_path / "x.npy", x)
    port = compile(g, shapes, devices=2, seed=0, device="cpu")
    got = port.predict(torch.from_numpy(x)).numpy()
    port.save(tmp_path / "port_d2")
    manifest = json.loads((tmp_path / "port_d2" / "manifest.json")
                          .read_text())
    assert manifest["devices"] == 2 and manifest["source"] is not None
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    ref = dict(np.load(tmp_path / "out.npz"))
    want = ref["ref_d2"]
    # the port's devices=2 predict against the reference's
    np.testing.assert_allclose(got, want, **TOL)
    for k in ("ref_loads_port_d1", "ref_loads_port_back_d2",
              "ref_loads_port_d2"):
        np.testing.assert_allclose(ref[k], want, **TOL, err_msg=k)
    # the reference's devices=2 artifact in the port: as saved, at 1, back
    as_saved = InferenceSession.load(tmp_path / "ref_d2", device="cpu")
    assert as_saved.devices == 2 and as_saved.batch_sizes == [2, 4]
    np.testing.assert_allclose(
        as_saved.predict(torch.from_numpy(x)).numpy(), want, **TOL)
    one = InferenceSession.load(tmp_path / "ref_d2", device="cpu",
                                devices=1)
    assert one.devices == 1 and one.batch_sizes == []
    np.testing.assert_allclose(one.predict(torch.from_numpy(x)).numpy(),
                               want, **TOL)
    one.save(tmp_path / "port_resaved_d1")
    back = InferenceSession.load(tmp_path / "port_resaved_d1",
                                 device="cpu", devices=2)
    assert back.devices == 2
    np.testing.assert_allclose(back.predict(torch.from_numpy(x)).numpy(),
                               want, **TOL)


def test_retarget_needs_a_packed_source(tmp_path):
    g, shapes = _mini_net(batch=2)
    sess = compile(g, shapes, devices=2, device="cpu")
    sess.save(tmp_path / "art", include_source=False)
    assert InferenceSession.load(tmp_path / "art", device="cpu").devices == 2
    with pytest.raises(ValueError, match="packs no source"):
        InferenceSession.load(tmp_path / "art", device="cpu", devices=1)


def test_server_over_two_devices_is_bit_identical_to_padded_predict():
    g, shapes = _mini_net(batch=2)
    sess = compile(g, shapes, devices=2, device="cpu")
    sess.specialize(4)
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(int(n), 3, 16, 16)).astype(np.float32)
          for n in rng.integers(1, 4, size=10)]
    refs = [padded_predict(sess, x).numpy() for x in xs]
    policy = DynamicBatchPolicy(max_batch=4, max_wait_ms=5.0)
    with AsyncServer(sess, policy, max_queue=64) as srv:
        futs = [srv.submit(x) for x in xs]
        got = [f.result(timeout=60).numpy() for f in futs]
    for g_, r in zip(got, refs):
        assert g_.shape == r.shape and g_.tobytes() == r.tobytes()
    assert set(sess.batch_sizes) <= {2, 4}


def test_devices_flag_reaches_the_session(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    g, shapes = _mini_net(batch=2)
    compile(g, shapes, device="cpu").save(tmp_path / "art")
    out = serve.main(["--artifact", str(tmp_path / "art"), "--device",
                      "cpu", "--devices", "2", "--requests", "4",
                      "--max-batch", "2"])
    printed = capsys.readouterr().out
    assert "devices=2 device=cpu" in printed
    assert out.shape == (1, 10)
    with pytest.raises(RuntimeError, match="2 CUDA device"):
        serve.main(["--artifact", str(tmp_path / "art"), "--devices", "2",
                    "--requests", "1"])
