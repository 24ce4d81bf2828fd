"""The port's three examples (``repro_torch.examples``) at a tiny size on
the CPU, against the reference.

* ``quickstart``: ResNet-18 at 32 through the five rungs of the Table-3
  ladder; every rung's output equals the ``nchw`` rung's within the
  reference's 1e-4, and the ``fusion`` rung equals the reference's
  ``compile_model(Pipeline.preset("fusion").run(...)).predict`` on the
  same seeded graph and input within rtol 1e-4, atol 1e-5 (fp32 sums in
  another order through 20 layers, as ``tests/test_torch_e2e.py``).  The
  printed latency is the H100 machine model's (``pred_h100``); no TPU
  figure is printed.
* ``serve_planned_cnn``: compile, ``specialize(8)``, save, and
  ``serve_artifact`` over the loaded artifact; the last response is bit
  for bit ``padded_predict`` of its request on that artifact at one of
  its buckets (1 or 8: the batch the server packed it into).
* ``train_lm_fault_tolerant``: the 25 steps of reduced qwen2 with host 2
  silent from step 12, against the same loop run by the reference's own
  ``loss_fn`` (jitted ``value_and_grad``), ``AdamW``, ``CheckpointStore``
  and runtime from the port's weights and stream: the same lines at the
  same steps (the failure, the re-mesh, the restore, the re-splits), and
  every step's loss within 1e-5 relative.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as RStore
from repro.core.pipeline import Pipeline as RPipeline
from repro.engine import compile_model as r_compile_model
from repro.models.cnn import build as r_build
from repro.models.lm import loss_fn as r_loss_fn
from repro.nn.init import init_params as r_init
from repro.optim import AdamW as RAdamW
from repro.runtime import (HeartbeatMonitor, StragglerMitigator,
                           StragglerPolicy, plan_elastic_mesh,
                           rebalanced_batch_split)
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.engine import InferenceSession, padded_predict
from repro_torch.examples import (quickstart, serve_planned_cnn,
                                  train_lm_fault_tolerant)
from repro_torch.models.lm.model import init_params
from repro_torch.optim.adamw import tree_map

TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_REL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_ladder_matches_the_reference(capsys):
    outs = quickstart.main(["resnet-18", "32", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert list(outs) == ["nchw", "layout", "transform-elim",
                          "global-search", "fusion"]
    for mode, out in outs.items():
        assert float((out - outs["nchw"]).abs().max()) < quickstart.TOL
    assert printed.count("pred_h100=") == 5 and "v5e" not in printed
    graph, shapes = r_build("resnet-18", batch=1, image=32)
    params = r_init(graph, shapes, seed=0)
    x = np.random.default_rng(0).normal(size=shapes["data"]).astype(
        np.float32)
    plan = RPipeline.preset("fusion").run(graph, shapes)
    want = np.asarray(r_compile_model(plan, params).predict(jnp.asarray(x)))
    np.testing.assert_allclose(outs["fusion"].numpy(), want, **TOL)
    assert outs["fusion"].argmax() == want.argmax()


def test_serve_planned_cnn_answers_as_padded_predict(tmp_path):
    n = 6
    out = serve_planned_cnn.main(["resnet-18", str(n), "--image", "32",
                                  "--device", "cpu", "--artifact",
                                  str(tmp_path / "art")])
    sess = InferenceSession.load(tmp_path / "art", device="cpu")
    assert sess.batch_sizes == [1, 8]
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(1, 3, 32, 32)).astype(np.float32)
          for _ in range(n)]
    wants = [padded_predict(sess, torch.from_numpy(xs[-1]), bucket=b)
             for b in sess.batch_sizes]
    assert any(out.shape == w.shape and out.numpy().tobytes()
               == w.numpy().tobytes() for w in wants)


def _reference_run(params, ckpt_dir):
    """The reference example's loop (``examples/train_lm_fault_tolerant.py``)
    through the reference's modules, from the port's weights ``params``
    and with the store in ``ckpt_dir``: its printed lines and losses."""
    from repro.configs import ARCHS as R_ARCHS, reduced as r_reduced
    from repro.data import DataConfig as RDataConfig
    from repro.data import SyntheticLMStream as RStream

    cfg = r_reduced(R_ARCHS["qwen2-1.5b"])
    opt = RAdamW(lr=1e-3)
    p = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    opt_state = opt.init(p)
    store = RStore(ckpt_dir)
    hosts = [0, 1, 2, 3]
    clock = [0.0]
    mon = HeartbeatMonitor(hosts, timeout_s=3.0, clock=lambda: clock[0])
    strag = StragglerMitigator(hosts, StragglerPolicy(slow_factor=1.5,
                                                      evict_after=3))
    dc = RDataConfig(global_batch=8, seq_len=32, vocab=cfg.vocab)
    stream = RStream(dc, cfg)

    @jax.jit
    def step_fn(params, opt_state, batch):
        (loss, _), g = jax.value_and_grad(r_loss_fn, has_aux=True)(
            params, cfg, batch)
        params, opt_state, _ = opt.update(g, opt_state, params)
        return params, opt_state, loss

    lines, losses = [], []
    alive = list(hosts)
    for step in range(train_lm_fault_tolerant.STEPS):
        clock[0] += 1.0
        for h in alive:
            if not (h == 2 and step >= 12):
                mon.beat(h)
        dead = mon.check()
        if dead:
            lines.append(f"step {step}: hosts {dead} FAILED — re-meshing")
            alive = mon.alive
            d, m = plan_elastic_mesh(len(alive) * 64, model_axis=16)
            lines.append(f"  elastic plan over {len(alive) * 64} chips: "
                         f"mesh ({d}, {m})")
            store.wait()
            (p, opt_state), ck_step, _ = store.restore((p, opt_state))
            lines.append(f"  restored checkpoint @ step {ck_step}; data "
                         f"stream re-addressed for {len(alive)} hosts")
        strag.record({h: (2.2 if h == 3 else 1.0) for h in alive})
        slow = strag.stragglers()
        if slow and step % 5 == 0:
            w = strag.batch_weights()
            split = rebalanced_batch_split(dc.global_batch,
                                           [w[h] for h in alive])
            lines.append(f"step {step}: stragglers {slow}; batch re-split "
                         f"{dict(zip(alive, split))}")
        batch = {k: jnp.asarray(v)
                 for k, v in stream.global_batch(step).items()}
        p, opt_state, loss = step_fn(p, opt_state, batch)
        losses.append(float(loss))
        if step % 5 == 0 or dead:
            lines.append(f"step {step:3d} loss {float(loss):.4f}")
        if (step + 1) % 6 == 0:
            store.save(step + 1, (p, opt_state), blocking=False)
    store.wait()
    return lines, losses


def test_fault_tolerant_training_follows_the_reference(tmp_path):
    got = train_lm_fault_tolerant.main(["--device", "cpu", "--ckpt-dir",
                                        str(tmp_path / "port")])
    cfg = reduced(ARCHS["qwen2-1.5b"])
    lines, losses = _reference_run(init_params(cfg, 0, "cpu"),
                                   tmp_path / "ref")
    assert got["lines"][-1].startswith("done")
    unlossed = lambda ls: [re.sub(r"loss \S+", "loss _", s)  # noqa: E731
                           for s in ls]
    assert unlossed(got["lines"][:-1]) == unlossed(lines)
    assert any("FAILED" in s for s in lines)
    assert "  restored checkpoint @ step 12; data stream re-addressed for " \
        "3 hosts" in lines
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_REL)
    # a stale store is cleared first: a second run restores its own step
    again = train_lm_fault_tolerant.main(["--device", "cpu", "--ckpt-dir",
                                          str(tmp_path / "port")])
    assert again["lines"] == got["lines"]


def test_examples_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod, argv in ((quickstart, ["resnet-18", "32"]),
                      (serve_planned_cnn, ["resnet-18", "2"]),
                      (train_lm_fault_tolerant, [])):
        with pytest.raises(RuntimeError, match="0 visible"):
            mod.main(argv)
