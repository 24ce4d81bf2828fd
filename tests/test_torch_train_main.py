"""Port parity: the trainer, ``launch/train.py`` (``make_train_step`` and
``main``), against the reference's on the CPU.

* One ``make_train_step`` step against the reference's jitted one from the
  same parameters, state and batch, with and without compression.
* ``train.main --device cpu``: from the reference's own step-0 weights
  (saved by the reference's ``CheckpointStore``, resumed by the port) the
  port's losses follow the reference's ``main`` within rtol 1e-5 (1e-4
  with ``--compress-grads``: an int8 code that flips on the last bit of a
  gradient changes it by one quantum), so the reference's system tests'
  assertions (the loss falls, compressed training learns) hold in the
  port; a restart is bit-identical on the CPU; the port's checkpoints
  restore in the reference; with no card and no ``--device cpu`` it
  raises.
"""
import contextlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as RStore
from repro.configs import ARCHS as R_ARCHS, reduced as r_reduced
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticLMStream as RStream
from repro.launch.train import main as r_train_main
from repro.models.lm import model as RM
from repro.optim import AdamW as RAdamW
from repro.runtime import compression as rcomp
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import lm_params_from_numpy
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import make_train_step
from repro_torch.optim import AdamW, cosine_lr
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import compression


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and under the
    suite's parallel workers a pool of threads a worker oversubscribes
    the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, seed=0):
    r_cfg, t_cfg = r_reduced(R_ARCHS[name]), reduced(ARCHS[name])
    r_p = RM.init_params(r_cfg, jax.random.PRNGKey(seed))
    return r_cfg, t_cfg, r_p, lm_params_from_numpy(r_p, "cpu")


def _batch(cfg, batch=2, seq=16, step=3):
    return RStream(RDataConfig(batch, seq, cfg.vocab), cfg).global_batch(step)


def test_make_train_step_matches_reference_step():
    """One step of the port's ``make_train_step`` against the reference's
    jitted one from the same parameters, state and batch, with and
    without compression: loss, grad norm, parameters within 2 lr where a
    near-zero gradient may take the other sign (plus 1e-6), moments."""
    from repro.launch.train import make_train_step as r_make

    for compress in (False, True):
        r_cfg, t_cfg, r_p, t_p = _setup("qwen2-1.5b")
        r_opt, t_opt = RAdamW(lr=1e-3), AdamW(lr=1e-3)
        batch = _batch(r_cfg)
        r_out = r_make(r_cfg, r_opt, compress)(
            r_p, r_opt.init(r_p), rcomp.init_error(r_p),
            {k: jnp.asarray(v) for k, v in batch.items()}, 1.0)
        t_out = make_train_step(t_cfg, t_opt, compress)(
            t_p, t_opt.init(t_p), compression.init_error(t_p),
            {k: torch.from_numpy(v) for k, v in batch.items()},
            cosine_lr(10, base=1.0, warmup=10, total=30))
        np.testing.assert_allclose(float(t_out[3]), float(r_out[3]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(t_out[4]), float(r_out[4]),
                                   rtol=1e-4)
        for g, w in zip(tree_leaves(t_out[0]), jax.tree.leaves(r_out[0])):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 2e-3 + 1e-6 * np.abs(
                w).max()
        assert int(t_out[1].step) == int(r_out[1].step) == 1


def _quiet(fn, args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(args)


def _reference_step0(root: Path, name: str) -> None:
    """The reference's ``main`` initial state, saved at step 0 by the
    reference's ``CheckpointStore`` where the port's ``main`` looks."""
    cfg = r_reduced(R_ARCHS[name])
    p = RM.init_params(cfg, jax.random.PRNGKey(0))
    RStore(root / cfg.name).save(
        0, (p, RAdamW(lr=1e-3).init(p), rcomp.init_error(p)))


@pytest.mark.parametrize("case", [
    ("mamba2-130m", [], 1e-5),                       # test_system.py:48
    ("qwen2-1.5b", ["--compress-grads"], 1e-4),      # test_system.py:78
])
def test_train_main_follows_the_reference_from_its_weights(tmp_path, case):
    name, extra, rel = case
    args = ["--arch", name, "--steps", "30", "--batch", "4", "--seq", "32",
            "--log-every", "100", *extra]
    want = _quiet(r_train_main, args + ["--ckpt-dir", str(tmp_path / "r")])
    _reference_step0(tmp_path / "p", name)
    got = _quiet(train_main, args + ["--ckpt-dir", str(tmp_path / "p"),
                                     "--resume", "--device", "cpu"])
    assert len(got) == len(want) == 30
    np.testing.assert_allclose(got, want, rtol=rel)
    assert got[-1] < got[0]          # the reference's system tests' assert


def test_train_restart_is_bit_identical(tmp_path):
    """The reference's test_train_restart_continues on the port's own
    weights: 10 straight steps against 5 and a resumed 5, every resumed
    loss equal to the straight run's on the CPU; the saved step-5 leaves
    restore bit for bit."""
    args = ["--arch", "qwen2-1.5b", "--batch", "2", "--seq", "16",
            "--ckpt-every", "5", "--log-every", "100", "--device", "cpu"]
    full = _quiet(train_main, args + ["--steps", "10",
                                      "--ckpt-dir", str(tmp_path / "a")])
    part = _quiet(train_main, args + ["--steps", "5",
                                      "--ckpt-dir", str(tmp_path / "b")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        resumed = train_main(args + ["--steps", "10", "--resume",
                                     "--ckpt-dir", str(tmp_path / "b")])
    assert "resumed from step 5" in out.getvalue()
    assert part == full[:5] and resumed == full[5:]
    store = CheckpointStore(tmp_path / "a" / "qwen2-1.5b-reduced")
    assert store.steps() == [5, 10]
    leaves, _, meta = store.restore_flat(10)
    assert meta["loss"] == pytest.approx(full[-1])
    assert leaves["[1][0]"].shape == () and int(leaves["[1][0]"]) == 10


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A checkpoint of the port's trainer restores in the reference with
    the reference's own template: the same leaf names, shapes and types
    (the optimizer's step 0-d)."""
    _quiet(train_main, ["--arch", "mamba2-130m", "--steps", "2", "--batch",
                        "2", "--seq", "16", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path)])
    cfg = r_reduced(R_ARCHS["mamba2-130m"])
    p = RM.init_params(cfg, jax.random.PRNGKey(0))
    template = (p, RAdamW(lr=1e-3).init(p), rcomp.init_error(p))
    (rp, ropt, _), step, _ = RStore(tmp_path / cfg.name).restore(template)
    assert step == 2 and int(ropt.step) == 2 and np.shape(ropt.step) == ()
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(p)):
        assert np.shape(a) == np.shape(b)


def test_train_main_needs_a_card_unless_asked_for_the_cpu(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_main(["--arch", "mamba2-130m", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
