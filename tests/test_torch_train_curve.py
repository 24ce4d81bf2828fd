"""Port parity over a long run: 200 steps of ``train.main --device cpu``
from the port's own seed-0 weights against the reference's ``main``
resumed from the same weights (the port's ``CheckpointStore`` saves the
step-0 state, the reference's restores it).

The loss curves agree step for step, so whether a reduced config learns
over 200 steps (reduced qwen2-1.5b does, reduced mamba2-130m does not) is
the config's and the data's, the same in both packages.  Run as a script,
it prints each package's mean loss over the first and last ``WINDOW``
steps and the standard error of their difference:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_curve.py
"""
import contextlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch.train import main as r_train_main
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.train import main as train_main
from repro_torch.models.lm import model as TM
from repro_torch.optim import AdamW
from repro_torch.runtime import compression

STEPS, BATCH, SEQ, WINDOW = 200, 4, 32, 10
# fp32 sums in another order, through 200 Adam steps (measured on the
# CPU: 9.2e-7 for mamba2, 2.2e-7 for qwen2)
CURVE_REL = 1e-5


def curves(name: str, root: Path) -> tuple:
    """(reference losses, port losses) of ``STEPS`` steps from the port's
    seed-0 state."""
    cfg = reduced(ARCHS[name])
    p = TM.init_params(cfg, 0, "cpu")
    CheckpointStore(root / "r" / cfg.name).save(
        0, (p, AdamW(lr=1e-3).init(p), compression.init_error(p)))
    args = ["--arch", name, "--steps", str(STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--log-every", str(STEPS),
            "--ckpt-every", str(STEPS)]
    with contextlib.redirect_stdout(io.StringIO()):
        want = r_train_main(args + ["--ckpt-dir", str(root / "r"),
                                    "--resume"])
        got = train_main(args + ["--ckpt-dir", str(root / "p"),
                                 "--device", "cpu"])
    return np.asarray(want), np.asarray(got)


def summary(losses: np.ndarray) -> dict:
    """The first and last ``WINDOW`` losses' means, their drop and its
    standard error."""
    a, b = losses[:WINDOW], losses[-WINDOW:]
    return {"first": float(a.mean()), "last": float(b.mean()),
            "drop": float(a.mean() - b.mean()),
            "se": float(np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / WINDOW))}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["mamba2-130m", "qwen2-1.5b"])
def test_long_run_follows_the_reference_from_the_ports_weights(tmp_path,
                                                                name):
    want, got = curves(name, tmp_path)
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=CURVE_REL)


if __name__ == "__main__":
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        for arch in sys.argv[1:] or ["mamba2-130m", "qwen2-1.5b"]:
            ref, port = curves(arch, Path(tmp) / arch)
            print(json.dumps({
                "arch": arch, "steps": STEPS, "batch": BATCH, "seq": SEQ,
                "reference": summary(ref), "port": summary(port),
                "max_rel": float(np.abs(port / ref - 1).max())}))
