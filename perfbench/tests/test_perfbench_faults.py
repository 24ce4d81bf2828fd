"""Whole runs of each cell on the CPU at 32 pixels, the look for a card
skipped: a sound run is ``correct``, and each fault a cell can have,
planted in the timed path under the harness, makes it not correct."""
from __future__ import annotations

import pytest
import torch

from perfbench.harness.cell import run_cell

SMALL = {
    "resnet50.offline": {"config": {"image": 32}, "traffic": {"batch": 4}},
    "vgg16.single_stream": {"config": {"image": 32}},
    "resnet50.server": {"config": {"image": 32}, "workload": {
        "rate": 150, "buckets": [1, 2, 4],
        "policy": {"max_batch": 4, "max_wait_ms": 2.0}}},
}


def half_batch(y):
    """Half of the batch left out: its rows are the mean of the rest."""
    n = y.shape[0]
    if n < 2:
        return y
    y = y.clone()
    y[n // 2:] = y[:n // 2].mean(0)
    return y


def altered_answer(y):
    """One answer altered where it is produced: the first row's two
    largest probabilities swapped."""
    y = y.clone()
    top = torch.topk(y[0], 2).indices
    y[0, top] = y[0, top.flip(0)]
    return y


FAULTS = {"half_batch": half_batch, "altered_answer": altered_answer}


# the served cell's files, which BENCHMARK.json does not name (PERF.md:
# its tail follows the host's drift past any bound the check allows)
ENTRY = {"resnet50.server": {"name": "resnet50.server", "config": "resnet50",
                             "traffic": "poisson_single", "chips": 1}}


def _run(cell, monkeypatch, fault=None):
    from repro_torch.engine.executor import CompiledModel

    torch.set_num_threads(2)
    if fault is not None:
        predict = CompiledModel.predict
        monkeypatch.setattr(CompiledModel, "predict",
                            lambda self, x: fault(predict(self, x)))
    return run_cell(cell, 2**31 + 17, 0.5, False, device="cpu",
                    overrides=SMALL[cell], entry=ENTRY.get(cell))["result"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell, monkeypatch):
    r = _run(cell, monkeypatch)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    gap = r["checks"]["logprob_gap"]
    assert gap["value"] <= gap["limit"]


@pytest.mark.parametrize("cell,fault", [
    ("resnet50.offline", "half_batch"), ("resnet50.offline", "altered_answer"),
    ("vgg16.single_stream", "altered_answer"),
    ("resnet50.server", "half_batch"), ("resnet50.server", "altered_answer"),
])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    r = _run(cell, monkeypatch, FAULTS[fault])
    assert not r["correct"]
    gap = r["checks"]["logprob_gap"]
    assert gap["value"] > gap["limit"]
