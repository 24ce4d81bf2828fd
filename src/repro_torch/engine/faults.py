"""Deterministic fault injection for the serving stack — a copy of the
reference's ``repro/engine/faults.py``.

Failure paths are only production-grade when they are as exercisable as
the hot path.  A :class:`FaultInjector` is armed with scripted faults —
kill worker ``k`` on batch ``n``, raise from ``predict``, delay a batch
(straggler) — and handed to ``AsyncServer(faults=...)``; the server fires
it at the top of every batch execution, so tests and the chaos step of
``chip_smoke.py``'s serving phase reproduce the exact crash/straggler/
retry interleavings they gate on.  Batches are numbered by a global
formation sequence (0-based, assigned under the server lock), so "batch
n" is well-defined even under multi-worker execution.

Artifact corruption is the other injectable failure class:
:func:`corrupt_file` / :func:`corrupt_artifact` flip bytes in a saved
``InferenceSession`` artifact (the version-5 layout both packages write)
so the checksum-verification path (``ArtifactCorruptError``) is
reproducibly exercisable too.

Fault matching: each fault may pin a worker (``worker=None`` matches
any), a batch sequence number (``on_batch=None`` matches every batch),
and a firing budget (``times=None`` fires forever).  ``injector.fired``
records every firing for assertions.
"""
from __future__ import annotations

import dataclasses
import threading
from pathlib import Path
from typing import Callable, List, Optional, Tuple, Union


class InjectedFault(RuntimeError):
    """Base class for exceptions raised by armed faults."""


class InjectedWorkerCrash(InjectedFault):
    """Simulates the worker thread dying mid-batch: the server requeues
    the batch and lets the thread exit (the supervisor restarts it)."""


class InjectedPredictError(InjectedFault):
    """Simulates ``predict`` raising: the batch fails, its requests are
    retried within their budget."""


@dataclasses.dataclass
class Fault:
    """Base scripted fault: fires when (worker, batch-seq) match, at most
    ``times`` times (None = forever)."""

    on_batch: Optional[int] = None    # global batch sequence, None = every
    worker: Optional[int] = None      # None = any worker
    times: Optional[int] = 1          # firing budget, None = unlimited

    def matches(self, worker: int, seq: int) -> bool:
        if self.times is not None and self.times <= 0:
            return False
        if self.on_batch is not None and seq != self.on_batch:
            return False
        if self.worker is not None and worker != self.worker:
            return False
        return True


@dataclasses.dataclass
class KillWorker(Fault):
    """Kill the executing worker thread on the matched batch."""


@dataclasses.dataclass
class FailBatch(Fault):
    """Raise from the matched batch's predict call."""

    message: str = "injected predict failure"


@dataclasses.dataclass
class DelayBatch(Fault):
    """Stall the matched batch (straggler / hung-batch probe)."""

    delay_ms: float = 50.0


class FaultInjector:
    """Thread-safe scripted-fault registry the server fires per batch.

    ``fire(worker, seq, sleep)`` applies every armed fault matching the
    (worker, batch-sequence) pair: delays sleep first, then a predict
    failure or worker kill raises.  Each firing decrements the fault's
    budget and is appended to ``fired`` as ``(kind, worker, seq)``."""

    def __init__(self, *faults: Fault) -> None:
        self._faults: List[Fault] = list(faults)
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int, int]] = []

    def arm(self, *faults: Fault) -> "FaultInjector":
        with self._lock:
            self._faults.extend(faults)
        return self

    def _take_matching(self, worker: int, seq: int) -> List[Fault]:
        with self._lock:
            hits = []
            for f in self._faults:
                if f.matches(worker, seq):
                    if f.times is not None:
                        f.times -= 1
                    self.fired.append((type(f).__name__, worker, seq))
                    hits.append(f)
            return hits

    def fire(self, worker: int, seq: int,
             sleep: Callable[[float], None]) -> None:
        """Apply matching faults for this batch: delays stall first, then
        the strongest raise wins — a worker kill dominates a predict
        failure when both match the same batch."""
        hits = self._take_matching(worker, seq)
        for f in hits:
            if isinstance(f, DelayBatch):
                sleep(f.delay_ms / 1e3)
        for f in hits:
            if isinstance(f, KillWorker):
                raise InjectedWorkerCrash(
                    f"injected worker kill (worker {worker}, batch {seq})")
        for f in hits:
            if isinstance(f, FailBatch):
                raise InjectedPredictError(
                    f"{f.message} (worker {worker}, batch {seq})")

    def fired_kinds(self) -> List[str]:
        return [k for k, _, _ in self.fired]


# ---------------------------------------------------------------------------
# Artifact corruption
# ---------------------------------------------------------------------------

def corrupt_file(path: Union[str, Path], *, offset: Optional[int] = None,
                 nbytes: int = 1) -> Path:
    """Flip ``nbytes`` bytes of a file in place (XOR 0xFF — guaranteed to
    change the content, unlike writing a random byte).  ``offset=None``
    targets the middle of the file, past any magic/header bytes."""
    p = Path(path)
    data = bytearray(p.read_bytes())
    if not data:
        raise ValueError(f"cannot corrupt empty file {p}")
    off = len(data) // 2 if offset is None else offset
    for i in range(nbytes):
        data[(off + i) % len(data)] ^= 0xFF
    p.write_bytes(bytes(data))
    return p


def corrupt_artifact(artifact_dir: Union[str, Path],
                     kind: str = "weights") -> Path:
    """Corrupt one file of a saved InferenceSession artifact; returns the
    corrupted path.  ``kind``: "weights" (a bound-weight npy blob),
    "plan" (a per-batch plan JSON), or "manifest" (the manifest itself).
    Loading the artifact afterwards must raise ``ArtifactCorruptError``
    (weights/plan, via checksum verification) or a clean typed error
    (manifest)."""
    patterns = {"weights": "weights/step_*/leaf_*.npy",
                "plan": "plans/*.json",
                "manifest": "manifest.json"}
    if kind not in patterns:
        raise ValueError(f"unknown corruption target {kind!r}; "
                         f"pick one of {sorted(patterns)}")
    files = sorted(Path(artifact_dir).glob(patterns[kind]))
    if not files:
        raise FileNotFoundError(
            f"no {kind} files ({patterns[kind]}) under {artifact_dir}")
    return corrupt_file(files[0])
