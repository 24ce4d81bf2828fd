"""Host CPU placement for serving workers: the two pinning functions of the
reference's ``repro/launch/cpu.py``.

* :func:`worker_cpu_sets` — partition the allowed CPUs round-robin into
  per-worker affinity sets for ``AsyncServer(workers=n, pin="auto")``;
* :func:`maybe_pin` — pin the calling *thread* to a CPU set
  (``sched_setaffinity``, the ``taskset`` syscall; on Linux pid 0 means
  the calling thread, so serving workers pin independently).

On the card's host a worker thread walks the graph and launches the
kernels, so keeping it on its own cores keeps the scheduler from migrating
it mid-batch.  The rest of the reference's module (host-device setup,
allocator hygiene) belongs to the launch scripts (ROADMAP A9).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

__all__ = ["maybe_pin", "worker_cpu_sets"]


def maybe_pin(cpus: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """Pin the calling thread to ``cpus``.  Silently a no-op where the
    platform lacks ``sched_setaffinity`` or the container forbids it.
    Returns the pinned set, or None."""
    if not hasattr(os, "sched_setaffinity"):
        return None
    try:
        os.sched_setaffinity(0, set(cpus))
    except (OSError, ValueError):
        return None
    return tuple(sorted(cpus))


def worker_cpu_sets(n_workers: int,
                    cpus: Optional[Sequence[int]] = None
                    ) -> List[Tuple[int, ...]]:
    """Partition the allowed CPUs into ``n_workers`` disjoint affinity
    sets, round-robin so every worker gets a share even when the counts
    do not divide.  With fewer cores than workers, sets repeat (two
    workers may share a core)."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if cpus is None:
        if hasattr(os, "sched_getaffinity"):
            cpus = sorted(os.sched_getaffinity(0))
        else:
            cpus = list(range(os.cpu_count() or 1))
    cpus = list(cpus)
    if len(cpus) >= n_workers:
        return [tuple(cpus[i::n_workers]) for i in range(n_workers)]
    return [(cpus[i % len(cpus)],) for i in range(n_workers)]
