"""Process- and thread-level runtime settings for the launch scripts — the
port of the reference's ``repro/launch/cpu.py``.

* :func:`worker_cpu_sets` — partition the allowed CPUs round-robin into
  per-worker affinity sets for ``AsyncServer(workers=n, pin="auto")``;
* :func:`maybe_pin` — pin the calling *thread* to a CPU set
  (``sched_setaffinity``, the ``taskset`` syscall; on Linux pid 0 means
  the calling thread, so serving workers pin independently);
* :func:`apply_serving_env` — allocator hygiene for serving processes:
  tcmalloc ``LD_PRELOAD`` detection (recommended for the many short-lived
  host buffers a serving loop allocates) and large-alloc report
  suppression.  Warn-don't-fail when tcmalloc is not installed.  The
  reference's preset also sets ``TF_CPP_MIN_LOG_LEVEL``, which silences
  TF/XLA's C++ logs; this process runs neither, so the key is left out;
* :func:`check_devices` — the port's counterpart of ``--devices``: the
  count is checked against the visible cards (``cuda:0`` to
  ``cuda:n-1``), and on the CPU it is the number of shards that a
  batch-sharded session runs in turn.

The reference's XLA-flag helpers make XLA show host cores as devices
before the backend starts.  None has a caller in the port, so none is
ported; what stands in for each:

* ``DEVICE_COUNT_FLAG`` (``--xla_force_host_platform_device_count``): a
  torch process sees its cards from ``CUDA_VISIBLE_DEVICES`` when CUDA
  starts, and there is no flag that makes host cores into devices;
* ``merge_xla_flag`` / ``parse_xla_flag`` (edit and read that flag in
  ``XLA_FLAGS``): ``CUDA_VISIBLE_DEVICES`` is set by whoever starts the
  process, and ``torch.cuda.device_count()`` reads it;
* ``configure_cpu_devices(n)`` (set the flag before JAX starts): on the
  CPU a session's ``devices`` alone sets its number of shards, which run
  in turn, so nothing needs configuring before torch starts;
* ``configured_device_count()``: ``torch.cuda.device_count()`` on the
  card, and the session's ``devices`` on the CPU.

On the card's host a worker thread walks the graph and launches the
kernels, so keeping it on its own cores keeps the scheduler from migrating
it mid-batch.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, MutableMapping, Optional, Sequence, Tuple

__all__ = ["SERVING_ENV_PRESET", "TCMALLOC_CANDIDATES", "apply_serving_env",
           "check_devices", "find_tcmalloc", "maybe_pin", "tcmalloc_active",
           "worker_cpu_sets"]

# env defaults applied (setdefault, never overriding the user) by
# apply_serving_env
SERVING_ENV_PRESET: Dict[str, str] = {
    # tcmalloc reports every allocation over ~1GB by default; padded
    # batches of large buckets trip it constantly
    "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
}

TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
)


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

def check_devices(n: int, device="cuda") -> int:
    """Check that ``n`` devices of ``device``'s type can serve this process
    and return ``n``.  ``n < 1`` raises ``ValueError``; on ``"cuda"``,
    fewer visible cards than ``n`` raises ``RuntimeError`` naming both
    counts and ``CUDA_VISIBLE_DEVICES`` (there is no fallback to the CPU);
    on ``"cpu"`` any ``n`` serves (``engine.executor.shard_devices``)."""
    from repro_torch.engine.executor import shard_devices

    shard_devices(n, device)
    return int(n)


# ---------------------------------------------------------------------------
# CPU pinning (threads)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Allocator / env hygiene for serving processes
# ---------------------------------------------------------------------------

def find_tcmalloc() -> Optional[str]:
    """Path to an installed tcmalloc shared library, or None."""
    for p in TCMALLOC_CANDIDATES:
        if os.path.exists(p):
            return p
    try:
        import ctypes.util
        return ctypes.util.find_library("tcmalloc") \
            or ctypes.util.find_library("tcmalloc_minimal")
    except (ImportError, OSError):      # detection is best-effort
        return None


def tcmalloc_active() -> bool:
    """Is tcmalloc already loaded into this process (LD_PRELOAD took
    effect before we started)?"""
    try:
        with open("/proc/self/maps") as f:
            return "tcmalloc" in f.read()
    except OSError:
        return "tcmalloc" in os.environ.get("LD_PRELOAD", "")


def apply_serving_env(env: MutableMapping[str, str] = os.environ, *,
                      quiet: bool = False) -> Dict[str, str]:
    """Apply the recommended serving-process environment (warn-don't-fail).

    * ``SERVING_ENV_PRESET`` keys are set only where unset (never
      overrides the user);
    * tcmalloc: if already active, nothing to do; if installed but not
      preloaded, ``LD_PRELOAD`` is exported so *child* processes get it
      and a warning explains the current process keeps the default
      allocator (LD_PRELOAD cannot be applied retroactively); if absent,
      a warning recommends installing it.

    Returns the settings this call added to ``env``.
    """
    applied: Dict[str, str] = {}
    for k, v in SERVING_ENV_PRESET.items():
        if k not in env:
            env[k] = v
            applied[k] = v
    if not tcmalloc_active():
        lib = find_tcmalloc()
        if lib is None:
            if not quiet:
                warnings.warn(
                    "tcmalloc not found: serving keeps the default "
                    "allocator (install libtcmalloc and LD_PRELOAD it "
                    "for faster malloc under concurrent workers)",
                    RuntimeWarning, stacklevel=2)
        else:
            preload = env.get("LD_PRELOAD", "")
            if lib not in preload.split(os.pathsep if ":" in preload
                                        else " ") and lib not in preload:
                env["LD_PRELOAD"] = f"{preload}:{lib}".lstrip(":")
                applied["LD_PRELOAD"] = env["LD_PRELOAD"]
            if not quiet:
                warnings.warn(
                    f"tcmalloc found at {lib} but not preloaded; exported "
                    "LD_PRELOAD for child processes — relaunch under it "
                    "(LD_PRELOAD=" + lib + " python -m "
                    "repro_torch.launch.serve ...) to use it in this "
                    "process", RuntimeWarning, stacklevel=2)
    return applied
