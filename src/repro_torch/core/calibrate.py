"""Calibration for the planner's measured mode: one clock, and the relayout
bandwidth measured on it.

The global layout search prices a scheme mismatch between neighbouring
convs as layout-transform traffic.  When the schedule database holds
measured node costs, the edge costs must live on the same clock, or the
solver trades real transforms against imaginary ones.  ``timed_seconds`` is
that clock, for ``core.local_search.measured_runner`` and for the probe
here alike: on the card, the card's own time of back-to-back calls
(CUDA events around calls queued while the card was held busy, so the host's
enqueue is not in it); on the CPU, the host clock.  ``measure_host_copy_bw``
times the blocked relayout the executor runs for a ``layout_transform``
node (``core.layout.relayout``) on that clock, once per process and device
(``GlobalLayoutPlan`` auto-invokes it for measured or cached tuning over
measured entries; the ``InferenceSession`` keeps the figure in its saved
artifact, so a loaded session never probes again).
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from repro_torch.core.layout import nchwc, relayout

# The card's clock runs under 2 GHz: cycles of ``torch.cuda._sleep`` a ms
SLEEP_CYCLES_PER_MS = 2_000_000
MIN_HOLD_MS, MAX_HOLD_MS = 1.0, 50.0

_CACHED_BW: Dict[str, float] = {}
# Process-wide spy: how many probes ran (cache hits excluded).  A session
# loaded from an artifact must serve without one.
PROBE_COUNTERS = {"copy_bw": 0}


def probe_calls() -> int:
    """Calibration probes executed in this process (cache hits excluded)."""
    return sum(PROBE_COUNTERS.values())


def timed_seconds(fn: Callable[[], object], repeats: int, device) -> float:
    """Seconds per call of ``fn`` over ``repeats`` back-to-back calls, after
    two calls to warm up.  On a CUDA device, CUDA events around the calls,
    queued behind a sleep kernel sized to outlast the host's enqueue of
    them (twice the second warm-up's host time a call, at least
    ``MIN_HOLD_MS``, at most ``MAX_HOLD_MS``): the card's own time, with
    no host gap in it.
    Where the enqueue outlasts the hold anyway (a call of hundreds of
    kernels fills the launch queue, and the host then waits on the card),
    the events time the card while the host feeds it.  On the CPU, the
    host clock."""
    device = torch.device(device)
    fn()
    t0 = time.perf_counter()
    fn()
    warm_ms = (time.perf_counter() - t0) * 1e3
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        hold_ms = min(MAX_HOLD_MS, max(MIN_HOLD_MS, 2 * repeats * warm_ms))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(hold_ms * SLEEP_CYCLES_PER_MS))
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / repeats


def _device_key(device) -> str:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def measure_host_copy_bw(image: int = 56, channels: int = 128,
                         repeats: int = 15, force: bool = False,
                         device="cuda") -> float:
    """Measured bytes/s of one representative NCHW[x]c relayout (read +
    write, 16- to ``channels``-channel blocks of an ``image`` x ``image``
    map) on ``device``, on ``timed_seconds``'s clock.  Cached per process
    and device: the probe is reused by every later plan unless
    ``force``."""
    key = _device_key(device)
    if key in _CACHED_BW and not force:
        return _CACHED_BW[key]
    PROBE_COUNTERS["copy_bw"] += 1
    g = torch.Generator(device=key).manual_seed(0)
    x = torch.randn((1, channels // 16, image, image, 16), generator=g,
                    device=key)
    seconds = timed_seconds(lambda: relayout(x, nchwc(16), nchwc(channels)),
                            repeats, key)
    _CACHED_BW[key] = 2 * x.numel() * 4 / max(seconds, 1e-9)
    return _CACHED_BW[key]
