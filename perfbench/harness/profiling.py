"""The traced span of a ``--trace 1`` run, and what is read from it.

A ``torch.profiler`` trace loses the kernels of its first launches, more
the older the process (the program's chip records: up to ~70), and now
and then a few more.  So a span opens the profiler, launches 2,048 empty
kernels, and counts only from the moment they are queued: every kernel
launch on the host after that moment must have its kernel in the trace,
and the trace must hold at least as many of B1's kernels as B1's own
counter (``conv2d_nchwc.launches``) counted meanwhile.  A span that fails
this is taken again with 16,384 leads, twice at most (``retaken``); then
the run fails.

The profiler records the device's activity alone (no host operations:
their recording slows the host's walk, which several cells wait on).
The benchmark's own host spans (``h2d``, ``predict``, ``d2h``, ``submit``,
``wait``, ``collect``) are kept in memory on ``time.time_ns`` in every
thread; the launch of the last lead kernel ties that clock to the
trace's.  The device's busy time is the union of the intervals in which a
kernel, copy or memset ran.
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

LEADS = (2048, 16384, 16384)         # a span's takes, and their leads
B1_KERNEL = "conv_sm90_kernel"
LEAD_KERNEL = "spin_kernel"          # torch.cuda._sleep's
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160                     # a kernel's name in the breakdown


class HostSpans:
    """``(name, start_ns, end_ns)`` of the benchmark's own host work, from
    any thread, while ``on``."""

    def __init__(self) -> None:
        self.on = False
        self.spans: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.on:
            with self._lock:
                self.spans.append((name, t0, t1))


class TraceNotWhole(RuntimeError):
    """A span's trace misses the kernel of a launch made in it."""


class TracedSpan:
    """Opens the profiler; ``close`` ends the span and reads the trace."""

    def __init__(self, b1_counter, spans: HostSpans, lead: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._b1 = b1_counter
        self.spans = spans
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        for _ in range(lead - 1):
            torch.cuda._sleep(0)
        # the last lead launch ties the host's clock to the trace's
        self.cal = time.time_ns()
        torch.cuda._sleep(0)
        self.t0 = time.time_ns()
        self.b1_start = self._b1()
        spans.on = True

    def close(self) -> Dict:
        self.t1 = time.time_ns()
        b1_counted = self._b1() - self.b1_start
        self.spans.on = False
        torch.cuda.synchronize()
        self.prof.stop()
        return read_trace(self.prof, self.cal, self.t0, self.t1, b1_counted,
                          self.spans.spans)


def warm_profiler() -> None:
    """Start and stop the profiler once, so that a span later opens fast
    (the first start loads and sets up the device's tracing)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(0)
        torch.cuda.synchronize()


def _events(prof):
    """The trace's raw events as (activity, name, start_ns, end_ns,
    correlation, is_device) tuples."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        act = e.activity_type() if hasattr(e, "activity_type") else ""
        start = e.start_ns()
        out.append((act, e.name(), start, start + e.duration_ns(),
                    e.correlation_id(), dev))
    return out


def union_ns(intervals: List[Tuple[int, int]]) -> Tuple[int, List]:
    """Total length of the union of ``intervals``, and the gaps between
    its pieces as (start, end) pairs."""
    total, gaps, end = 0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total, gaps


def _quantiles(ns: List[int]) -> List[float]:
    """The 1st, 50th and 99th percentile of ``ns`` in ms (how long a
    kernel starts after its launch: the queue ahead of it)."""
    if not ns:
        return []
    ns = sorted(ns)
    return [ns[int(q * (len(ns) - 1))] / 1e6 for q in (0.01, 0.5, 0.99)]


class _Spans:
    """Host spans sorted by start, for ``at``."""

    def __init__(self, spans: List[Tuple[str, int, int]]) -> None:
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [s[1] for s in self.spans]

    def at(self, t: int) -> str:
        """The span around ``t`` begun last (of the 64 begun last before
        it: spans are short), or ``none``."""
        i = bisect.bisect_right(self.starts, t)
        for name, _a, b in reversed(self.spans[max(0, i - 64):i]):
            if t <= b:
                return name
        return "none"


def read_trace(prof, cal: int, t0: int, t1: int, b1_counted: int,
               spans: List[Tuple[str, int, int]]) -> Dict:
    """What a span's trace says: busy and window seconds, B1's kernels and
    time, the time of every device operation, and the idle gaps named by
    the host span they fell in; raises if the trace misses a launch."""
    events = _events(prof)
    device = [e for e in events if e[5] and (e[0] in DEVICE_ACTIVITIES
                                             or not e[0])]
    kernels = {e[4]: e for e in device}
    launches = sorted((e for e in events
                       if not e[5] and "LaunchKernel" in e[1]),
                      key=lambda e: e[2])
    leads = [e for e in launches if e[4] in kernels
             and LEAD_KERNEL in kernels[e[4]][1]]
    if not leads:
        raise RuntimeError("the trace holds no launch of its lead kernels")
    shift = leads[-1][2] - cal       # host time_ns -> the trace's clock
    lo, hi = t0 + shift, t1 + shift
    checked = [e for e in launches if lo <= e[2] <= hi]
    missed = [e for e in checked if e[4] not in kernels]
    b1_held = sum(1 for e in launches if lo - 1_000_000 <= e[2] <= hi
                  and e[4] in kernels and B1_KERNEL in kernels[e[4]][1])
    if missed or b1_held < b1_counted:
        at = [checked.index(e) for e in missed[:10]]
        raise TraceNotWhole(
            f"the trace is not whole: {len(missed)} of {len(checked)} "
            f"launches have no kernel (the first at {at}), {b1_held} B1 "
            f"kernels against {b1_counted} B1 launches counted")
    clipped = []
    by_name: Dict[str, float] = {}
    b1_ns = 0
    for act, name, a, b, _c, _d in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if LEAD_KERNEL in name:
            continue
        clipped.append((a, b))
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        if B1_KERNEL in name:
            b1_ns += b - a
    busy_ns, gaps = union_ns(clipped)
    if clipped:
        first = min(a for a, _ in clipped)
        last = max(b for _, b in clipped)
        gaps = [(lo, first)] + gaps + [(last, hi)]
    host = _Spans([(n, a + shift, b + shift) for n, a, b in spans])
    named: Dict[str, float] = {}
    for a, b in gaps:
        if b > a:
            key = host.at((a + b) // 2)
            named[key] = named.get(key, 0.0) + (b - a) / 1e9
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy_ns / 1e9,
        "b1_s": b1_ns / 1e9,
        "b1_kernels": b1_held,
        "b1_counted": b1_counted,
        "launches_checked": len(checked),
        "kernel_after_launch_ms": _quantiles(
            [kernels[e[4]][2] - e[2] for e in checked if e[4] in kernels]),
        "idle_by_span_s": named,
        "device_s_by_name": by_name,
        "device_ops": [[name[:NAME_CHARS], sec] for name, sec in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[host.at((a + b) // 2), (b - a) / 1e9]
                      for a, b in longest if b > a],
    }


def b1_launches() -> int:
    """B1's own launch counter."""
    from repro_torch.kernels.conv2d_nchwc import conv2d_nchwc

    return conv2d_nchwc.launches


def maybe_trace(lead: int, spans: HostSpans) -> Optional[TracedSpan]:
    """A span led by ``lead`` empty kernels, or None for 0."""
    return TracedSpan(b1_launches, spans, lead) if lead else None


def retaken(take):
    """``take(lead)`` for each lead of ``LEADS`` until one returns a whole
    trace; raises the last ``TraceNotWhole`` where none does."""
    for lead in LEADS:
        try:
            return take(lead)
        except TraceNotWhole as e:
            last = e
    raise last
