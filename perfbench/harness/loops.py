"""The three ways a traffic mix drives the program (its ``"loop"``).

``offline``  ``InferenceSession.predict`` on batches from a pool held in
             pinned host memory, each copied to the device in the timed
             path, at most ``in_flight`` batches queued; an image counts
             once its output is in host memory.  The window ends when the
             last batch issued is back: images over all of that time.
``closed``   one client: copy one input up, ``predict``, read the output
             back, then the next; each predict timed from its input on
             the host to its output on the host.
``open``     ``AsyncServer.submit`` of requests at the mix's due times
             from one generator thread; a collector thread reads each
             response back to host memory in order.  A request is timed
             from its due time to its response on the host, so a stall
             counts for every request queued behind it; one that fails or
             never comes is infinitely late.

Each returns a ``Window``: the end-to-end numbers, every output due in the
window (host tensors, with the pool index of their input) for the check,
and what the per-layer readers take.  With ``lead`` the profiler is open
over the loop (``profiling.TracedSpan``, led by that many empty kernels),
from its start to its end with nothing in flight at either.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import math
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.harness.profiling import HostSpans, maybe_trace, retaken

LATE_WAIT_S = 60.0


@dataclasses.dataclass
class Window:
    seconds: float
    attempted: int
    failed: int
    images: int
    e2e: Dict[str, float]
    outputs: List[Tuple[int, torch.Tensor]]      # (pool index, rows)
    enqueue_ms: List[float] = dataclasses.field(default_factory=list)
    batches: Dict[int, int] = dataclasses.field(default_factory=dict)
    serving: Optional[Dict[str, int]] = None
    trace: Optional[dict] = None
    notes: Dict[str, float] = dataclasses.field(default_factory=dict)


class Outputs:
    """Every output of a window, kept in a few large host tensors: a
    window that kept one tensor an output would leave the interpreter's
    garbage collector tens of thousands of objects to walk, and its pauses
    (~200 ms at 15,000 outputs) would land inside the window."""

    ENTRIES = 4096

    def __init__(self) -> None:
        self.chunks: List[torch.Tensor] = []
        self.keys: List[int] = []

    def add(self, k: int, y: torch.Tensor) -> None:
        """Copy ``y`` (the rows of one input of the pool, ``k``) into host
        memory; from a device, synchronously."""
        slot = len(self.keys) % self.ENTRIES
        if slot == 0:
            self.chunks.append(torch.empty((self.ENTRIES,) + tuple(y.shape),
                                           dtype=y.dtype))
        self.chunks[-1][slot].copy_(y)
        self.keys.append(k)

    def items(self) -> List[Tuple[int, torch.Tensor]]:
        return [(k, self.chunks[i // self.ENTRIES][i % self.ENTRIES])
                for i, k in enumerate(self.keys)]

    def __len__(self) -> int:
        return len(self.keys)


class GcWatch:
    """The interpreter's garbage collections while the block runs: how
    many of each generation, and the longest and total pause."""

    def __enter__(self) -> "GcWatch":
        self.count = [0, 0, 0]
        self.pauses: List[float] = []
        self._t = 0.0
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count[info["generation"]] += 1
            self.pauses.append(time.perf_counter() - self._t)

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)

    def notes(self) -> Dict[str, float]:
        return {"gc_collections": self.count,
                "gc_max_ms": max(self.pauses, default=0.0) * 1e3,
                "gc_total_ms": sum(self.pauses) * 1e3}


def _ns() -> int:
    return time.time_ns()


def p95(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def offline(session, pool: List[torch.Tensor], seconds: float, device,
            in_flight: int, spans: HostSpans, lead: int = 0) -> Window:
    batch = int(pool[0].shape[0])
    inflight = collections.deque()
    free: List[torch.Tensor] = []
    outputs = Outputs()
    enqueue: List[float] = []
    pinned = device.type == "cuda"

    def complete() -> None:
        ev, buf, k = inflight.popleft()
        t = _ns()
        if ev is not None:
            ev.synchronize()
        spans.add("wait", t, _ns())
        outputs.add(k, buf)
        free.append(buf)

    span = maybe_trace(lead, spans)
    gcw = GcWatch().__enter__()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        if len(inflight) >= in_flight:
            complete()
        k = i % len(pool)
        a = _ns()
        x = pool[k].to(device, non_blocking=True)
        b = _ns()
        y = session.predict(x)
        c = _ns()
        if not free:
            free.append(torch.empty(tuple(y.shape), dtype=y.dtype,
                                    pin_memory=pinned))
        buf = free.pop()
        buf.copy_(y, non_blocking=pinned)
        ev = None
        if pinned:
            ev = torch.cuda.Event()
            ev.record()
        spans.add("h2d", a, b)
        spans.add("predict", b, c)
        spans.add("d2h", c, _ns())
        enqueue.append((c - b) / 1e6)
        inflight.append((ev, buf, k))
        i += 1
    while inflight:
        complete()
    elapsed = time.perf_counter() - t0
    gcw.__exit__()
    traced = span.close() if span else None
    images = i * batch
    return Window(seconds=elapsed, attempted=images, failed=0, images=images,
                  e2e={"images_per_s": images / elapsed},
                  outputs=outputs.items(),
                  enqueue_ms=enqueue, batches={batch: i}, trace=traced,
                  notes=gcw.notes())


def closed(session, pool: List[torch.Tensor], seconds: float, device,
           spans: HostSpans, lead: int = 0) -> Window:
    batch = int(pool[0].shape[0])
    outputs = Outputs()
    enqueue: List[float] = []
    lat: List[float] = []
    span = maybe_trace(lead, spans)
    gcw = GcWatch().__enter__()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        k = i % len(pool)
        a = _ns()
        x = pool[k].to(device, non_blocking=True)
        b = _ns()
        y = session.predict(x)
        c = _ns()
        outputs.add(k, y)
        d = _ns()
        spans.add("h2d", a, b)
        spans.add("predict", b, c)
        spans.add("d2h", c, d)
        enqueue.append((c - b) / 1e6)
        lat.append((d - a) / 1e6)
        i += 1
    elapsed = time.perf_counter() - t0
    gcw.__exit__()
    traced = span.close() if span else None
    return Window(seconds=elapsed, attempted=i * batch, failed=0,
                  images=i * batch,
                  e2e={"predict_ms": elapsed * 1e3 / i,
                       "predict_p95_ms": p95(lat)},
                  outputs=outputs.items(), enqueue_ms=enqueue,
                  batches={batch: i}, trace=traced, notes=gcw.notes())


def _serving_counts(server) -> Dict[str, int]:
    s = server.stats
    return {"n_batches": s.n_batches, "rows_executed": s.rows_executed,
            "rows_padded": s.rows_padded, "n_failed": s.n_failed,
            "batch_hist": dict(s.batch_hist.counts())}


def _delta(a: Dict, b: Dict, buckets: List[int]) -> Dict:
    out = {k: b[k] - a[k] for k in ("n_batches", "rows_executed",
                                     "rows_padded", "n_failed")}
    by_bucket: Dict[int, int] = {}
    for rows, n in b["batch_hist"].items():
        n -= a["batch_hist"].get(rows, 0)
        if n:
            bucket = min(x for x in buckets if x >= int(rows))
            by_bucket[bucket] = by_bucket.get(bucket, 0) + n
    out["batches"] = by_bucket
    return out


def open_loop(server, pool: List[torch.Tensor], due: List[float],
              seconds: float, buckets: List[int], spans: HostSpans,
              trace_s: float = 0.0) -> Window:
    """Serves the requests of ``due`` (seconds from the start); those due
    before ``seconds`` are the window's.  With ``trace_s`` a span of
    ``trace_s`` opens at ``seconds`` while the traffic goes on (``due`` has
    to reach past it, and past its takes); then the generator stops."""
    n = len(due)
    window = [k for k, d in enumerate(due) if d < seconds]
    futures: "queue.Queue" = queue.Queue()
    done = [math.inf] * n
    outputs = Outputs()
    late: List[float] = []
    stop = threading.Event()
    t0 = time.perf_counter() + 0.05

    def generate() -> None:
        for k, d in enumerate(due):
            if d >= seconds and stop.is_set():
                break
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            a = _ns()
            try:
                fut = server.submit(pool[k % len(pool)])
            except Exception as e:          # noqa: BLE001 — counted failed
                fut = e
            spans.add("submit", a, _ns())
            late.append((time.perf_counter() - t0 - d) * 1e3)
            futures.put((k, fut))
        futures.put((None, None))

    def collect() -> None:
        while True:
            k, fut = futures.get()
            if k is None:
                return
            if isinstance(fut, Exception):
                continue
            a = _ns()
            try:
                y = fut.result(timeout=max(
                    1e-3, t0 + seconds + trace_s + LATE_WAIT_S
                    - time.perf_counter()))
            except Exception:               # noqa: BLE001 — counted failed
                continue
            b = _ns()
            if k < len(window):
                outputs.add(k % len(pool), y)
            else:
                y.to("cpu")
            done[k] = time.perf_counter() - t0
            spans.add("wait", a, b)
            spans.add("collect", b, _ns())

    gen = threading.Thread(target=generate, name="perfbench-generator")
    col = threading.Thread(target=collect, name="perfbench-collector")
    before = _serving_counts(server)
    with GcWatch() as gcw:
        gen.start()
        col.start()
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        at_close = _serving_counts(server)
    traced = None
    if trace_s:
        def take(lead):
            span = maybe_trace(lead, spans)
            span_before = _serving_counts(server)
            time.sleep(trace_s)
            span_after = _serving_counts(server)
            got = span.close()
            got["batches"] = _delta(span_before, span_after,
                                    buckets)["batches"]
            return got

        traced = retaken(take)
    stop.set()
    gen.join()
    col.join()
    lat = [(done[k] - due[k]) * 1e3 for k in window]
    failed = len(window) - len(outputs)
    counts = _delta(before, at_close, buckets)
    q = max(1, len(window) // 4)
    return Window(
        seconds=seconds, attempted=len(window), failed=failed,
        images=len(window) - failed,
        e2e={"latency_p95_ms": p95(lat)},
        outputs=outputs.items(),
        batches=counts.pop("batches"), serving=counts, trace=traced,
        notes={"latency_p50_ms": float(np.percentile(lat, 50)),
               "latency_first_quarter_ms": float(np.mean(lat[:q])),
               "latency_last_quarter_ms": float(np.mean(lat[-q:])),
               "backlog_at_close": sum(1 for k in window
                                       if done[k] > seconds),
               "generator_late_p50_ms": float(np.percentile(late, 50)),
               "generator_late_p99_ms": float(np.percentile(late, 99)),
               "generator_late_max_ms": float(max(late)), **gcw.notes()})
