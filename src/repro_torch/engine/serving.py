"""Async batched serving over ``InferenceSession`` and ``LMSession`` — the
port of the reference's ``repro/engine/serving.py``.

An :class:`AsyncServer` wraps a (usually artifact-loaded) session with a
bounded request queue, a batching policy, and worker threads that pack
pending requests into the *nearest already-specialized batch size* — the
per-batch specializations are the units a serving loop schedules around.

Determinism is the load-bearing design decision.  Results are **not**
invariant across batch sizes: on the card B1's launch plan (split K,
cluster size) follows M = N·H·W, so each bucket runs its own plan, and the
CPU's GEMMs block differently for M = 1 and M = 8.  Within one bucket a
row's result depends on neither its position nor its neighbours.  Serving
therefore executes every request — packed or alone — through the same
bucket-shaped programs: ``padded_predict`` pads a request up to the
nearest specialized batch size and slices the real rows back out.  Packed
results are bit-identical to one-request-at-a-time serving of the same
session, no matter how the traffic interleaved; the throughput win is
that one bucket execution serves many requests instead of one.

Batching policy (``DynamicBatchPolicy``):

* a batch is flushed when pending rows reach ``max_batch``, when the
  oldest request has waited ``max_wait_ms``, or immediately during drain;
* by default requests are packed strictly FIFO; ``order="edf"`` switches
  the *packing order* to earliest-deadline-first with priority-class
  tie-breaks (``engine/traffic.py``) — flush timing and numerics are
  unchanged, because every request still runs through the same bucket
  programs;
* the executed bucket is the *smallest* specialized batch size that fits
  the packed rows (or ``fixed_bucket``), so the padded waste of a batch of
  ``n`` rows is exactly ``nearest_bucket(n) - n``.  When the session is not
  frozen, an unseen size is specialized on demand (behind the session's
  lock, so the planner never runs concurrently).

Backpressure and lifecycle: ``submit`` raises :class:`QueueFullError`
beyond ``max_queue``, a per-request ``deadline_ms`` expires queued work
with :class:`DeadlineExceededError` instead of executing it late, and
``close(drain=True)`` completes everything in flight while rejecting new
submissions with :class:`ServerClosedError`.

    sess = InferenceSession.load("artifact/")        # buckets {1, 8}
    with AsyncServer(sess, DynamicBatchPolicy(max_batch=8,
                                              max_wait_ms=2.0)) as srv:
        futs = [srv.submit(x) for x in stream]       # concurrent callers
        outs = [f.result() for f in futs]            # == padded_predict(x)

Inputs may be numpy arrays, CPU tensors or tensors on the session's
device; the worker moves them there.  An input on a CUDA device is read
on the worker's stream only after the work its submitting stream had
queued at ``submit`` (an event recorded there).  Responses are tensors on
the session's device, ready when their future resolves.

Workers and streams (``workers=N``): N worker threads share the one
bounded queue; batches *form* under the server lock, but up to N of them
*execute* concurrently.  On a CUDA session each worker slot owns a
``torch.cuda.Stream`` and runs its batches under it: every kernel of the
port launches on the current stream, so one worker's batch may run on the
card while another walks the graph.  The walks themselves contend for
the GIL (each kernel launch and torch op hands it over), so on one card
two workers have served slower than one (PERF.md §6).  A batch resolves
after ``synchronize()`` of its own stream only.  A request's
result depends only on its bucket's program, never on which worker (or
stream) ran it.  Where the session's device type has more than one device
(``torch.cuda.device_count() > 1``), worker ``i`` executes through a
replica on device ``i % D`` (``CompiledModel.replica``).  ``pin="auto"``
additionally pins each worker thread to its own CPU set
(``launch/cpu.py``: ``worker_cpu_sets`` / ``maybe_pin``).  No
``CUBLAS_WORKSPACE_CONFIG`` is needed for that: PyTorch gives each
stream's cuBLAS handle a workspace of its own, and on an H100 the served
results at two workers, the ``dense`` head on cuBLAS included, came out
bit-identical to ``padded_predict`` without the variable
(``chip_smoke.py``'s serving phase gates it).

Fault tolerance (the deterministic :class:`~engine.faults.FaultInjector`
exercises each path):

* **Crash recovery** — a batch that raises (a kernel error included, or
  a worker thread that dies mid-batch) strands nothing: its requests are
  *requeued at the queue head* with a per-request retry budget and capped
  exponential backoff (:class:`~engine.supervision.RetryPolicy`); past
  the budget the future fails with :class:`RetriesExhaustedError`
  carrying the original cause.  A retry runs the same bucket program on
  the same device — never a plain version, never the CPU — so a
  completed-after-retry response is bit-identical to the never-failed
  one.
* **Worker supervision** — a supervisor thread restarts crashed worker
  threads (up to ``max_restarts`` per slot), requeues whatever they left
  in flight, and past the restart budget marks the slot *unhealthy*,
  degrading to the surviving workers; when no worker survives, pending
  work fails typed (:class:`AllWorkersUnhealthyError`).
* **Hung-batch watchdog** (``watchdog_ms``) — workers heartbeat at batch
  boundaries (:class:`~engine.supervision.HeartbeatMonitor`); a worker
  silent past the watchdog *while holding an in-flight batch* is treated
  as hung: its batch is requeued (double execution is safe — the first
  result to land wins) and its slot restarted.  Idle silence is revived,
  never killed.  Set the watchdog well above a worst-case batch,
  including the first launch of a kernel (which builds it with ``nvcc``),
  or warm every bucket first.
* **Load shedding** (``shed="newest"|"oldest"|"deadline"``) — the
  overload policy when the bounded queue is full: reject the newcomer
  (default, :class:`QueueFullError`), shed the oldest queued request, or
  shed the queued request closest to missing its deadline; shed requests
  fail with :class:`LoadShedError`.
* **health()** — a point-in-time snapshot (queue depth, workers alive/
  unhealthy/restarted, retry/shed/crash counters); the same counters ride
  in ``ServingStats.to_json``.

Streams of tokens: ``submit_stream`` queues one greedy generation of an
``LMSession``; a :class:`TokenStream` yields each decode step's tokens as
the worker produces them (``LMSession.generate``'s ``on_token`` hook).  A
generation executes alone.

Tests drive the scheduling deterministically: construct with
``autostart=False`` and a fake ``clock``, then pump :meth:`AsyncServer.step`
(and :meth:`AsyncServer.supervise`) by hand.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.engine.faults import FaultInjector, InjectedWorkerCrash
from repro_torch.engine.supervision import (HeartbeatMonitor, RetryPolicy,
                                            SHED_POLICIES,
                                            StragglerMitigator,
                                            StragglerPolicy,
                                            choose_shed_victim)
from repro_torch.engine.telemetry import SizeHistogram, StreamingQuantiles
from repro_torch.engine.traffic import DEFAULT_PRIORITY, priority_rank


# ---------------------------------------------------------------------------
# Typed serving errors
# ---------------------------------------------------------------------------

class ServingError(RuntimeError):
    """Base class for the server's failures."""


class QueueFullError(ServingError):
    """Backpressure: the bounded request queue is at capacity."""


class RequestTooLargeError(ServingError, ValueError):
    """The request's row count exceeds the packable maximum (the policy's
    ``max_batch``, clamped to the pinned bucket and — for frozen
    sessions — the largest specialized bucket).  Rejected at ``submit``,
    never queued: the server could only under-allocate it or fail it
    late.  Split the request, raise ``max_batch``, or re-save the
    artifact with a larger bucket.  Subclasses ``ValueError`` for
    backward compatibility with pre-typed callers."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed while it was still queued."""


class ServerClosedError(ServingError):
    """submit() after close()/drain started."""


class RetriesExhaustedError(ServingError):
    """The request failed on every execution attempt within its retry
    budget; ``__cause__`` is the last underlying failure."""


class LoadShedError(ServingError):
    """The request was evicted from the queue by the overload policy."""


class WorkerCrashError(ServingError):
    """A worker thread died mid-batch (its requests were requeued)."""


class AllWorkersUnhealthyError(ServingError):
    """Every worker slot exhausted its restart budget; the server cannot
    execute anything."""


# ---------------------------------------------------------------------------
# Bucketed (deterministic) execution helpers
# ---------------------------------------------------------------------------

def nearest_bucket(n: int, sizes: Sequence[int]) -> Optional[int]:
    """Smallest specialized batch size >= n, or None if none fits."""
    up = [s for s in sizes if s >= n]
    return min(up) if up else None


def as_tensor(x) -> torch.Tensor:
    """A request's rows as a tensor: a tensor as it is (on its device), any
    other array (numpy, or one numpy can read) as a CPU tensor, float64 as
    float32 (the reference's ``jnp.asarray`` does the same)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.as_tensor(a.astype(np.float32) if a.dtype == np.float64
                           else a)


def pad_rows(x: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad the leading (batch) dim up to ``bucket`` rows, on ``x``'s
    device."""
    n = x.shape[0]
    if n == bucket:
        return x
    pad = torch.zeros((bucket - n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad])


def _slice_rows(y, a: int, b: int):
    if isinstance(y, tuple):
        return tuple(t[a:b] for t in y)
    return y[a:b]


def _on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing for a CPU worker."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def _quiesce(stream) -> None:
    """Let a failed batch's queued work on ``stream`` finish before its
    requests are requeued or failed, so nothing still reads their inputs;
    a sticky device error raises here again and is left to the caller's
    typed failure."""
    if stream is not None:
        try:
            stream.synchronize()
        except Exception:           # noqa: BLE001 — already failing
            pass


def _on_device(x: torch.Tensor, session) -> torch.Tensor:
    device = getattr(session, "device", None)
    return x if device is None else x.to(device)


def padded_predict(session, x, bucket: Optional[int] = None):
    """One request through the serving execution path: move it to the
    session's device, pad to the nearest specialized bucket (or an
    explicit ``bucket``), execute that fixed-shape program, slice the real
    rows back.  This is the *sequential baseline* the server's packed
    results are bit-identical to (results depend only on the bucket
    programs, never on which other requests shared the batch)."""
    x = _on_device(as_tensor(x), session)
    n = int(x.shape[0])
    if bucket is None:
        bucket = nearest_bucket(n, session.batch_sizes)
    elif bucket < n:
        raise ValueError(f"bucket {bucket} smaller than the request ({n})")
    if bucket is None:
        if session.frozen:
            raise ServingError(
                f"request of {n} rows exceeds every specialized batch size "
                f"{session.batch_sizes} of a frozen session; re-save the "
                "artifact with a larger bucket or with its source packed")
        bucket = n                       # specialize on demand (locked)
    y = session.specialize(bucket).predict(pad_rows(x, bucket))
    return _slice_rows(y, 0, n)


# ---------------------------------------------------------------------------
# Requests + batching policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One queued inference request (leading dim = rows).

    ``rank`` is the cached ``priority_rank(priority)`` and is *required*:
    EDF packing sorts on it, and a request record missing it would
    silently sort at default priority instead of failing — so construction
    validates it loudly.  ``ready`` is the event recorded on the
    submitting stream when ``x`` lies on a CUDA device: the worker's
    stream waits on it before it reads ``x``."""

    x: torch.Tensor
    rows: int
    future: Future
    t_submit: float
    deadline: Optional[float] = None     # absolute clock time, or None
    retries: int = 0                     # re-executions consumed so far
    not_before: Optional[float] = None   # retry backoff gate (absolute)
    priority: str = DEFAULT_PRIORITY     # one of traffic.PRIORITY_CLASSES
    rank: int = dataclasses.field(kw_only=True)  # priority_rank(priority)
    ready: Optional["torch.cuda.Event"] = dataclasses.field(kw_only=True,
                                                           default=None)

    def __post_init__(self) -> None:
        if not isinstance(self.rank, int) or isinstance(self.rank, bool):
            raise TypeError(
                f"rank must be an int priority rank, got {self.rank!r}; "
                "pass priority_rank(priority)")


class TokenStream:
    """Iterator over one streamed LM generation's tokens.

    Backed by a queue the executing worker pushes into
    (``LMSession.generate``'s ``on_token`` hook) and the request's future:
    when the future resolves — result, failure, deadline expiry, shed, or
    close — a sentinel wakes the consumer, which then either stops (all
    tokens already delivered) or re-raises the future's exception.

    Duplicate execution is safe by construction: a watchdog-requeued
    generation replays deterministically from step 0, and ``push`` drops
    any step index it has already emitted — so the consumer sees each
    token exactly once no matter how many times the generation ran.
    ``result(timeout)`` blocks for the full ``(batch, max_new_tokens)``
    token array (identical to the concatenation of streamed steps)."""

    _DONE = object()

    def __init__(self, future: Future) -> None:
        self.future = future
        self._q: "queue.Queue" = queue.Queue()
        self._emitted = 0
        self._lock = threading.Lock()
        future.add_done_callback(lambda _f: self._q.put(self._DONE))

    def push(self, step: int, tokens) -> None:
        """``on_token`` hook: deliver one step's tokens, dedup replays."""
        with self._lock:
            if step != self._emitted:
                return                   # replayed step of a re-execution
            self._emitted += 1
        self._q.put(tokens)

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self):
        item = self._q.get()
        if item is not self._DONE:
            return item
        # tokens are pushed before the future resolves (same thread), so
        # the sentinel is always last; re-queue it so an over-eager extra
        # __next__ terminates again instead of blocking
        self._q.put(self._DONE)
        if not self.future.cancelled():
            exc = self.future.exception()
            if exc is not None:
                raise exc
        raise StopIteration


@dataclasses.dataclass
class StreamRequest(Request):
    """A queued streamed-generation request: ``x`` is the ``(batch,
    prompt_len)`` host int array of tokens, ``rows`` its batch dim.  Rides the same
    pending deque as plain requests — deadlines (queued expiry), shedding,
    retries, and supervision all apply verbatim — but always *executes
    alone* (generation holds a worker for many decode steps; co-batching
    it behind CNN-style padding would serialize unrelated requests behind
    it)."""

    max_new_tokens: int = dataclasses.field(kw_only=True, default=1)
    stream: Optional[TokenStream] = dataclasses.field(kw_only=True,
                                                      default=None)


class BatchPolicy:
    """Decides *when* a batch forms and *which* requests it takes.

    Subclasses see only the pending queue and the clock, never the
    session — policies are pure scheduling logic and unit-testable without
    compiling anything.  ``select`` (which indices to pack) defaults to
    the FIFO prefix ``take`` returns, so pre-existing policies that only
    implement ``ready``/``take`` keep their exact behavior."""

    max_batch: int = 8

    def ready(self, pending: Sequence[Request], now: float) -> bool:
        raise NotImplementedError

    def take(self, pending: Sequence[Request], cap: int) -> int:
        raise NotImplementedError

    def select(self, pending: Sequence[Request], cap: int,
               now: float) -> List[int]:
        """Indices (into ``pending``) of the requests to pack, in batch
        order.  Default: the FIFO prefix of length ``take``."""
        return list(range(self.take(pending, cap)))

    def next_event(self, pending: Sequence[Request],
                   now: float) -> Optional[float]:
        """Seconds until this policy could become ready (worker wait hint);
        None = only a new submission can change readiness."""
        return None


@dataclasses.dataclass
class DynamicBatchPolicy(BatchPolicy):
    """Flush on ``max_batch`` pending rows or ``max_wait_ms`` oldest age.

    Packing is strictly FIFO: ``take`` returns the longest prefix of the
    queue whose total rows fit the cap.  Padded waste per executed batch
    is therefore ``nearest_bucket(total_rows) - total_rows`` — the
    documented (and property-tested) bound.

    ``fixed_bucket`` pins *every* executed batch to one specialized size:
    a partially-filled flush then pads up to the same program a full
    flush runs, so results are bit-reproducible regardless of traffic
    shape (the strict-determinism serving mode; the default ``None``
    lets small flushes use smaller buckets).

    ``order="edf"`` replaces FIFO *packing order* with
    earliest-deadline-first: eligible requests sort by (has a deadline,
    deadline, priority rank, arrival, queue index) and pack greedily
    into the cap — urgent interactive work jumps the queue ahead of
    deadline-free batch work.  Flush *timing* (``ready``) is unchanged,
    and every request still executes through the same fixed-shape bucket
    programs, so reordering never changes any request's numerics — the
    fixed-bucket bit-identity guarantee survives EDF verbatim.  The
    default ``order="fifo"`` preserves the strict never-reordered
    property the FIFO invariants are property-tested against."""

    max_batch: int = 8
    max_wait_ms: float = 5.0
    fixed_bucket: Optional[int] = None
    order: str = "fifo"

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.fixed_bucket is not None and self.fixed_bucket < 1:
            raise ValueError(
                f"fixed_bucket must be >= 1, got {self.fixed_bucket}")
        if self.order not in ("fifo", "edf"):
            raise ValueError(
                f"order must be 'fifo' or 'edf', got {self.order!r}")

    def ready(self, pending: Sequence[Request], now: float) -> bool:
        if not pending:
            return False
        total = 0
        for r in pending:
            total += r.rows
            if total >= self.max_batch:
                return True
        return (now - pending[0].t_submit) * 1e3 >= self.max_wait_ms

    def take(self, pending: Sequence[Request], cap: int) -> int:
        n, total = 0, 0
        for r in pending:
            if total + r.rows > cap and n > 0:
                break
            total += r.rows
            n += 1
            if total >= cap:
                break
        return n

    def select(self, pending: Sequence[Request], cap: int,
               now: float) -> List[int]:
        if self.order == "fifo":
            return list(range(self.take(pending, cap)))

        def key(i: int):
            r = pending[i]
            dl = r.deadline if r.deadline is not None else float("inf")
            # r.rank is a required field: a malformed request record
            # raises here instead of silently sorting at default priority
            return (r.deadline is None, dl, r.rank, r.t_submit, i)

        chosen: List[int] = []
        total = 0
        for i in sorted(range(len(pending)), key=key):
            rows = pending[i].rows
            if chosen and total + rows > cap:
                continue             # skip what no longer fits, keep packing
            chosen.append(i)
            total += rows
            if total >= cap:
                break
        return chosen

    def next_event(self, pending: Sequence[Request],
                   now: float) -> Optional[float]:
        if not pending:
            return None
        events = [pending[0].t_submit + self.max_wait_ms / 1e3]
        events += [r.deadline for r in pending if r.deadline is not None]
        return max(0.0, min(events) - now)


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingStats:
    """Counters + bounded distributions of one server's lifetime.

    Built on the O(1)-memory telemetry primitives, so its state stays
    bounded under sustained load:

    * ``arrival_hist`` — request sizes as submitted (what
      ``traffic.solve_buckets`` learns bucket sets from);
    * ``batch_hist`` — real rows per *executed* batch (``rows`` equals
      ``n_submitted``'s rows at quiescence; padded waste is the separate
      exact counter ``rows_padded``);
    * ``latency`` / ``latency_by_class`` — submit-to-resolve seconds,
      overall and per priority class, exact for small samples and
      P²-estimated past the buffer;
    * ``queue_depth_peak`` — high-water mark of the pending queue.

    ``snapshot()`` (and ``AsyncServer.stats``) returns a detached,
    internally-consistent copy."""

    n_submitted: int = 0
    n_completed: int = 0
    n_rejected_full: int = 0
    n_rejected_too_large: int = 0  # typed RequestTooLargeError at submit
    n_deadline_expired: int = 0
    n_failed: int = 0
    n_batches: int = 0
    rows_executed: int = 0         # real request rows
    rows_padded: int = 0           # zero rows added to reach the bucket
    n_retried: int = 0             # request re-executions granted
    n_retries_exhausted: int = 0   # requests failed past their budget
    n_shed: int = 0                # queued requests evicted by overload
    n_cancelled: int = 0           # client-cancelled requests dropped
    n_worker_crashes: int = 0      # worker threads that died mid-service
    n_worker_restarts: int = 0     # supervisor-spawned replacements
    n_hung_requeued: int = 0       # watchdog-requeued in-flight batches
    queue_depth_peak: int = 0
    arrival_hist: SizeHistogram = dataclasses.field(
        default_factory=SizeHistogram)
    batch_hist: SizeHistogram = dataclasses.field(
        default_factory=SizeHistogram)
    latency: StreamingQuantiles = dataclasses.field(
        default_factory=StreamingQuantiles)
    latency_by_class: Dict[str, StreamingQuantiles] = dataclasses.field(
        default_factory=dict)
    worker_batches: dict = dataclasses.field(default_factory=dict)

    @property
    def mean_batch_rows(self) -> float:
        return self.rows_executed / self.n_batches if self.n_batches else 0.0

    def record_latency(self, seconds: float, priority: str) -> None:
        self.latency.add(seconds)
        per = self.latency_by_class.get(priority)
        if per is None:
            per = self.latency_by_class[priority] = StreamingQuantiles()
        per.add(seconds)

    def percentile_ms(self, q: float) -> float:
        if self.latency.count == 0:
            return float("nan")
        return self.latency.percentile(q) * 1e3

    def snapshot(self) -> "ServingStats":
        """Detached copy: the distributions are copied, so mutating the
        snapshot (or the live object afterwards) changes nothing in the
        other.  Callers holding the server lock get atomicity too."""
        return dataclasses.replace(
            self,
            arrival_hist=self.arrival_hist.copy(),
            batch_hist=self.batch_hist.copy(),
            latency=self.latency.copy(),
            latency_by_class={k: v.copy()
                              for k, v in self.latency_by_class.items()},
            worker_batches=dict(self.worker_batches))

    def to_json(self) -> dict:
        return {
            "n_submitted": self.n_submitted,
            "n_completed": self.n_completed,
            "n_rejected_full": self.n_rejected_full,
            "n_rejected_too_large": self.n_rejected_too_large,
            "n_deadline_expired": self.n_deadline_expired,
            "n_failed": self.n_failed,
            "n_batches": self.n_batches,
            "rows_executed": self.rows_executed,
            "rows_padded": self.rows_padded,
            "n_retried": self.n_retried,
            "n_retries_exhausted": self.n_retries_exhausted,
            "n_shed": self.n_shed,
            "n_cancelled": self.n_cancelled,
            "n_worker_crashes": self.n_worker_crashes,
            "n_worker_restarts": self.n_worker_restarts,
            "n_hung_requeued": self.n_hung_requeued,
            "queue_depth_peak": self.queue_depth_peak,
            "mean_batch_rows": self.mean_batch_rows,
            "p50_ms": round(self.percentile_ms(50), 3),
            "p90_ms": round(self.percentile_ms(90), 3),
            "p99_ms": round(self.percentile_ms(99), 3),
            "arrival_hist": self.arrival_hist.to_json(),
            "batch_hist": self.batch_hist.to_json(),
            "latency_by_class": {k: v.to_json()
                                 for k, v in sorted(self.latency_by_class
                                                    .items())},
            "worker_batches": {str(k): v
                               for k, v in sorted(self.worker_batches
                                                  .items())},
        }


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

class AsyncServer:
    """Request queue + batching workers over one ``InferenceSession`` (or
    an ``LMSession``, through :meth:`submit_stream`).

    ``submit`` is thread-safe and non-blocking: it enqueues and returns a
    ``concurrent.futures.Future`` that resolves to exactly what
    ``padded_predict(session, x)`` would return — or a *typed*
    ``ServingError``; under supervision no request is ever silently lost.
    ``workers`` worker threads pack (under one lock) and execute batches,
    each on its own CUDA stream on a CUDA session — see the module docs
    for why results stay bit-identical to single-worker serving.  A
    response tensor was allocated on its worker's stream: a caller that
    reads it asynchronously on another stream and then drops it should
    ``record_stream`` it first, as with any tensor shared across streams.
    ``pin="auto"`` gives each worker thread its own CPU affinity set; an
    explicit ``pin`` is a list of one CPU set per worker.

    Fault-tolerance knobs: ``retry`` (a ``RetryPolicy``; ``budget=0``
    disables), ``shed`` (overload policy), ``watchdog_ms`` (hung-batch
    detection; off by default), ``max_restarts`` (per worker slot),
    ``faults`` (a ``FaultInjector`` for tests and the chaos step).

    ``autostart=False`` starts no threads: callers pump :meth:`step` (and
    :meth:`supervise`) themselves — the deterministic mode the tests use,
    with an injectable ``clock``.
    """

    def __init__(self, session, policy: Optional[BatchPolicy] = None, *,
                 max_queue: int = 128, workers: int = 1,
                 pin=None,
                 retry: Optional[RetryPolicy] = None,
                 shed: str = "newest",
                 watchdog_ms: Optional[float] = None,
                 max_restarts: int = 2,
                 faults: Optional[FaultInjector] = None,
                 priority_default: str = DEFAULT_PRIORITY,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 autostart: bool = True) -> None:
        if len(session.input_spec) != 1:
            raise ValueError("AsyncServer serves single-input models; got "
                             f"inputs {sorted(session.input_spec)}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if shed not in SHED_POLICIES:
            raise ValueError(f"unknown shed policy {shed!r}; "
                             f"pick one of {SHED_POLICIES}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.session = session
        self.policy = policy or DynamicBatchPolicy()
        fixed = getattr(self.policy, "fixed_bucket", None)
        if (fixed is not None and session.frozen
                and fixed not in session.batch_sizes):
            raise ValueError(
                f"fixed_bucket={fixed} is not a specialized batch size of "
                f"this frozen session (has {session.batch_sizes})")
        priority_rank(priority_default)      # typed validation up front
        self.priority_default = priority_default
        self.max_queue = max_queue
        self.workers = workers
        self._pin_sets = self._resolve_pin(pin, workers)
        self.retry = retry if retry is not None else RetryPolicy()
        self.shed = shed
        self.watchdog_ms = watchdog_ms
        self.max_restarts = max_restarts
        self.faults = faults
        self._stats = ServingStats()
        self._clock = clock
        self._sleep = sleep
        self._pending: Deque[Request] = collections.deque()
        self._cond = threading.Condition()
        self._draining = False
        self._closed = False
        self._batch_seq = 0
        self._inflight: Dict[int, List[Request]] = {}
        self._worker_gen: Dict[int, int] = {i: 0 for i in range(workers)}
        self._restarts: Dict[int, int] = {i: 0 for i in range(workers)}
        self._crash_counted: set = set()     # slots whose death is counted
        self._unhealthy: set = set()
        self._threads: List[Optional[threading.Thread]] = [None] * workers
        self._monitor = (HeartbeatMonitor(range(workers),
                                          timeout_s=watchdog_ms / 1e3,
                                          clock=clock)
                         if watchdog_ms is not None else None)
        self._straggler = (StragglerMitigator(
            range(workers), StragglerPolicy(slow_factor=3.0, evict_after=5))
            if watchdog_ms is not None and workers > 1 else None)
        self._supervisor: Optional[threading.Thread] = None
        self._stop_supervisor = threading.Event()
        # where each worker slot executes, and (on a CUDA device) the
        # stream it owns; a replica per device only where there are several
        self._devices = [self._worker_device(i) for i in range(workers)]
        self._streams = [torch.cuda.Stream(device=d)
                         if d is not None and d.type == "cuda" else None
                         for d in self._devices]
        self._replicated = len(set(self._devices)) > 1
        if autostart:
            for i in range(workers):
                self._threads[i] = self._spawn_worker(i, gen=0)
            self._supervisor = threading.Thread(
                target=self._supervisor_main, daemon=True,
                name="neocpu-serving-supervisor")
            self._supervisor.start()

    def _spawn_worker(self, slot: int, gen: int) -> threading.Thread:
        t = threading.Thread(target=self._worker_main, args=(slot, gen),
                             daemon=True,
                             name=f"neocpu-serving-{slot}.{gen}")
        t.start()
        return t

    def _worker_device(self, worker: int) -> Optional[torch.device]:
        """The device worker ``worker`` executes on: the session's, or,
        where the session's device type has more than one device (CUDA
        only: ``torch.cuda.device_count()``), device ``worker % D``."""
        dev = getattr(self.session, "device", None)
        if dev is None or torch.device(dev).type != "cuda":
            return dev
        dev = torch.device(dev)
        n = torch.cuda.device_count()
        if self.workers > 1 and n > 1:
            return torch.device("cuda", worker % n)
        return torch.device("cuda", torch.cuda.current_device()
                            if dev.index is None else dev.index)

    @staticmethod
    def _resolve_pin(pin, workers):
        if pin is None:
            return None
        from repro_torch.launch.cpu import worker_cpu_sets

        if pin == "auto":
            return worker_cpu_sets(workers)
        sets = [tuple(s) for s in pin]
        if len(sets) != workers:
            raise ValueError(f"pin gives {len(sets)} CPU sets for "
                             f"{workers} workers")
        return sets

    # -- stats ---------------------------------------------------------------
    @property
    def stats(self) -> ServingStats:
        """Internally-consistent point-in-time copy of the counters.
        Workers mutate the live object under the server lock, so reading
        fields off it lock-free could tear — e.g. observe a request
        counted completed while its batch still appears in flight.  The
        snapshot is taken under the same lock every mutation holds
        (invariant at any quiescent point: ``n_completed + n_failed +
        n_shed + n_cancelled + n_deadline_expired + queued + in-flight ==
        n_submitted``), and the copy is detached — mutating it changes
        nothing in the server."""
        with self._cond:
            return self._stats.snapshot()

    # -- capacity ------------------------------------------------------------
    def _cap(self) -> int:
        """Max rows one batch may pack: the policy's max_batch, clamped to
        the pinned bucket (if any) and to the largest executable bucket
        when the session cannot grow."""
        cap = self.policy.max_batch
        fixed = getattr(self.policy, "fixed_bucket", None)
        if fixed is not None:
            cap = min(cap, fixed)
        if self.session.frozen:
            cap = min(cap, max(self.session.batch_sizes))
        return cap

    # -- client side ---------------------------------------------------------
    def submit(self, x, deadline_ms: Optional[float] = None,
               priority: Optional[str] = None) -> Future:
        """Enqueue one request (leading dim = rows): a numpy array, a CPU
        tensor or a tensor on the session's device.  Raises
        :class:`QueueFullError` at capacity (unless the shed policy
        evicts a queued request instead), :class:`DeadlineExceededError`
        for an already-expired deadline, :class:`ServerClosedError` after
        close/drain, :class:`RequestTooLargeError` past the packable
        maximum, ValueError for a malformed request or unknown
        ``priority`` class."""
        if (hasattr(self.session, "generate")
                and not hasattr(self.session, "predict")):
            raise ServingError(
                "this server wraps an LM session (token generation, not "
                "batched predict); use submit_stream")
        x = as_tensor(x)
        (spec,) = self.session.input_spec.values()
        if x.dim() != len(spec):
            raise ValueError(f"expected a rank-{len(spec)} batch of inputs "
                             f"{tuple(spec[1:])}, got shape {tuple(x.shape)}")
        rows = int(x.shape[0])
        if rows < 1:
            raise ValueError("empty request")
        priority = self.priority_default if priority is None else priority
        rank = priority_rank(priority)
        if rows > self._cap():
            with self._cond:
                self._stats.n_rejected_too_large += 1
            raise RequestTooLargeError(
                f"request of {rows} rows exceeds the packable maximum "
                f"{self._cap()} (policy max_batch clamped to the largest "
                "specialized bucket of a frozen session); split it")
        # the worker's stream reads x only after what the submitting
        # stream had queued by now (the work that made x)
        ready = (torch.cuda.current_stream(x.device).record_event()
                 if x.is_cuda else None)
        fut: Future = Future()
        self._admit(lambda now, deadline: Request(
            x, rows, fut, now, deadline, priority=priority, rank=rank,
            ready=ready), deadline_ms, traffic=rows)
        return fut

    def predict(self, x, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None,
                priority: Optional[str] = None):
        """Blocking convenience: submit + wait."""
        return self.submit(x, deadline_ms=deadline_ms,
                           priority=priority).result(timeout)

    def submit_stream(self, tokens, max_new_tokens: int,
                      deadline_ms: Optional[float] = None,
                      priority: Optional[str] = None) -> TokenStream:
        """Enqueue one streamed LM generation; returns a
        :class:`TokenStream` yielding each decode step's tokens as the
        worker produces them (``StopIteration`` when the generation
        completes; the future's typed error re-raised on failure).

        The request rides the same bounded queue as :meth:`submit`:
        ``deadline_ms`` expires *queued* generations (a generation that
        started executing always runs to completion — its tokens are
        already streaming), overload shedding, retry/requeue, and worker
        supervision apply unchanged, and a watchdog-requeued generation
        replays idempotently (greedy decode is deterministic, and the
        stream dedups re-emitted steps).  Requires a session with a
        ``generate`` method (:class:`~engine.lm_session.LMSession`)."""
        if not hasattr(self.session, "generate"):
            raise ServingError(
                "submit_stream needs an LM session (with generate); this "
                "server wraps a CNN session — use submit")
        x = (tokens.cpu().numpy() if isinstance(tokens, torch.Tensor)
             else np.asarray(tokens))
        if x.ndim != 2:
            raise ValueError(f"tokens must be (batch, prompt_len), got "
                             f"shape {tuple(x.shape)}")
        rows = int(x.shape[0])
        prompt_len = int(x.shape[1])
        if rows != self.session.batch:
            raise ValueError(
                f"this LM session serves batch={self.session.batch} "
                f"generations; got {rows} prompt rows")
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if prompt_len + max_new_tokens - 1 > self.session.max_len:
            raise RequestTooLargeError(
                f"prompt ({prompt_len}) + new tokens ({max_new_tokens}) "
                f"overflow the session's max_len="
                f"{self.session.max_len}; split or truncate")
        priority = self.priority_default if priority is None else priority
        rank = priority_rank(priority)
        fut: Future = Future()
        stream = TokenStream(fut)
        self._admit(lambda now, deadline: StreamRequest(
            x, rows, fut, now, deadline, priority=priority, rank=rank,
            max_new_tokens=int(max_new_tokens), stream=stream),
            deadline_ms, traffic=prompt_len)
        return stream

    def _admit(self, make: Callable[[float, Optional[float]], Request],
               deadline_ms: Optional[float], traffic: int) -> None:
        """Admission control shared by :meth:`submit` and
        :meth:`submit_stream`: reject an expired deadline, a closed or
        dead server, and a full queue (unless the shed policy evicts a
        queued request); then queue ``make(now, deadline)`` and record it
        (``traffic`` — rows, or a prompt's length — feeds the session's
        recorder, what ``save(buckets="auto")`` and ``solve_seq_buckets``
        learn from)."""
        now = self._clock()
        if deadline_ms is not None and deadline_ms <= 0:
            # deadline-aware admission: work that cannot possibly finish
            # in time is rejected up front, never queued
            with self._cond:
                self._stats.n_deadline_expired += 1
            raise DeadlineExceededError(
                f"deadline_ms={deadline_ms} already expired at submission")
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        with self._cond:
            if self._closed or self._draining:
                raise ServerClosedError("server is closed to new requests")
            if (self._threads and self._unhealthy
                    and len(self._unhealthy) == len(self._threads)):
                raise AllWorkersUnhealthyError(
                    "every worker slot exhausted its restart budget; "
                    "the server cannot execute requests")
            if len(self._pending) >= self.max_queue:
                victim = choose_shed_victim(self._pending, self.shed)
                if victim is None:
                    self._stats.n_rejected_full += 1
                    raise QueueFullError(
                        f"request queue at capacity ({self.max_queue}); "
                        "retry later or raise max_queue")
                shed = self._pending[victim]
                del self._pending[victim]
                if self._resolve(shed.future, exc=LoadShedError(
                        f"shed by the {self.shed!r} overload policy after "
                        f"{(now - shed.t_submit) * 1e3:.1f} ms queued")):
                    self._stats.n_shed += 1
            req = make(now, deadline)
            self._pending.append(req)
            self._stats.n_submitted += 1
            self._stats.arrival_hist.add(req.rows)
            self._stats.queue_depth_peak = max(
                self._stats.queue_depth_peak, len(self._pending))
            recorder = getattr(self.session, "traffic", None)
            if recorder is not None:
                recorder.add(traffic)
            self._cond.notify_all()

    # -- scheduling core -----------------------------------------------------
    @staticmethod
    def _resolve(fut: Future, value=None, exc: Optional[BaseException] = None
                 ) -> bool:
        """Resolve a client future exactly once, tolerating client-side
        cancel() and duplicate execution: returns False (and sets
        nothing) when the client cancelled the request while it was
        queued, or when the future already holds a result — a hung batch
        requeued by the watchdog may legally execute twice, and the first
        (bit-identical) result wins."""
        if fut.done():
            return False
        if not fut.set_running_or_notify_cancel():
            return False
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except Exception:               # lost a set race: first writer won
            return False
        return True

    def _expire_locked(self, now: float) -> None:
        """Fail queued requests whose deadline passed (checked whenever a
        batch could form — expired work is never executed late) and drop
        client-cancelled ones."""
        keep: Deque[Request] = collections.deque()
        for r in self._pending:
            if r.future.cancelled():
                self._stats.n_cancelled += 1
                continue
            if r.deadline is not None and now >= r.deadline:
                if self._resolve(r.future, exc=DeadlineExceededError(
                        f"queued for {(now - r.t_submit) * 1e3:.1f} ms, "
                        "past its deadline")):
                    self._stats.n_deadline_expired += 1
            else:
                keep.append(r)
        self._pending = keep

    def _ready_prefix_locked(self, now: float) -> Sequence[Request]:
        """The FIFO prefix eligible to form a batch now: requests whose
        retry backoff gate has passed.  Strict FIFO means a backing-off
        head blocks everything behind it; during drain the gates are
        waived so close() terminates."""
        if self._draining:
            return self._pending
        n = 0
        for r in self._pending:
            if r.not_before is not None and now < r.not_before:
                break
            n += 1
        if n == len(self._pending):
            return self._pending
        return [self._pending[i] for i in range(n)]

    def _form_locked(self, now: float) -> Optional[List[Request]]:
        pending = self._ready_prefix_locked(now)
        if not pending:
            return None
        cap = self._cap()
        # readiness belongs to the policy, but a FIFO prefix that already
        # fills the *executable* cap (which may be tighter than the
        # policy's max_batch on a frozen session) must flush immediately
        # rather than idle on the max_wait timer
        total = 0
        filled = False
        for r in pending:
            total += r.rows
            if total >= cap:
                filled = True
                break
        if not (self._draining or filled
                or self.policy.ready(pending, now)):
            return None
        idxs = self.policy.select(pending, cap, now)
        if not idxs:
            return None
        # `pending` is a prefix of the deque, so indices into it address
        # the same positions in self._pending; de-dup defensively and
        # remove back-to-front so earlier indices stay valid
        seen: set = set()
        idxs = [i for i in idxs
                if 0 <= i < len(pending)
                and not (i in seen or seen.add(i))]
        if not idxs:
            return None
        # streamed generations execute alone: cut the packed list at the
        # first stream boundary (a leading stream request runs solo; a
        # stream behind plain requests waits for the next batch)
        cut: List[int] = []
        for i in idxs:
            if isinstance(pending[i], StreamRequest):
                if not cut:
                    cut = [i]
                break
            cut.append(i)
        idxs = cut
        batch = [self._pending[i] for i in idxs]
        for i in sorted(idxs, reverse=True):
            del self._pending[i]
        return batch

    def _wait_timeout_locked(self, now: float) -> Optional[float]:
        """Bound the worker's wait by the policy's hint, the earliest
        pending deadline (deadline expiry is the server's promise, so it
        must not depend on a custom policy implementing next_event), and
        the head's retry-backoff gate (a blocked head makes the policy's
        hints meaningless until it unblocks)."""
        t = None
        if self._pending:
            nb = self._pending[0].not_before
            if nb is not None and nb > now:
                t = nb - now
            else:
                t = self.policy.next_event(self._pending, now)
        deadlines = [r.deadline for r in self._pending
                     if r.deadline is not None]
        if deadlines:
            d = max(0.0, min(deadlines) - now)
            t = d if t is None else min(t, d)
        return t

    def _model_for(self, bucket: int, worker: int):
        """The executable this worker runs ``bucket`` through: the shared
        specialization — or, where the workers execute on several devices,
        its replica on this worker's (``CompiledModel.replica``) —
        identical numerics, concurrent execution."""
        m = self.session.specialize(bucket)
        return m.replica(self._devices[worker]) if self._replicated else m

    def _fail_or_requeue(self, batch: List[Request],
                         exc: BaseException,
                         worker: Optional[int] = None) -> None:
        """A batch execution failed: requeue each request at the queue
        head (preserving FIFO order) with its backoff gate set, or fail
        its future once the retry budget is spent.  ``budget=0`` fails
        with the original exception — the no-retry behavior.

        ``worker`` retires the batch's in-flight entry in the same locked
        section that requeues/fails it: removing it later (the caller's
        ``finally``) would leave a window where a request is counted both
        pending and in flight."""
        now = self._clock()
        with self._cond:
            if (worker is not None
                    and self._inflight.get(worker) is batch):
                del self._inflight[worker]
            self._requeue_orphans(batch, exc, now)
            self._cond.notify_all()

    def _gather(self, batch: List[Request], worker: int) -> torch.Tensor:
        """The batch's rows in one tensor on the worker's device, read on
        the worker's stream after each input's ``ready``."""
        device, stream = self._devices[worker], self._streams[worker]
        xs = []
        for r in batch:
            if r.ready is not None and stream is not None:
                stream.wait_event(r.ready)
            xs.append(r.x if device is None else r.x.to(device))
        return xs[0] if len(xs) == 1 else torch.cat(xs)

    def _execute(self, batch: List[Request], worker: int = 0,
                 seq: Optional[int] = None) -> None:
        rows = sum(r.rows for r in batch)
        stream = self._streams[worker]
        try:
            with _on_stream(stream):
                if self.faults is not None and seq is not None:
                    self.faults.fire(worker, seq, self._sleep)
                if isinstance(batch[0], StreamRequest):
                    # streams execute alone (enforced by _form_locked):
                    # run the generation, tokens flowing to the client as
                    # each decode step lands; the full array resolves the
                    # future
                    r = batch[0]
                    bucket = rows            # no padding on the LM path
                    y = self.session.generate(r.x, r.max_new_tokens,
                                              on_token=r.stream.push)
                else:
                    bucket = getattr(self.policy, "fixed_bucket", None)
                    if bucket is None:
                        bucket = nearest_bucket(rows,
                                                self.session.batch_sizes)
                    if bucket is None:
                        # on-demand re-specialization (session lock
                        # serializes the planner); _cap() already rejected
                        # this for frozen sessions
                        bucket = rows
                    m = self._model_for(bucket, worker)
                    y = m.predict(pad_rows(self._gather(batch, worker),
                                           bucket))
                    y = _slice_rows(y, 0, rows)
                if stream is not None:
                    stream.synchronize()     # this batch only, not the card
        except BaseException as e:      # noqa: BLE001 — retry or fail typed
            _quiesce(stream)
            self._fail_or_requeue(batch, e, worker=worker)
            if isinstance(e, InjectedWorkerCrash):
                raise WorkerCrashError(str(e)) from e
            return
        done = self._clock()
        off = 0
        n_ok = 0
        lats = []
        for r in batch:
            if self._resolve(r.future, _slice_rows(y, off, off + r.rows)):
                n_ok += 1
                lats.append((done - r.t_submit, r.priority))
            off += r.rows
        with self._cond:
            self._stats.n_batches += 1
            self._stats.rows_executed += rows
            self._stats.rows_padded += bucket - rows
            self._stats.batch_hist.add(rows)
            self._stats.n_completed += n_ok
            for lat, prio in lats:
                self._stats.record_latency(lat, prio)
            self._stats.worker_batches[worker] = \
                self._stats.worker_batches.get(worker, 0) + 1
            # the batch leaves flight in the same locked section that
            # counts it completed, so no snapshot can observe requests
            # both completed and in flight (the callers' ``finally``
            # removal stays as an identity-checked backstop for the
            # watchdog-requeue path)
            if self._inflight.get(worker) is batch:
                del self._inflight[worker]
            self._cond.notify_all()

    def step(self) -> bool:
        """Expire deadlines and execute at most one ready batch *now*
        (manual pump — deterministic tests, synchronous callers).  Returns
        True iff a batch ran (or crashed: an injected worker kill counts
        as one crash-and-instant-restart here, since there is no thread
        to die)."""
        with self._cond:
            now = self._clock()
            self._expire_locked(now)
            batch = self._form_locked(now)
            if batch is not None:
                seq = self._batch_seq
                self._batch_seq += 1
                self._inflight[0] = batch
        if batch is None:
            return False
        try:
            self._execute(batch, worker=0, seq=seq)
        except WorkerCrashError:
            with self._cond:
                self._stats.n_worker_crashes += 1
        finally:
            with self._cond:
                if self._inflight.get(0) is batch:
                    del self._inflight[0]
                self._cond.notify_all()
        return True

    def _worker_main(self, worker: int, gen: int = 0) -> None:
        if self._pin_sets is not None:
            from repro_torch.launch.cpu import maybe_pin
            maybe_pin(self._pin_sets[worker])   # pins this thread only
        self._worker_loop(worker, gen)

    def _worker_loop(self, worker: int = 0, gen: int = 0) -> None:
        while True:
            with self._cond:
                while True:
                    if (self._worker_gen.get(worker, gen) != gen
                            or worker in self._unhealthy):
                        return          # superseded zombie / evicted slot
                    now = self._clock()
                    self._expire_locked(now)
                    if self._closed or (self._draining
                                        and not self._pending):
                        return
                    batch = self._form_locked(now)
                    if batch is not None:
                        seq = self._batch_seq
                        self._batch_seq += 1
                        self._inflight[worker] = batch
                        break
                    self._cond.wait(self._wait_timeout_locked(now))
            if self._monitor is not None:
                self._monitor.beat(worker)
            t0 = self._clock()
            try:
                self._execute(batch, worker, seq=seq)
            except WorkerCrashError:
                with self._cond:        # counted here, not when the
                    self._stats.n_worker_crashes += 1    # supervisor sees it
                    self._crash_counted.add(worker)
                return                  # thread dies; supervisor restarts
            finally:
                with self._cond:
                    if self._inflight.get(worker) is batch:
                        del self._inflight[worker]
                    if (self._straggler is not None
                            and self._worker_gen.get(worker) == gen):
                        self._straggler.record(
                            {worker: self._clock() - t0})
                    self._cond.notify_all()
                if (self._monitor is not None
                        and self._worker_gen.get(worker) == gen):
                    self._monitor.beat(worker)

    # -- supervision ---------------------------------------------------------
    def _supervisor_main(self) -> None:
        interval = 0.01
        if self.watchdog_ms is not None:
            interval = min(interval, self.watchdog_ms / 1e3 / 4)
        while not self._stop_supervisor.wait(interval):
            with self._cond:
                if self._closed:
                    return
            self.supervise()

    def supervise(self) -> None:
        """One supervision pass: requeue what dead threads left in
        flight, restart crashed worker slots (or mark them unhealthy past
        ``max_restarts``), fire the hung-batch watchdog, and degrade to a
        typed failure when no worker survives.  Called periodically by
        the supervisor thread; pump it by hand in ``autostart=False``
        tests."""
        now = self._clock()
        with self._cond:
            self._check_dead_locked(now)
            if self._monitor is not None:
                self._check_hung_locked(now)
            if self._straggler is not None:
                self._straggler.stragglers()      # update strike counters
                for w in self._straggler.evictions():
                    if w not in self._unhealthy:
                        self._supersede_locked(
                            w, reason="straggler eviction", requeue=True)
            self._degrade_locked()
            self._cond.notify_all()

    def _check_dead_locked(self, now: float) -> None:
        if self._closed or self._draining:
            return                      # workers exit legitimately now
        for slot, t in enumerate(self._threads):
            if t is None or t.is_alive() or slot in self._unhealthy:
                continue
            # the slot's current thread died without being superseded:
            # that is a crash — requeue whatever it left in flight
            # (backstop; the injected-kill path already requeued) and
            # restart or evict the slot
            if slot not in self._crash_counted:
                self._stats.n_worker_crashes += 1
            self._crash_counted.discard(slot)
            self._threads[slot] = None
            batch = self._inflight.pop(slot, None)
            if batch:
                self._requeue_orphans(batch, WorkerCrashError(
                    f"worker {slot} died mid-batch"), now)
            self._restart_or_evict_locked(slot)

    def _check_hung_locked(self, now: float) -> None:
        for slot in self._monitor.check():
            if (slot in self._unhealthy or self._threads[slot] is None
                    or not self._threads[slot].is_alive()):
                continue                # dead slots are _check_dead's job
            batch = self._inflight.pop(slot, None)
            if batch is None:
                # idle silence: workers only beat at batch boundaries, so
                # a quiet queue looks like silence — revive, don't kill
                self._monitor.revive(slot)
                continue
            # hung batch: requeue it (duplicate execution is safe — the
            # first bit-identical result wins via the future done-guard)
            # and supersede the zombie thread
            self._stats.n_hung_requeued += 1
            if self._straggler is not None:
                self._straggler.record({slot: self.watchdog_ms / 1e3})
            self._requeue_orphans(batch, WorkerCrashError(
                f"worker {slot} hung past the {self.watchdog_ms} ms "
                "watchdog"), now)
            self._supersede_locked(slot, reason="hung batch", requeue=False)

    def _requeue_orphans(self, batch: List[Request], exc: BaseException,
                         now: float) -> None:
        """Requeue (within the retry budget) or fail each request of a
        batch that failed or was orphaned; the server lock is held."""
        requeue: List[Request] = []
        for r in batch:
            if r.future.cancelled():
                self._stats.n_cancelled += 1
                continue
            if r.future.done():
                continue
            if not self._closed and r.retries < self.retry.budget:
                r.retries += 1
                r.not_before = now + self.retry.backoff_s(r.retries)
                requeue.append(r)
                self._stats.n_retried += 1
                continue
            if self.retry.budget > 0:
                err: BaseException = RetriesExhaustedError(
                    f"failed after {r.retries} retries "
                    f"(budget {self.retry.budget}): {exc!r}")
                err.__cause__ = exc
                self._stats.n_retries_exhausted += 1
            else:
                err = exc
            if self._resolve(r.future, exc=err):
                self._stats.n_failed += 1
        for r in reversed(requeue):
            self._pending.appendleft(r)

    def _supersede_locked(self, slot: int, *, reason: str,
                          requeue: bool) -> None:
        """Retire a slot's current thread (it exits at its next loop check
        via the generation token) and restart or evict the slot."""
        self._worker_gen[slot] = self._worker_gen.get(slot, 0) + 1
        if requeue:
            batch = self._inflight.pop(slot, None)
            if batch:
                self._requeue_orphans(batch, WorkerCrashError(
                    f"worker {slot} superseded: {reason}"), self._clock())
        self._threads[slot] = None
        self._restart_or_evict_locked(slot)

    def _restart_or_evict_locked(self, slot: int) -> None:
        if self._restarts[slot] < self.max_restarts:
            self._restarts[slot] += 1
            self._stats.n_worker_restarts += 1
            gen = self._worker_gen[slot] = self._worker_gen.get(slot, 0) + 1
            if self._monitor is not None:
                self._monitor.revive(slot)
            self._threads[slot] = self._spawn_worker(slot, gen)
        else:
            self._unhealthy.add(slot)
            if self._straggler is not None:
                self._straggler.drop(slot)

    def _degrade_locked(self) -> None:
        if not (self._threads and self._unhealthy
                and len(self._unhealthy) == len(self._threads)):
            return
        while self._pending:
            r = self._pending.popleft()
            if self._resolve(r.future, exc=AllWorkersUnhealthyError(
                    "every worker slot exhausted its restart budget")):
                self._stats.n_failed += 1

    def health(self) -> dict:
        """Point-in-time health snapshot for external probes (the
        counters also ride in ``stats.to_json()``)."""
        with self._cond:
            alive = sum(1 for t in self._threads
                        if t is not None and t.is_alive())
            return {
                "queue_depth": len(self._pending),
                "inflight_batches": len(self._inflight),
                "inflight_requests": sum(len(b) for b in
                                         self._inflight.values()),
                "workers": {
                    "configured": self.workers,
                    "alive": alive,
                    "unhealthy": sorted(self._unhealthy),
                    "restarts": dict(self._restarts),
                },
                "watchdog_ms": self.watchdog_ms,
                "shed_policy": self.shed,
                "retry_budget": self.retry.budget,
                "draining": self._draining,
                "closed": self._closed,
                "counters": {
                    "n_submitted": self._stats.n_submitted,
                    "n_completed": self._stats.n_completed,
                    "n_failed": self._stats.n_failed,
                    "n_retried": self._stats.n_retried,
                    "n_retries_exhausted": self._stats.n_retries_exhausted,
                    "n_shed": self._stats.n_shed,
                    "n_cancelled": self._stats.n_cancelled,
                    "n_rejected_full": self._stats.n_rejected_full,
                    "n_rejected_too_large":
                        self._stats.n_rejected_too_large,
                    "n_deadline_expired": self._stats.n_deadline_expired,
                    "n_worker_crashes": self._stats.n_worker_crashes,
                    "n_worker_restarts": self._stats.n_worker_restarts,
                    "n_hung_requeued": self._stats.n_hung_requeued,
                },
                "telemetry": {
                    "queue_depth_peak": self._stats.queue_depth_peak,
                    "arrival_hist": self._stats.arrival_hist.to_json(),
                    "rows_padded": self._stats.rows_padded,
                    "mean_batch_rows": self._stats.mean_batch_rows,
                    "latency_ms": {
                        "p50": round(self._stats.percentile_ms(50), 3),
                        "p90": round(self._stats.percentile_ms(90), 3),
                        "p99": round(self._stats.percentile_ms(99), 3),
                    },
                    "latency_by_class": {
                        k: v.to_json()
                        for k, v in sorted(self._stats.latency_by_class
                                           .items())},
                },
            }

    # -- lifecycle -----------------------------------------------------------
    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> None:
        """Stop accepting requests.  ``drain=True`` completes everything
        already queued or in flight first; ``drain=False`` fails queued
        requests with :class:`ServerClosedError` immediately.

        Robust by construction: idempotent (a second close returns
        immediately), and ``drain=True`` terminates even when worker
        threads are dead or a batch raises mid-drain — once the threads
        are gone the closing thread pumps the remainder itself, with
        retry budgets bounding the work (backoff gates are waived during
        drain).  A worker hung in a predict call is the one thing that
        can stall the join — pass ``timeout`` (per join) to bound it;
        whatever remains is failed typed."""
        with self._cond:
            if self._closed:
                return
            self._draining = True
            if not drain:
                while self._pending:
                    r = self._pending.popleft()
                    self._resolve(r.future, exc=ServerClosedError(
                        "server closed before execution"))
                self._closed = True
            self._cond.notify_all()
        self._stop_supervisor.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout)
            self._supervisor = None
        for t in list(self._threads):
            if t is not None:
                t.join(timeout)
        if drain:
            # backstop drain: if the workers died (or never existed —
            # manual mode), the closing thread pumps what is left; a
            # batch that keeps failing exhausts its requests' retry
            # budgets, so this terminates
            while True:
                with self._cond:
                    if self._closed or not self._pending:
                        break
                    threads_alive = any(t is not None and t.is_alive()
                                        for t in self._threads)
                if threads_alive:       # join timed out but they live on
                    with self._cond:
                        self._cond.wait(0.05)
                    continue
                if not self.step():
                    break               # nothing formable: fail leftovers
        with self._cond:
            self._closed = True
            while self._pending:        # whatever a dead worker left behind
                r = self._pending.popleft()
                self._resolve(r.future, exc=ServerClosedError(
                    "server closed before execution"))

    @property
    def closed(self) -> bool:
        return self._closed

    def __len__(self) -> int:
        with self._cond:
            return len(self._pending)

    def __enter__(self) -> "AsyncServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))
