"""Pure supervision logic for the serving stack: heartbeats, straggler
detection, retry backoff, and overload-shedding decisions — a copy of the
reference's ``repro/engine/supervision.py``.

Everything here is deterministic decision logic — no threads, no torch, no
clocks beyond the injected callable — so the serving watchdog's behavior
is unit-testable without compiling or serving anything.
``engine/serving.py`` is the consumer:

* :class:`HeartbeatMonitor` — workers beat at batch boundaries; a worker
  silent past ``timeout_s`` *while holding an in-flight batch* is a hung
  batch the supervisor requeues (idle silence is revived, not killed).
* :class:`StragglerMitigator` — per-worker batch-time history; a worker
  consistently slower than the fleet median is flagged and, after
  ``evict_after`` consecutive strikes, evicted (marked unhealthy).
* :class:`RetryPolicy` — per-request retry budget + exponential backoff
  for requests stranded by a crashed or failed batch.
* :func:`choose_shed_victim` — the pluggable overload policy behind
  ``AsyncServer(shed=...)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence


# ---------------------------------------------------------------------------
# Heartbeats
# ---------------------------------------------------------------------------

class HeartbeatMonitor:
    """Declare a host/worker dead after ``timeout_s`` of silence.

    Pure decision logic: the clock is injected, ``beat``/``check`` are the
    whole protocol.  The serving watchdog additionally calls
    :meth:`revive` when a silent worker turns out to be idle (no in-flight
    batch) or when a crashed slot is restarted with a fresh thread."""

    def __init__(self, hosts: Sequence[int], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        now = clock()
        self.last_seen: Dict[int, float] = {h: now for h in hosts}
        self.dead: set = set()

    def beat(self, host: int) -> None:
        if host not in self.dead:
            self.last_seen[host] = self.clock()

    def check(self) -> List[int]:
        """Returns hosts newly declared dead."""
        now = self.clock()
        newly = [h for h, t in self.last_seen.items()
                 if h not in self.dead and now - t > self.timeout_s]
        self.dead.update(newly)
        return newly

    def revive(self, host: int) -> None:
        """Un-declare a death: the worker was idle (not hung), or its slot
        got a fresh thread.  Resets the silence window."""
        self.dead.discard(host)
        self.last_seen[host] = self.clock()

    @property
    def alive(self) -> List[int]:
        return sorted(h for h in self.last_seen if h not in self.dead)


# ---------------------------------------------------------------------------
# Straggler detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerPolicy:
    slow_factor: float = 1.5     # avg time > factor x median -> straggler
    evict_after: int = 3         # consecutive straggler windows -> evict
    window: int = 5              # smoothing window (batches)


class StragglerMitigator:
    """Rolling per-worker batch-time history + median-relative flagging.

    ``record`` per-batch durations, ``stragglers()`` to flag (and strike)
    the consistently slow, ``evictions()`` for workers past the strike
    budget.  ``drop`` forgets an evicted worker so it stops skewing the
    median."""

    def __init__(self, hosts: Sequence[int],
                 policy: StragglerPolicy = StragglerPolicy()):
        self.policy = policy
        self.history: Dict[int, List[float]] = {h: [] for h in hosts}
        self.strikes: Dict[int, int] = {h: 0 for h in hosts}

    def record(self, times: Dict[int, float]) -> None:
        for h, t in times.items():
            hist = self.history.setdefault(h, [])
            hist.append(t)
            del hist[:-self.policy.window]

    def _avg(self, h: int) -> float:
        hist = self.history[h] or [0.0]
        return sum(hist) / len(hist)

    def stragglers(self) -> List[int]:
        avgs = {h: self._avg(h) for h in self.history}
        med = sorted(avgs.values())[len(avgs) // 2]
        out = []
        for h, t in avgs.items():
            if med > 0 and t > self.policy.slow_factor * med:
                self.strikes[h] = self.strikes.get(h, 0) + 1
                out.append(h)
            else:
                self.strikes[h] = 0
        return out

    def evictions(self) -> List[int]:
        return [h for h, s in self.strikes.items()
                if s >= self.policy.evict_after]

    def batch_weights(self) -> Dict[int, float]:
        """1/avg-time weights (proportionally fewer rows to slow hosts),
        the weights of ``runtime.rebalanced_batch_split``."""
        return {h: 1.0 / max(self._avg(h), 1e-6) for h in self.history}

    def drop(self, host: int) -> None:
        self.history.pop(host, None)
        self.strikes.pop(host, None)


# ---------------------------------------------------------------------------
# Retry backoff
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-request retry budget for requests stranded by a crashed worker
    or a failed batch, with capped exponential backoff.

    ``budget`` is the number of *re*-executions a request may get beyond
    its first attempt; ``budget=0`` disables retries entirely (a failed
    batch fails its futures with the original exception, the pre-fault-
    tolerance behavior)."""

    budget: int = 2
    backoff_ms: float = 10.0
    backoff_factor: float = 2.0
    max_backoff_ms: float = 1000.0

    def __post_init__(self) -> None:
        if self.budget < 0:
            raise ValueError(f"budget must be >= 0, got {self.budget}")
        if self.backoff_ms < 0 or self.backoff_factor < 1:
            raise ValueError("backoff_ms must be >= 0 and backoff_factor "
                             f">= 1, got {self.backoff_ms}/"
                             f"{self.backoff_factor}")

    def backoff_s(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (1-based) executes."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        b = self.backoff_ms * self.backoff_factor ** (attempt - 1)
        return min(b, self.max_backoff_ms) / 1e3


# ---------------------------------------------------------------------------
# Overload shedding
# ---------------------------------------------------------------------------

SHED_POLICIES = ("newest", "oldest", "deadline")


def choose_shed_victim(pending: Sequence, policy: str) -> Optional[int]:
    """Which *queued* request to shed so a new one can be admitted when
    the queue is full.  Returns an index into ``pending``, or None to
    reject the newcomer instead (the queue keeps what it has).

    * ``"newest"``  — never evict: reject the incoming request
      (``QueueFullError`` backpressure, the pre-fault-tolerance default);
    * ``"oldest"``  — evict the head of the queue: its latency budget is
      the most spent, and the newest request has the longest useful life;
    * ``"deadline"`` — deadline-aware admission control: evict the queued
      request *closest to missing its deadline* (it is the least likely
      to return useful work); requests without deadlines are never chosen,
      and if nothing carries a deadline the policy degrades to "newest".

    The tie-breaks are deterministic (and covered by tests): requests
    with ``deadline=None`` are *never* deadline victims, no matter how
    long they have queued; when every queued request is deadline-free the
    function returns None (reject the newcomer — "newest" semantics);
    and among equal earliest deadlines the **lowest queue index** (the
    oldest submission) is evicted — its latency budget is the most
    spent, matching the "oldest" policy's rationale.

    Pure function over the queue snapshot — the request objects only need
    ``deadline`` (absolute time or None)."""
    if policy not in SHED_POLICIES:
        raise ValueError(f"unknown shed policy {policy!r}; "
                         f"pick one of {SHED_POLICIES}")
    if not pending:
        return None
    if policy == "newest":
        return None
    if policy == "oldest":
        return 0
    best, best_deadline = None, None
    for i, r in enumerate(pending):
        if r.deadline is None:
            continue
        if best_deadline is None or r.deadline < best_deadline:
            best, best_deadline = i, r.deadline
    return best
