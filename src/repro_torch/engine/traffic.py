"""Traffic modeling: the bucket-set solvers, copied from the reference's
``repro/engine/traffic.py``.

A request of ``s`` rows executes through the smallest specialized bucket
``b >= s`` and pays ``b - s`` padded rows, so the optimal bucket set for a
size histogram is an exact 1-D k-segmentation (:func:`solve_buckets`).  LM
prefill buckets truncate *down* instead — a prompt prefills the largest
bucket ``<=`` its length and catches up the rest through decode — and
:func:`solve_seq_buckets` solves them by reflection.
``compile_lm(seq_buckets="auto")`` uses it.

Priority classes: a request carries one of :data:`PRIORITY_CLASSES`
(``interactive`` < ``standard`` < ``batch`` in rank; the lower rank packs
first under ``DynamicBatchPolicy(order="edf")`` when deadlines tie).
:func:`synth_trace` draws the deterministic uniform, bursty, diurnal and
heavy-tailed request streams the serving phase replays, from one
``np.random.default_rng(seed)``, so a seed gives the reference's trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.engine.telemetry import SizeHistogram

__all__ = [
    "PRIORITY_CLASSES",
    "DEFAULT_PRIORITY",
    "priority_rank",
    "expected_padded_waste",
    "expected_catchup_tokens",
    "solve_buckets",
    "solve_seq_buckets",
    "TraceRequest",
    "TRACE_KINDS",
    "synth_trace",
]


# ---------------------------------------------------------------------------
# Priority classes
# ---------------------------------------------------------------------------

#: Deadline/priority classes in rank order: lower rank packs first when
#: deadlines tie (or are absent) under ``order="edf"``.
PRIORITY_CLASSES: Tuple[str, ...] = ("interactive", "standard", "batch")

DEFAULT_PRIORITY = "standard"


def priority_rank(priority: str) -> int:
    """Rank of a priority class (0 = most urgent).  Typed rejection for
    unknown classes happens here, at submission time."""
    try:
        return PRIORITY_CLASSES.index(priority)
    except ValueError:
        raise ValueError(
            f"unknown priority class {priority!r}; "
            f"pick one of {PRIORITY_CLASSES}") from None


# ---------------------------------------------------------------------------
# Histogram coercion
# ---------------------------------------------------------------------------

HistLike = Union[SizeHistogram, Mapping[int, int], "object"]


def _coerce_counts(hist: HistLike) -> Dict[int, int]:
    """Accept a SizeHistogram, a plain ``{size: count}`` mapping, or
    anything exposing ``.arrival_hist`` (e.g. ``ServingStats``)."""
    if isinstance(hist, SizeHistogram):
        return hist.counts()
    arrival = getattr(hist, "arrival_hist", None)
    if isinstance(arrival, SizeHistogram):
        return arrival.counts()
    if isinstance(hist, Mapping):
        out: Dict[int, int] = {}
        for s, c in hist.items():
            s, c = int(s), int(c)
            if s < 1:
                raise ValueError(f"sizes must be >= 1, got {s}")
            if c < 0:
                raise ValueError(f"counts must be >= 0, got {c}")
            if c:
                out[s] = out.get(s, 0) + c
        return out
    raise TypeError(f"cannot read a size histogram from {type(hist).__name__}")


# ---------------------------------------------------------------------------
# Expected padded waste + the bucket-set solver
# ---------------------------------------------------------------------------

def expected_padded_waste(hist: HistLike, buckets: Sequence[int]) -> int:
    """Total padded rows serving ``hist`` through ``buckets``: each size
    pays ``(smallest bucket >= size) - size`` per observation.  Sizes
    above the largest bucket pad to themselves (the server specializes
    unseen sizes on demand for non-frozen sessions; frozen sessions
    reject them at submit), so they contribute zero waste here — compare
    bucket sets on distributions they both cover."""
    counts = _coerce_counts(hist)
    bs = sorted(set(int(b) for b in buckets))
    if any(b < 1 for b in bs):
        raise ValueError(f"buckets must be >= 1, got {buckets}")
    waste = 0
    for s, c in counts.items():
        up = [b for b in bs if b >= s]
        if up:
            waste += (min(up) - s) * c
    return waste


def solve_buckets(hist: HistLike, *, max_buckets: int = 8,
                  spec_cost: Union[float, str] = "auto",
                  devices: int = 1) -> List[int]:
    """Bucket set minimizing ``padded_waste + spec_cost * n_buckets``.

    Exact dynamic program over the sorted observed sizes (optimal
    buckets are a subset of observed sizes — optimal 1-D
    k-segmentation), trying every bucket count up to ``max_buckets`` and
    keeping the best total.  The largest observed size is always a
    bucket, so the learned set covers every recorded request.

    ``spec_cost`` prices one extra specialization in padded-row units;
    ``"auto"`` charges 1% of the observed rows (so a bucket must save at
    least that much padding to earn its compile time and resident
    params).  ``devices > 1`` rounds each bucket up to a multiple of the
    device count (sharded programs split the batch dim evenly)."""
    counts = _coerce_counts(hist)
    if not counts:
        raise ValueError("empty histogram: no recorded traffic to solve "
                         "a bucket set from")
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    sizes = sorted(counts)
    cnt = [counts[s] for s in sizes]
    k = len(sizes)
    total_rows = sum(s * c for s, c in counts.items())
    lam = (max(1.0, 0.01 * total_rows) if spec_cost == "auto"
           else float(spec_cost))
    if lam < 0:
        raise ValueError(f"spec_cost must be >= 0, got {spec_cost}")

    # prefix sums: C[i] = sum(cnt[:i]), R[i] = sum(sizes*cnt[:i])
    C = [0] * (k + 1)
    R = [0] * (k + 1)
    for i in range(k):
        C[i + 1] = C[i] + cnt[i]
        R[i + 1] = R[i] + sizes[i] * cnt[i]

    def seg_cost(i: int, j: int) -> int:
        """Padded waste of serving sizes[i..j] through bucket sizes[j]."""
        return sizes[j] * (C[j + 1] - C[i]) - (R[j + 1] - R[i])

    m_max = min(max_buckets, k)
    INF = float("inf")
    # W[m][j] = min waste covering sizes[0..j-1] with m buckets
    W = [[INF] * (k + 1) for _ in range(m_max + 1)]
    arg = [[-1] * (k + 1) for _ in range(m_max + 1)]
    W[0][0] = 0.0
    for m in range(1, m_max + 1):
        for j in range(1, k + 1):
            best, best_i = INF, -1
            for i in range(m - 1, j):
                if W[m - 1][i] == INF:
                    continue
                c = W[m - 1][i] + seg_cost(i, j - 1)
                if c < best:
                    best, best_i = c, i
            W[m][j] = best
            arg[m][j] = best_i

    best_m, best_total = 1, INF
    for m in range(1, m_max + 1):
        total = W[m][k] + lam * m
        if total < best_total:
            best_m, best_total = m, total

    # reconstruct: each group's bucket is its largest member
    buckets: List[int] = []
    j = k
    for m in range(best_m, 0, -1):
        i = arg[m][j]
        buckets.append(sizes[j - 1])
        j = i
    buckets.reverse()

    if devices > 1:
        buckets = sorted({int(math.ceil(b / devices)) * devices
                          for b in buckets})
    return buckets


def expected_catchup_tokens(hist: HistLike,
                            buckets: Sequence[int]) -> int:
    """Total decode catch-up tokens serving prompt-length ``hist``
    through prefix ``buckets``: each prompt pays
    ``len - (largest bucket <= len)`` single-token decode steps.
    Prompts below the smallest bucket run entirely through decode
    (bucket 0)."""
    counts = _coerce_counts(hist)
    bs = sorted(set(int(b) for b in buckets))
    if any(b < 1 for b in bs):
        raise ValueError(f"buckets must be >= 1, got {buckets}")
    tokens = 0
    for s, c in counts.items():
        down = [b for b in bs if b <= s]
        tokens += (s - max(down)) * c if down else s * c
    return tokens


def solve_seq_buckets(hist: HistLike, *, max_buckets: int = 8,
                      spec_cost: Union[float, str] = "auto") -> List[int]:
    """Sequence-length bucket set for LM prefill, minimizing decode
    catch-up ``tokens + spec_cost * n_buckets``.

    Batch buckets pad *up* (a padded row is wasted compute); prefill
    buckets truncate *down* — right-padding a prompt corrupts recurrent
    state (SSM/LRU layers) and windowed KV rings, so an LM session
    prefillls the largest bucket **<=** the prompt and catches the
    remaining tokens up through the (already specialized) decode
    program, at one decode step per leftover token.

    That mirror image reduces to the batch solver by reflection: map
    each observed length ``s`` to ``M + 1 - s`` (``M`` the longest
    observed prompt), run the exact padded-waste DP, and reflect the
    bucket set back.  ``smallest bucket >= reflected size`` becomes
    ``largest bucket <= s``, and the reflected padded waste
    ``(bucket' - size')`` equals the catch-up step count ``s - b``
    token for token.  A sentinel reflected size ``M + 1`` — the mirror
    of the always-available empty prefix (bucket 0, pure decode) —
    rides along so the DP may leave short prompts to full decode when
    a dedicated short bucket is not worth its specialization; since
    the DP always keeps its largest size as a bucket, every candidate
    set carries the sentinel and its cost cancels.  The result may
    therefore be *empty* (serve everything through decode); it never
    contains 0 itself."""
    counts = _coerce_counts(hist)
    if not counts:
        raise ValueError("empty histogram: no recorded prompt lengths to "
                         "solve a seq-bucket set from")
    m = max(counts)
    reflected = {m + 1 - s: c for s, c in counts.items()}
    reflected[m + 1] = reflected.get(m + 1, 0) + 1      # bucket-0 sentinel
    rb = solve_buckets(reflected, max_buckets=max_buckets + 1,
                       spec_cost=spec_cost)
    return sorted(m + 1 - b for b in rb if b != m + 1)


# ---------------------------------------------------------------------------
# Synthetic traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One request of a synthetic trace: arrival time (seconds from the
    trace start), request rows, and serving metadata."""

    t: float
    rows: int
    tenant: str = "default"
    priority: str = DEFAULT_PRIORITY
    deadline_ms: Optional[float] = None


TRACE_KINDS: Tuple[str, ...] = ("uniform", "bursty", "diurnal", "heavytail")


def synth_trace(kind: str, *, n: int, seed: int = 0,
                mean_rate: float = 200.0, max_rows: int = 8,
                tenants: Sequence[str] = ("default",),
                priorities: Sequence[str] = (DEFAULT_PRIORITY,),
                deadline_ms: Optional[float] = None) -> List[TraceRequest]:
    """Deterministic synthetic request stream.

    Kinds (all seeded through one ``np.random.default_rng``):

    * ``uniform`` — Poisson arrivals at ``mean_rate`` req/s, sizes
      uniform in [1, max_rows].
    * ``bursty`` — on/off Markov arrivals: bursts at 5x the mean rate
      separated by quiet gaps; sizes skew small (most traffic is
      single-image requests, bursts carry the larger ones).
    * ``diurnal`` — sinusoidal rate swinging 10x between trough and
      peak over the trace (a compressed day); sizes uniform.
    * ``heavytail`` — Zipf-distributed sizes (mostly 1, rare large)
      at Poisson arrivals — the distribution bucket learning wins on.

    Tenants and priorities round-robin deterministically so multi-tenant
    replays exercise every queue.  ``deadline_ms``, when set, attaches a
    deadline to the interactive-priority requests only (batch work is
    deadline-free, exercising the shed tie-breaks)."""
    if kind not in TRACE_KINDS:
        raise ValueError(f"unknown trace kind {kind!r}; "
                         f"pick one of {TRACE_KINDS}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    rng = np.random.default_rng(seed)
    out: List[TraceRequest] = []
    t = 0.0
    burst_left = 0
    for i in range(n):
        if kind == "uniform":
            t += float(rng.exponential(1.0 / mean_rate))
            rows = int(rng.integers(1, max_rows + 1))
        elif kind == "bursty":
            if burst_left == 0:
                t += float(rng.exponential(8.0 / mean_rate))  # quiet gap
                burst_left = int(rng.integers(3, 12))
            t += float(rng.exponential(1.0 / (5.0 * mean_rate)))
            burst_left -= 1
            rows = 1 if rng.random() < 0.7 else \
                int(rng.integers(2, max_rows + 1))
        elif kind == "diurnal":
            phase = 2.0 * math.pi * i / n
            rate = mean_rate * (0.55 + 0.45 * math.sin(phase))
            t += float(rng.exponential(1.0 / max(rate, mean_rate / 10.0)))
            rows = int(rng.integers(1, max_rows + 1))
        else:                            # heavytail
            t += float(rng.exponential(1.0 / mean_rate))
            rows = min(max_rows, int(rng.zipf(1.7)))
        tenant = tenants[i % len(tenants)]
        priority = priorities[i % len(priorities)]
        dl = (deadline_ms if deadline_ms is not None
              and priority == "interactive" else None)
        out.append(TraceRequest(t=t, rows=rows, tenant=tenant,
                                priority=priority, deadline_ms=dl))
    return out
