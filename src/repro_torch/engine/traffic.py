"""Traffic modeling: the bucket-set solvers, copied from the reference's
``repro/engine/traffic.py``.

A request of ``s`` rows executes through the smallest specialized bucket
``b >= s`` and pays ``b - s`` padded rows, so the optimal bucket set for a
size histogram is an exact 1-D k-segmentation (:func:`solve_buckets`).  LM
prefill buckets truncate *down* instead — a prompt prefills the largest
bucket ``<=`` its length and catches up the rest through decode — and
:func:`solve_seq_buckets` solves them by reflection.
``compile_lm(seq_buckets="auto")`` uses it.  Priority classes and trace
synthesis wait for the serving slice (ROADMAP A7).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Union

from repro_torch.engine.telemetry import SizeHistogram

__all__ = [
    "expected_padded_waste",
    "expected_catchup_tokens",
    "solve_buckets",
    "solve_seq_buckets",
]


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
