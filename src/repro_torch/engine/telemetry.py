"""Bounded streaming statistics for serving, copies of the reference's
(``repro/engine/telemetry.py``): ``SizeHistogram``, ``P2Quantile`` and
``StreamingQuantiles``.  ``LMSession.traffic`` records prompt lengths in a
histogram; ``ServingStats`` (engine/serving.py) keeps request sizes in
histograms and latencies in streaming quantiles.

:class:`SizeHistogram` — integer-size histogram under a fixed bin budget.
Counts are exact while distinct sizes fit the budget; on overflow the two
closest bins merge *upward* into the larger size, so the histogram only
ever over-estimates request sizes (and therefore padded waste) — the
conservative direction for bucket planning.  Totals (``n``, ``rows``) are
tracked separately and stay exact.  Thread-safe (one internal lock).

:class:`P2Quantile` — Jain & Chlamtac's P² estimator of one quantile in
five markers.  :class:`StreamingQuantiles` — count, mean, min, max and
tracked quantiles in O(1) memory: exact from a sorted buffer for the first
``exact_n`` observations, P² past it.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["SizeHistogram", "P2Quantile", "StreamingQuantiles"]


class SizeHistogram:
    """Histogram of integer sizes under a fixed bin budget.

    ``add(size, count)`` is O(log bins) amortized.  While distinct sizes
    fit ``max_bins`` the counts are exact.  Past the budget, the pair of
    adjacent bins with the smallest gap is merged into the *larger* size
    (ties: the lowest pair), so a collapsed histogram rounds sizes up —
    a bucket set solved from it still covers every real request, it just
    may pad slightly more than the true optimum.  ``n`` (observations)
    and ``rows`` (sum of sizes, pre-merge) stay exact regardless."""

    def __init__(self, max_bins: int = 64) -> None:
        if max_bins < 2:
            raise ValueError(f"max_bins must be >= 2, got {max_bins}")
        self.max_bins = max_bins
        self._counts: Dict[int, int] = {}
        self._n = 0
        self._rows = 0
        self._collapsed = 0          # merge operations performed
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------
    def add(self, size: int, count: int = 1) -> None:
        size = int(size)
        if size < 0:
            raise ValueError(f"size must be >= 0, got {size}")
        if count <= 0:
            return
        with self._lock:
            self._counts[size] = self._counts.get(size, 0) + count
            self._n += count
            self._rows += size * count
            while len(self._counts) > self.max_bins:
                self._merge_closest_locked()

    def _merge_closest_locked(self) -> None:
        sizes = sorted(self._counts)
        best_i, best_gap = 0, None
        for i in range(len(sizes) - 1):
            gap = sizes[i + 1] - sizes[i]
            if best_gap is None or gap < best_gap:
                best_i, best_gap = i, gap
        lo, hi = sizes[best_i], sizes[best_i + 1]
        self._counts[hi] += self._counts.pop(lo)   # round *up*: conservative
        self._collapsed += 1

    def merge(self, other: "SizeHistogram") -> None:
        """Fold another histogram's bins into this one."""
        for size, count in other.counts().items():
            self.add(size, count)

    # -- reading ------------------------------------------------------------
    @property
    def n(self) -> int:
        """Total observations (exact, unaffected by bin merging)."""
        with self._lock:
            return self._n

    @property
    def rows(self) -> int:
        """Sum of observed sizes (exact, unaffected by bin merging)."""
        with self._lock:
            return self._rows

    @property
    def collapsed(self) -> int:
        with self._lock:
            return self._collapsed

    def counts(self) -> Dict[int, int]:
        """Detached ``{size: count}`` snapshot, sorted by size."""
        with self._lock:
            return {s: self._counts[s] for s in sorted(self._counts)}

    @property
    def max_size(self) -> Optional[int]:
        with self._lock:
            return max(self._counts) if self._counts else None

    def percentile(self, q: float) -> Optional[int]:
        """Smallest size with cumulative share >= q (q in [0, 100])."""
        with self._lock:
            if not self._counts:
                return None
            target = self._n * q / 100.0
            acc = 0
            for s in sorted(self._counts):
                acc += self._counts[s]
                if acc >= target:
                    return s
            return max(self._counts)

    def state_size(self) -> int:
        with self._lock:
            return len(self._counts)

    def copy(self) -> "SizeHistogram":
        out = SizeHistogram(self.max_bins)
        with self._lock:
            out._counts = dict(self._counts)
            out._n = self._n
            out._rows = self._rows
            out._collapsed = self._collapsed
        return out

    def to_json(self) -> dict:
        with self._lock:
            return {
                "counts": {str(s): self._counts[s]
                           for s in sorted(self._counts)},
                "n": self._n,
                "rows": self._rows,
                "max_bins": self.max_bins,
                "collapsed": self._collapsed,
            }

    def __len__(self) -> int:
        return self.state_size()

    def __repr__(self) -> str:
        return (f"SizeHistogram(n={self.n}, rows={self.rows}, "
                f"bins={self.state_size()}/{self.max_bins})")


# ---------------------------------------------------------------------------
# P-squared single-quantile estimator
# ---------------------------------------------------------------------------

class P2Quantile:
    """Jain & Chlamtac's P² algorithm: estimate one quantile of a stream
    with five markers and no stored samples.  Exact for the first five
    observations; afterwards the middle marker tracks the quantile via
    piecewise-parabolic marker adjustment."""

    __slots__ = ("q", "_init", "_h", "_n", "_np", "_dn")

    def __init__(self, q: float) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"q must be in (0, 1), got {q}")
        self.q = q
        self._init: List[float] = []
        self._h: Optional[List[float]] = None    # marker heights
        self._n: List[float] = []                # marker positions
        self._np: List[float] = []               # desired positions
        self._dn = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    @property
    def count(self) -> int:
        if self._h is None:
            return len(self._init)
        return int(self._n[4])

    def add(self, x: float) -> None:
        x = float(x)
        if self._h is None:
            self._init.append(x)
            if len(self._init) == 5:
                self._init.sort()
                self._h = list(self._init)
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._np = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q,
                            3.0 + 2.0 * q, 5.0]
                self._init = []
            return
        h, n = self._h, self._n
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if x >= h[i]:
                    k = i
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if ((d >= 1.0 and n[i + 1] - n[i] > 1.0)
                    or (d <= -1.0 and n[i - 1] - n[i] < -1.0)):
                sign = 1.0 if d >= 0 else -1.0
                hp = self._parabolic(i, sign)
                if not h[i - 1] < hp < h[i + 1]:
                    hp = self._linear(i, sign)
                h[i] = hp
                n[i] += sign

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._h, self._n
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, n = self._h, self._n
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    def value(self) -> float:
        if self._h is not None:
            return self._h[2]
        if not self._init:
            return float("nan")
        s = sorted(self._init)
        idx = min(len(s) - 1, max(0, round(self.q * (len(s) - 1))))
        return s[idx]

    def copy(self) -> "P2Quantile":
        out = P2Quantile(self.q)
        out._init = list(self._init)
        out._h = None if self._h is None else list(self._h)
        out._n = list(self._n)
        out._np = list(self._np)
        return out

    def state_size(self) -> int:
        return len(self._init) + (0 if self._h is None else 15)


# ---------------------------------------------------------------------------
# Multi-quantile summary
# ---------------------------------------------------------------------------

class StreamingQuantiles:
    """O(1)-memory latency summary: count/mean/min/max plus tracked
    quantiles.  The first ``exact_n`` observations are kept in a sorted
    buffer, so small-sample quantiles (every deterministic unit test,
    every short benchmark) are *exact*; past that the buffer is dropped
    and the P² markers — fed every observation since the first — answer.
    ``quantile(q)`` for an untracked q interpolates between the tracked
    markers (min/max anchor 0 and 1)."""

    DEFAULT_QS = (0.5, 0.9, 0.99)

    def __init__(self, qs: Sequence[float] = DEFAULT_QS,
                 exact_n: int = 128) -> None:
        if not qs:
            raise ValueError("need at least one tracked quantile")
        self.qs: Tuple[float, ...] = tuple(sorted(float(q) for q in qs))
        self.exact_n = int(exact_n)
        self._buf: Optional[List[float]] = []
        self._est = {q: P2Quantile(q) for q in self.qs}
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------
    def add(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self._count += 1
            self._sum += x
            self._min = min(self._min, x)
            self._max = max(self._max, x)
            for est in self._est.values():
                est.add(x)
            if self._buf is not None:
                self._buf.append(x)
                if len(self._buf) > self.exact_n:
                    self._buf = None       # estimator phase from here on

    def extend(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.add(x)

    # -- reading ------------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else float("nan")

    @property
    def min(self) -> float:
        with self._lock:
            return self._min if self._count else float("nan")

    @property
    def max(self) -> float:
        with self._lock:
            return self._max if self._count else float("nan")

    @property
    def exact(self) -> bool:
        """True while quantiles come from the exact sorted buffer."""
        with self._lock:
            return self._buf is not None

    def quantile(self, q: float) -> float:
        """Quantile estimate for q in [0, 1]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        if self._count == 0:
            return float("nan")
        if self._buf is not None:
            s = sorted(self._buf)
            pos = q * (len(s) - 1)
            lo = int(pos)
            hi = min(lo + 1, len(s) - 1)
            frac = pos - lo
            return s[lo] * (1.0 - frac) + s[hi] * frac
        # estimator phase: anchor on min/max and the tracked markers
        pts = [(0.0, self._min)]
        pts += [(tq, self._est[tq].value()) for tq in self.qs]
        pts.append((1.0, self._max))
        for (q0, v0), (q1, v1) in zip(pts, pts[1:]):
            if q0 <= q <= q1:
                if q1 == q0:
                    return v1
                frac = (q - q0) / (q1 - q0)
                return v0 * (1.0 - frac) + v1 * frac
        return pts[-1][1]

    def percentile(self, p: float) -> float:
        """Quantile by percent (p in [0, 100])."""
        return self.quantile(p / 100.0)

    def state_size(self) -> int:
        with self._lock:
            n = 4 + (len(self._buf) if self._buf is not None else 0)
            n += sum(est.state_size() for est in self._est.values())
            return n

    def copy(self) -> "StreamingQuantiles":
        out = StreamingQuantiles(self.qs, self.exact_n)
        with self._lock:
            out._buf = None if self._buf is None else list(self._buf)
            out._est = {q: est.copy() for q, est in self._est.items()}
            out._count = self._count
            out._sum = self._sum
            out._min = self._min
            out._max = self._max
        return out

    def to_json(self) -> dict:
        with self._lock:
            out = {
                "count": self._count,
                "mean": self._sum / self._count if self._count else None,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "exact": self._buf is not None,
            }
            for q in self.qs:
                out[f"p{round(q * 100)}"] = self._quantile_locked(q)
            return out

    def __repr__(self) -> str:
        return (f"StreamingQuantiles(count={self.count}, "
                f"qs={self.qs}, exact={self.exact})")
