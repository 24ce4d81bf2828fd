"""Bounded streaming statistics for serving: ``SizeHistogram``, a copy of
the reference's (``repro/engine/telemetry.py``).  ``LMSession.traffic``
records prompt lengths in one.  The quantile estimators wait for the
serving slice (ROADMAP A7).

:class:`SizeHistogram` — integer-size histogram under a fixed bin budget.
Counts are exact while distinct sizes fit the budget; on overflow the two
closest bins merge *upward* into the larger size, so the histogram only
ever over-estimates request sizes (and therefore padded waste) — the
conservative direction for bucket planning.  Totals (``n``, ``rows``) are
tracked separately and stay exact.  Thread-safe (one internal lock).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["SizeHistogram"]


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
