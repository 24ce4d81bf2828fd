"""The one generator of the benchmark's open-loop traffic mixes.

A mix is a JSON file beside this one; its ``kind`` is one of the program's
synthetic traces, copied here from ``engine/traffic.py::synth_trace``
(Poisson ``uniform``, on/off ``bursty``, ``diurnal``, Zipf ``heavytail``),
so that the program may change and the yardstick may not.

``"arrivals": "stratified"`` (``uniform`` only) keeps the work of a window
fixed from seed to seed: the gaps are the exponential distribution's
quantiles at (i + 0.5) / n for n = rate x seconds, and the seed only
shuffles their order.  So every seed offers the same requests over the
same span, in another order, and runs of different seeds differ by the
order alone.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

KINDS = ("uniform", "bursty", "diurnal", "heavytail")


def synth_trace(kind: str, *, n: int, seed: int, mean_rate: float,
                max_rows: int) -> List[Tuple[float, int]]:
    """(arrival seconds, rows) of ``n`` requests; the program's draws."""
    if kind not in KINDS:
        raise ValueError(f"unknown trace kind {kind!r}; pick one of {KINDS}")
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    burst_left = 0
    for i in range(n):
        if kind == "uniform":
            t += float(rng.exponential(1.0 / mean_rate))
            rows = int(rng.integers(1, max_rows + 1))
        elif kind == "bursty":
            if burst_left == 0:
                t += float(rng.exponential(8.0 / mean_rate))
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
        else:
            t += float(rng.exponential(1.0 / mean_rate))
            rows = min(max_rows, int(rng.zipf(1.7)))
        out.append((t, rows))
    return out


def arrivals(mix: dict, rate: float, seconds: float,
             seed: int) -> List[Tuple[float, int]]:
    """(due second, rows) of every request of ``mix`` at ``rate`` over
    ``seconds``, from ``seed``."""
    n = max(1, int(round(rate * seconds)))
    seed = int(seed) & ((1 << 63) - 1)
    if mix.get("arrivals") == "stratified":
        if mix["kind"] != "uniform" or mix["max_rows"] != 1:
            raise ValueError("stratified arrivals are Poisson single rows")
        q = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-q) / rate
        gaps *= seconds / gaps.sum()
        np.random.default_rng(seed).shuffle(gaps)
        return [(float(t), 1) for t in np.cumsum(gaps) - gaps[0]]
    trace = synth_trace(mix["kind"], n=n, seed=seed, mean_rate=rate,
                        max_rows=mix["max_rows"])
    return [(t, r) for t, r in trace if t < seconds]
