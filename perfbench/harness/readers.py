"""The arithmetic of the per-layer readers (``perfbench/metrics/``).

A reader takes the run (``cell.Run``) and returns its number, or None
where the run holds nothing for it to read; the harness leaves a None out
of the result line.  Shares are in percent.
"""
from __future__ import annotations

import statistics
from typing import Optional, Sequence

from perfbench.harness.costs import PEAK_TF32


def host_enqueue_ms(run) -> Optional[float]:
    """Mean host ms from a ``predict`` call to its return, before any
    synchronise, over the window's predicts."""
    ms = run.window.enqueue_ms
    return statistics.fmean(ms) if ms else None


def idle_share(run) -> Optional[float]:
    """1 - (union of the device's busy intervals) / (traced span)."""
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(run, kernels: Sequence[str]) -> Optional[float]:
    """The ideal time of the network's convs (``costs.Costs``) for every
    predict in the traced span, over the card's time in the kernels named
    ``kernels`` there."""
    t = run.trace
    if not t:
        return None
    card = sum(s for name, s in t["device_s_by_name"].items()
               if any(k in name for k in kernels))
    if card <= 0:
        return None
    ideal = sum(n * run.costs.conv_ideal_s(bucket)
                for bucket, n in t["batches"].items())
    return 100.0 * ideal / card


def mfu(run) -> Optional[float]:
    """The reference's FLOPs for every image completed in the window, over
    the window, over the card's TF32 peak."""
    w = run.window
    if not w.images or w.seconds <= 0:
        return None
    return 100.0 * w.images * run.costs.flops_per_image() / w.seconds \
        / PEAK_TF32


def serve_batch_rows(run) -> Optional[float]:
    s = run.window.serving
    if not s or not s["n_batches"]:
        return None
    return s["rows_executed"] / s["n_batches"]


def serve_padded_share(run) -> Optional[float]:
    s = run.window.serving
    if not s or not s["n_batches"]:
        return None
    return 100.0 * s["rows_padded"] / (s["rows_executed"] + s["rows_padded"])
