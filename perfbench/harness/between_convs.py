"""The work between the convs: what the program's plan counts of it, and
the card's time in it.

``plan_gb`` reads the note on the ``plan`` span (``repro_torch.trace``'s
process recorder) of the ``specialize`` of the window's batch: the bytes
of the plan's relayouts, standalone BN and ReLU, and concat seeds, each
node's output read once and written once in fp32.  ``card_ms`` reads the
traced span: the card's time in every operation that is neither a B1
kernel nor a copy between host and device nor a memset.  Each returns
None where the run holds nothing for it (a program whose ``plan`` span
has no such note, a run without a trace).
"""
from __future__ import annotations

from typing import Optional

from perfbench.harness.profiling import B1_KERNEL

PLAN_BYTES = ("relayout_bytes", "eltwise_bytes", "concat_seed_bytes")
HOST_OPS = ("Memcpy HtoD", "Memcpy DtoH", "Memset")


def plan_note(batch: int) -> Optional[dict]:
    """The note of the last ``plan`` span under a ``specialize`` of
    ``batch`` that counts the work between the convs, or None."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    rec = trace.recorder()
    rows = rec.spans()
    by_index = {r.index: r for r in rows}
    found = None
    for r in rows:
        up = by_index.get(r.parent)
        if r.kind != "plan" or up is None or up.kind != "specialize" \
                or up.arg != batch:
            continue
        note = rec.notes.get(r.index, {})
        if all(k in note for k in PLAN_BYTES):
            found = note
    return found


def plan_gb(run) -> Optional[float]:
    """GB a batch of the window's largest batch that its plan moves
    between the convs."""
    if not run.window.images or not run.window.batches:
        return None
    note = plan_note(max(run.window.batches))
    if note is None:
        return None
    return sum(note[k] for k in PLAN_BYTES) / 1e9


def card_ms(run) -> Optional[float]:
    """The card's ms a batch of the traced span outside B1's kernels and
    the host's copies and memsets."""
    t = run.trace
    if not t or not t.get("batches"):
        return None
    batches = sum(t["batches"].values())
    if batches <= 0:
        return None
    s = sum(sec for name, sec in t["device_s_by_name"].items()
            if B1_KERNEL not in name and not name.startswith(HOST_OPS))
    return s * 1e3 / batches
