"""Trainer-fleet fault tolerance: the elastic re-mesh plan and the
straggler batch split — a copy of the reference's
``repro/runtime/fault_tolerance.py`` (pure Python).

``HeartbeatMonitor``, ``StragglerPolicy`` and ``StragglerMitigator`` live in
:mod:`repro_torch.engine.supervision`, whose first consumer is the serving
supervisor; they are re-exported here, as the reference does.  What stays
is the trainer-only logic: :func:`plan_elastic_mesh` and
:func:`rebalanced_batch_split` (its weights are
``StragglerMitigator.batch_weights``).  Checkpoints are stored unsharded,
so a smaller mesh can restore them.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.engine.supervision import (HeartbeatMonitor,
                                            StragglerMitigator,
                                            StragglerPolicy)

__all__ = ["HeartbeatMonitor", "StragglerMitigator", "StragglerPolicy",
           "plan_elastic_mesh", "rebalanced_batch_split"]


# ---------------------------------------------------------------------------
# Elastic mesh planning (trainer demo only)
# ---------------------------------------------------------------------------

def plan_elastic_mesh(n_devices: int, *, model_axis: int,
                      min_data_axis: int = 1) -> Tuple[int, int]:
    """Largest (data, model) grid over the survivors.

    The model axis is preserved if possible (params repartition is the
    expensive dimension); the data axis absorbs the loss — the classic
    elasticity policy.  Falls back to shrinking the model axis by factors
    of 2 when too few devices remain."""
    m = model_axis
    while m > 1:
        d = n_devices // m
        if d >= min_data_axis and d * m <= n_devices:
            return d, m
        m //= 2
    return max(n_devices, 1), 1


def rebalanced_batch_split(global_batch: int, weights: Sequence[float]
                           ) -> List[int]:
    """Split a global batch proportionally to per-host speed weights
    (1/step_time), keeping the total exact — straggler mitigation tier 1."""
    total_w = sum(weights)
    raw = [global_batch * w / total_w for w in weights]
    out = [int(r) for r in raw]
    rem = global_batch - sum(out)
    # hand remainders to the fastest hosts
    order = sorted(range(len(weights)), key=lambda i: -weights[i])
    for i in range(rem):
        out[order[i % len(order)]] += 1
    return out
