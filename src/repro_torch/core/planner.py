"""Deprecated planner entry — a thin shim over ``core.pipeline``.

The end-to-end pipeline (local search -> global search -> rewrite, with the
§3.1 fusion rewrites in front for mode "fusion") lives in
``core/pipeline.py`` as composable ``Pass`` objects; ``Pipeline.preset(m)``
reproduces the Table-3 ``MODES`` ladder exactly.  ``plan(mode=...)`` is
kept for the reference's call sites and delegates 1:1:

    plan(g, shapes, mode=m, db=db, transform_bw=bw, machine=mm)
    == Pipeline.preset(m).run(g, shapes, db=db, transform_bw=bw, machine=mm)

The port prices schedules on a ``MachineModel`` where the reference takes a
``runner``.  New code should use ``Pipeline`` directly, or — for the whole
build/tune/bind/predict lifecycle including artifacts —
``repro_torch.engine.compile``.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

from repro_torch.core.cost import H100, MachineModel
from repro_torch.core.graph import Graph
from repro_torch.core.local_search import ScheduleDatabase
# Re-exports: the reference's import surface of this module
from repro_torch.core.pipeline import (MODES, Pipeline, PipelineReport,  # noqa: F401
                                       Plan, conv_dependencies,
                                       make_workload)

_warned = False


def plan(graph: Graph, input_shapes: Dict[str, Tuple[int, ...]],
         mode: str = "global-search",
         db: Optional[ScheduleDatabase] = None,
         uniform_block: int = 128,
         max_pairs: int = 8,
         dp_state_budget: int = 200_000,
         transform_bw: Optional[float] = None,
         machine: MachineModel = H100) -> Plan:
    """Deprecated: use ``Pipeline.preset(mode).run(...)`` or
    ``repro_torch.engine.compile(...)``."""
    global _warned
    if not _warned:
        warnings.warn(
            "core.planner.plan(mode=...) is deprecated; use "
            "core.pipeline.Pipeline.preset(mode).run(graph, shapes, ...) "
            "or engine.compile(...)",
            DeprecationWarning, stacklevel=2)
        _warned = True
    pipeline = Pipeline.preset(mode, uniform_block=uniform_block,
                               max_pairs=max_pairs,
                               dp_state_budget=dp_state_budget)
    return pipeline.run(graph, input_shapes, db=db,
                        transform_bw=transform_bw, machine=machine)
