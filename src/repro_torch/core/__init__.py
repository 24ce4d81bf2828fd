"""The planner: NeoCPU's layout-planned graph optimization.

graph / layout / schedule — the IR; cost — the roofline model on a
``MachineModel``; local_search / global_search / pbqp — the two-stage scheme
search (§3.3); transform_elim — the §3.2 pass; pipeline — the composable
pass pipeline (``Pipeline.preset(mode)`` is the Table-3 ladder); planner —
the deprecated ``plan(mode=...)`` shim over it; calibrate — the measured
search's clock and relayout probe; quantize — the per-output-channel int8
weight codes of ``dtype="int8"`` schedules.
"""
from repro_torch.core.cost import MachineModel
from repro_torch.core.graph import Graph
from repro_torch.core.layout import Layout, LayoutCategory, NCHW, NHWC, nchwc
from repro_torch.core.pipeline import MODES, Pipeline, PipelineReport, Plan
from repro_torch.core.planner import plan
from repro_torch.core.quantize import (dequantize_per_channel,
                                       quantize_per_channel)
from repro_torch.core.schedule import (DTYPES, INT8_VARIANTS, VARIANTS,
                                       ConvSchedule, ConvWorkload)

__all__ = ["ConvSchedule", "ConvWorkload", "DTYPES", "Graph",
           "INT8_VARIANTS", "Layout", "LayoutCategory", "MODES",
           "MachineModel", "NCHW", "NHWC", "Pipeline", "PipelineReport",
           "Plan", "VARIANTS", "dequantize_per_channel", "nchwc", "plan",
           "quantize_per_channel"]
