"""The planner: NeoCPU's layout-planned graph optimization.

graph / layout / schedule — the IR; cost — the roofline model on a
``MachineModel``; local_search / global_search / pbqp — the two-stage scheme
search (§3.3); transform_elim — the §3.2 pass; pipeline — the composable
pass pipeline (``Pipeline.preset(mode)`` is the Table-3 ladder).
"""
from repro_torch.core.cost import MachineModel
from repro_torch.core.graph import Graph
from repro_torch.core.layout import Layout, LayoutCategory, NCHW, NHWC, nchwc
from repro_torch.core.pipeline import MODES, Pipeline, PipelineReport, Plan
from repro_torch.core.schedule import ConvSchedule, ConvWorkload

__all__ = ["ConvSchedule", "ConvWorkload", "Graph", "Layout",
           "LayoutCategory", "MODES", "MachineModel", "NCHW", "NHWC",
           "Pipeline", "PipelineReport", "Plan", "nchwc"]
