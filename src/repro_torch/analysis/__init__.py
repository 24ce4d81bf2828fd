"""Roofline analysis on the H100: the aten-op FLOP counter
(``analysis/flops.py``) and the roofline terms (``analysis/roofline.py``)."""
from repro_torch.analysis.flops import count_costs
from repro_torch.analysis.roofline import (RooflineReport, model_bytes,
                                           model_flops)

__all__ = ["RooflineReport", "count_costs", "model_bytes", "model_flops"]
