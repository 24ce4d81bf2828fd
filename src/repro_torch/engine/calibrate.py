"""Engine-facing alias for the calibration probe.

The implementation lives in ``repro_torch.core.calibrate`` (the pipeline's
``GlobalLayoutPlan`` pass invokes it, and core must not depend on the
engine package); sessions and scripts import it from here.
"""
from repro_torch.core.calibrate import measure_host_copy_bw

__all__ = ["measure_host_copy_bw"]
