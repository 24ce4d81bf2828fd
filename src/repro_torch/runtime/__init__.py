"""Fault tolerance and gradient compression for the trainer."""
from repro_torch.runtime import compression
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 StragglerMitigator,
                                                 StragglerPolicy,
                                                 plan_elastic_mesh,
                                                 rebalanced_batch_split)

__all__ = ["compression", "HeartbeatMonitor", "StragglerMitigator",
           "StragglerPolicy", "plan_elastic_mesh",
           "rebalanced_batch_split"]
