"""Inference engine: bind params to a Plan and execute the planned graph.

``compile``/``InferenceSession`` (engine/session.py) is the front door —
plan, bind, specialize per batch size; ``compile_model`` is the lower-level
bind-one-plan entry it rides on; ``params_from_numpy`` (engine/weights.py)
brings numpy parameters onto a device.
"""
from repro_torch.engine.executor import (CompiledModel, bind_params,
                                         compile_model)
from repro_torch.engine.session import InferenceSession, compile
from repro_torch.engine.weights import params_from_numpy

__all__ = ["CompiledModel", "InferenceSession", "bind_params",
           "compile", "compile_model", "params_from_numpy"]
