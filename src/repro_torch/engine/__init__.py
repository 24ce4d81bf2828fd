"""Inference engine: bind params to a Plan and execute the planned graph,
or serve an LM.

``compile``/``InferenceSession`` (engine/session.py) is the front door —
plan, bind, specialize per batch size, ``save`` and ``load`` the
reference's version-5 artifact (``Session`` is its short alias); ``compile_model`` is the lower-level
bind-one-plan entry it rides on.  An LM name or ``LMConfig`` goes to
``compile_lm``/``LMSession`` (engine/lm_session.py): seq-bucketed prefill
and greedy decode.  ``params_from_numpy`` and ``lm_params_from_numpy``
(engine/weights.py) bring numpy parameters onto a device.
"""
from repro_torch.engine.executor import (CompiledModel, bind_params,
                                         compile_model)
from repro_torch.engine.lm_session import LMSession, compile_lm
from repro_torch.engine.session import (SESSION_DTYPES, ArtifactCorruptError,
                                        ArtifactError, InferenceSession,
                                        Session, UnverifiedArtifactWarning,
                                        compile)
from repro_torch.engine.weights import lm_params_from_numpy, params_from_numpy

__all__ = ["ArtifactCorruptError", "ArtifactError", "CompiledModel",
           "InferenceSession", "LMSession", "SESSION_DTYPES", "Session",
           "UnverifiedArtifactWarning", "bind_params",
           "compile", "compile_lm", "compile_model", "lm_params_from_numpy",
           "params_from_numpy"]
