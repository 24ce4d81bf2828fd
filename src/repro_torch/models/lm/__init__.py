"""LM stack: the ``dense``, ``moe`` and ``ssm`` families of the reference's
``repro/models/lm`` (the others wait for ROADMAP A8)."""
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.model import (decode_step, forward, init_cache,
                                         init_params, prefill)

__all__ = ["LMConfig", "decode_step", "forward", "init_cache",
           "init_params", "prefill"]
