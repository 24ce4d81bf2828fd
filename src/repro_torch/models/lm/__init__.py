"""LM stack: the six families (dense, moe, ssm, hybrid, encdec, vlm) of
the reference's ``repro/models/lm``."""
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.model import (decode_step, forward, init_cache,
                                         init_params, prefill)

__all__ = ["LMConfig", "decode_step", "forward", "init_cache",
           "init_params", "prefill"]
