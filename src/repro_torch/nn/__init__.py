"""Layout-aware layer library (ops) + parameter init."""
from repro_torch.nn.init import Params, init_params

__all__ = ["Params", "init_params"]
