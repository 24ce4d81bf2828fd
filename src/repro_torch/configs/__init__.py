"""Selectable LM configs: the 10 assigned architectures.  ``ARCHS`` and
``reduced`` are copies of the JAX reference's ``repro/configs``."""
from repro_torch.configs.archs import ARCHS, get, reduced

__all__ = ["ARCHS", "get", "reduced"]
