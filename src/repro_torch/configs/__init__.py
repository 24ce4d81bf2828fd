"""Selectable LM configs: the 10 assigned architectures.  ``ARCHS`` and
``reduced`` are copies of the JAX reference's ``repro/configs``; the
shapes of the dry run's cells are in ``configs/shapes.py``."""
from repro_torch.configs.archs import ARCHS, get, reduced
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, applicable,
                                        input_specs)

__all__ = ["ARCHS", "get", "reduced", "SHAPES", "ShapeSpec",
           "applicable", "input_specs"]
