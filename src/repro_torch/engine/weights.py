"""Parameters from numpy: the bridge that feeds both packages one set of
weights."""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.nn.init import Params


def params_from_numpy(params: Mapping[str, Mapping[str, Any]],
                      device="cuda") -> Params:
    """``{node: {leaf: array}}`` logical parameters (numpy arrays, or any
    array numpy can read, such as the JAX reference's ``init_params``
    output) as the port's tensors on ``device``, values unchanged."""
    return {node: {leaf: torch.tensor(np.array(v), device=device)
                   for leaf, v in leaves.items()}
            for node, leaves in params.items()}
