"""Parameters from numpy: the bridge that feeds both packages one set of
weights, for the CNN graphs and for the LMs."""
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


def lm_params_from_numpy(tree: Any, device="cuda") -> Any:
    """The reference's LM parameter pytree (nested dicts whose layer leaves
    are stacked on a leading layer axis, or lists of per-layer dicts for
    the hybrid and encdec families; arrays numpy can read, such as
    ``repro.models.lm.init_params`` output) as the port's tensors on
    ``device``, in the same tree, values and types unchanged.  numpy has
    no bfloat16, so a bf16 leaf travels as float32 and is cast back."""
    if isinstance(tree, Mapping):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_from_numpy(v, device) for v in tree]
    if str(getattr(tree, "dtype", "")) == "bfloat16":
        t = torch.tensor(np.asarray(tree, np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(np.array(tree))
    return t.to(device)
