"""Parameter initialization for graph models.

Parameters live in the *logical* layouts (KCRS conv weights, per-channel BN
vectors); the engine pre-transforms them to the planner's physical layouts
at bind time, mirroring §3.2's compile-time weight transformation.

The draws are the JAX reference's (``repro/nn/init.py``): the same numpy
``default_rng(seed)`` calls in the same order, cast to float32 the same
way, so both packages build bit-identical parameters from one seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.graph import Graph

Params = Dict[str, Dict[str, torch.Tensor]]


def init_params(graph: Graph, input_shapes=None, seed: int = 0,
                device="cuda") -> Params:
    """He-normal conv/dense weights; BN folded to non-trivial scale/shift so
    planned-vs-unplanned equivalence tests exercise real numerics.  Tensors
    are float32 on ``device``."""
    if input_shapes is not None:
        graph.infer_shapes(input_shapes)
    rng = np.random.default_rng(seed)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    params: Params = {}
    for node in graph.topo_order():
        a = node.attrs
        if node.op == "conv2d":
            cin = a["in_channels"] // a.get("groups", 1)
            fan_in = cin * a["kh"] * a["kw"]
            w = rng.normal(0, np.sqrt(2.0 / fan_in),
                           size=(a["out_channels"], cin, a["kh"], a["kw"]))
            p = {"w": t(w)}
            if a.get("bias"):
                p["b"] = t(rng.normal(0, 0.01, size=(a["out_channels"],)))
            params[node.name] = p
        elif node.op == "batch_norm":
            c = node.shape[1] if node.shape else a["channels"]
            params[node.name] = {
                "scale": t(rng.uniform(0.5, 1.5, size=(c,))),
                "shift": t(rng.normal(0, 0.1, size=(c,))),
            }
        elif node.op == "dense":
            din = graph.nodes[node.inputs[0]].shape[1]
            w = rng.normal(0, np.sqrt(2.0 / din), size=(din, a["units"]))
            params[node.name] = {
                "w": t(w),
                "b": t(np.zeros(a["units"])),
            }
    return params
