"""The CNN zoo the port runs so far: the ResNet rows of the paper's Table 2.

The other families (VGG, DenseNet, Inception, SSD) wait for a later slice
of the port (ROADMAP queue A)."""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

from repro_torch.core.graph import Graph
from repro_torch.models.cnn import resnet

Builder = Callable[..., Tuple[Graph, Dict[str, Tuple[int, ...]]]]

MODELS: Dict[str, Builder] = {
    f"resnet-{d}": functools.partial(resnet.build, d)
    for d in (18, 34, 50, 101, 152)
}


def build(name: str, batch: int = 1, **kw):
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[name](batch=batch, **kw)
