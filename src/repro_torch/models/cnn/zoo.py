"""The 15-network zoo of the paper's evaluation (Table 2)."""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

from repro_torch.core.graph import Graph
from repro_torch.models.cnn import densenet, inception, resnet, ssd, vgg

Builder = Callable[..., Tuple[Graph, Dict[str, Tuple[int, ...]]]]

MODELS: Dict[str, Builder] = {
    **{f"resnet-{d}": functools.partial(resnet.build, d)
       for d in (18, 34, 50, 101, 152)},
    **{f"vgg-{d}": functools.partial(vgg.build, d) for d in (11, 13, 16, 19)},
    **{f"densenet-{d}": functools.partial(densenet.build, d)
       for d in (121, 161, 169, 201)},
    "inception-v3": inception.build,
    "ssd-resnet-50": ssd.build,
}


def build(name: str, batch: int = 1, **kw):
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[name](batch=batch, **kw)
