"""VGG graph builders (Simonyan & Zisserman 2014) — paper Table 2 rows 6-9.

Chain-structured — the case where NeoCPU's exact DP applies trivially and
(per Table 3) global search adds the least over transform elimination.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.graph import Graph

_SPECS = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
_WIDTHS = (64, 128, 256, 512, 512)


def build(depth: int, batch: int = 1, image: int = 224,
          classes: int = 1000) -> Tuple[Graph, Dict[str, Tuple[int, ...]]]:
    g = Graph()
    y = g.add("data", "input")
    cin = 3
    for si, n in enumerate(_SPECS[depth]):
        for ui in range(n):
            y = g.add(f"s{si + 1}c{ui + 1}", "conv2d", [y], in_channels=cin,
                      out_channels=_WIDTHS[si], kh=3, kw=3, pad=1, bias=True)
            y = g.add(f"s{si + 1}r{ui + 1}", "relu", [y])
            cin = _WIDTHS[si]
        y = g.add(f"s{si + 1}_pool", "max_pool", [y], k=2, stride=2)
    y = g.add("flat", "flatten", [y])
    y = g.add("fc6", "dense", [y], units=4096)
    y = g.add("fc6_relu", "relu", [y])
    y = g.add("fc7", "dense", [y], units=4096)
    y = g.add("fc7_relu", "relu", [y])
    y = g.add("fc8", "dense", [y], units=classes)
    y = g.add("prob", "softmax", [y])
    g.mark_output(y)
    return g, {"data": (batch, 3, image, image)}
