"""ResNet v1 graph builders (He et al. 2016) — paper Table 2 rows 1-5."""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.graph import Graph

# variant -> (block kind, per-stage unit counts)
_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _conv_bn_relu(g: Graph, name: str, x: str, cin: int, cout: int, k: int,
                  stride: int = 1, pad: int = 0, relu: bool = True) -> str:
    c = g.add(f"{name}_conv", "conv2d", [x], in_channels=cin,
              out_channels=cout, kh=k, kw=k, stride=stride, pad=pad)
    b = g.add(f"{name}_bn", "batch_norm", [c])
    if relu:
        return g.add(f"{name}_relu", "relu", [b])
    return b


def _basic_block(g: Graph, name: str, x: str, cin: int, cout: int,
                 stride: int) -> str:
    y = _conv_bn_relu(g, f"{name}_a", x, cin, cout, 3, stride, 1)
    y = _conv_bn_relu(g, f"{name}_b", y, cout, cout, 3, 1, 1, relu=False)
    if stride != 1 or cin != cout:
        x = _conv_bn_relu(g, f"{name}_ds", x, cin, cout, 1, stride, 0,
                          relu=False)
    s = g.add(f"{name}_add", "add", [y, x])
    return g.add(f"{name}_out", "relu", [s])


def _bottleneck(g: Graph, name: str, x: str, cin: int, cout: int,
                stride: int) -> str:
    mid = cout // 4
    y = _conv_bn_relu(g, f"{name}_a", x, cin, mid, 1)
    y = _conv_bn_relu(g, f"{name}_b", y, mid, mid, 3, stride, 1)
    y = _conv_bn_relu(g, f"{name}_c", y, mid, cout, 1, relu=False)
    if stride != 1 or cin != cout:
        x = _conv_bn_relu(g, f"{name}_ds", x, cin, cout, 1, stride, 0,
                          relu=False)
    s = g.add(f"{name}_add", "add", [y, x])
    return g.add(f"{name}_out", "relu", [s])


def backbone(g: Graph, x: str, depth: int, stages: int = 4) -> Tuple[str, int]:
    """Builds the convolutional trunk; returns (last node, channels).
    ``stages`` < 4 truncates (used by SSD)."""
    kind, units = _SPECS[depth]
    block = _basic_block if kind == "basic" else _bottleneck
    widths = (64, 128, 256, 512) if kind == "basic" else (256, 512, 1024,
                                                          2048)
    y = _conv_bn_relu(g, "stem", x, 3, 64, 7, 2, 3)
    y = g.add("stem_pool", "max_pool", [y], k=3, stride=2, pad=1)
    cin = 64
    for si in range(stages):
        for ui in range(units[si]):
            stride = 2 if (si > 0 and ui == 0) else 1
            y = block(g, f"s{si + 1}u{ui + 1}", y, cin, widths[si], stride)
            cin = widths[si]
    return y, cin


def build(depth: int, batch: int = 1, image: int = 224,
          classes: int = 1000) -> Tuple[Graph, Dict[str, Tuple[int, ...]]]:
    g = Graph()
    x = g.add("data", "input")
    y, c = backbone(g, x, depth)
    y = g.add("gap", "global_avg_pool", [y])
    y = g.add("flat", "flatten", [y])
    y = g.add("fc", "dense", [y], units=classes)
    y = g.add("prob", "softmax", [y])
    g.mark_output(y)
    return g, {"data": (batch, 3, image, image)}
