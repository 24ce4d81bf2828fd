"""DenseNet graph builders (Huang et al. 2017) — paper Table 2 rows 10-13.

The incremental channel concats give every dense layer a different input
channel count, so the local-search database gets a workload per layer and
the global search has real per-CONV layout freedom — the family where the
paper reports the largest global-search gains after ResNet.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.graph import Graph

# variant -> (growth, init_features, block config)
_SPECS = {
    121: (32, 64, (6, 12, 24, 16)),
    161: (48, 96, (6, 12, 36, 24)),
    169: (32, 64, (6, 12, 32, 32)),
    201: (32, 64, (6, 12, 48, 32)),
}


def _bn_relu_conv(g: Graph, name: str, x: str, cin: int, cout: int, k: int,
                  stride: int = 1, pad: int = 0) -> str:
    b = g.add(f"{name}_bn", "batch_norm", [x])
    r = g.add(f"{name}_relu", "relu", [b])
    return g.add(f"{name}_conv", "conv2d", [r], in_channels=cin,
                 out_channels=cout, kh=k, kw=k, stride=stride, pad=pad)


def build(depth: int, batch: int = 1, image: int = 224,
          classes: int = 1000) -> Tuple[Graph, Dict[str, Tuple[int, ...]]]:
    growth, feats, blocks = _SPECS[depth]
    g = Graph()
    x = g.add("data", "input")
    y = g.add("stem_conv", "conv2d", [x], in_channels=3, out_channels=feats,
              kh=7, kw=7, stride=2, pad=3)
    y = g.add("stem_bn", "batch_norm", [y])
    y = g.add("stem_relu", "relu", [y])
    y = g.add("stem_pool", "max_pool", [y], k=3, stride=2, pad=1)
    c = feats
    for bi, n_layers in enumerate(blocks):
        for li in range(n_layers):
            name = f"b{bi + 1}l{li + 1}"
            mid = _bn_relu_conv(g, f"{name}_1", y, c, 4 * growth, 1)
            new = _bn_relu_conv(g, f"{name}_2", mid, 4 * growth, growth, 3,
                                pad=1)
            y = g.add(f"{name}_cat", "concat", [y, new])
            c += growth
        if bi != len(blocks) - 1:
            y = _bn_relu_conv(g, f"t{bi + 1}", y, c, c // 2, 1)
            y = g.add(f"t{bi + 1}_pool", "avg_pool", [y], k=2, stride=2)
            c //= 2
    y = g.add("final_bn", "batch_norm", [y])
    y = g.add("final_relu", "relu", [y])
    y = g.add("gap", "global_avg_pool", [y])
    y = g.add("flat", "flatten", [y])
    y = g.add("fc", "dense", [y], units=classes)
    y = g.add("prob", "softmax", [y])
    g.mark_output(y)
    return g, {"data": (batch, 3, image, image)}
