"""SSD with a ResNet-50 base (Liu et al. 2016), 512x512 input.

The multi-scale heads and their flatten+concat tails produce exactly the
dependency structure that blew up the paper's DP ("the number of states can
reach the order of trillions") — this model is the PBQP fallback's test
case, as in the paper ("only SSD was done approximately").
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core.graph import Graph
from repro_torch.models.cnn import resnet


def _cbr(g: Graph, name: str, x: str, cin: int, cout: int, k: int,
         stride: int = 1, pad: int = 0) -> str:
    c = g.add(f"{name}_conv", "conv2d", [x], in_channels=cin,
              out_channels=cout, kh=k, kw=k, stride=stride, pad=pad)
    b = g.add(f"{name}_bn", "batch_norm", [c])
    return g.add(f"{name}_relu", "relu", [b])


def build(batch: int = 1, image: int = 512, classes: int = 21,
          ) -> Tuple[Graph, Dict[str, Tuple[int, ...]]]:
    g = Graph()
    x = g.add("data", "input")

    # ResNet-50 trunk; tap stage-3 (1024ch) and stage-4 (2048ch) features
    kind, units = resnet._SPECS[50]
    y = resnet._conv_bn_relu(g, "stem", x, 3, 64, 7, 2, 3)
    y = g.add("stem_pool", "max_pool", [y], k=3, stride=2, pad=1)
    widths = (256, 512, 1024, 2048)
    cin, taps = 64, []
    for si in range(4):
        for ui in range(units[si]):
            stride = 2 if (si > 0 and ui == 0) else 1
            y = resnet._bottleneck(g, f"s{si + 1}u{ui + 1}", y, cin,
                                   widths[si], stride)
            cin = widths[si]
        if si >= 2:
            taps.append((y, cin))

    # extra feature pyramid: 16->8->4->2->1
    feats: List[Tuple[str, int]] = list(taps)
    c = cin
    for i, ec in enumerate((512, 256, 256, 256)):
        y = _cbr(g, f"extra{i + 1}a", y, c, 256, 1)
        y = _cbr(g, f"extra{i + 1}b", y, 256, ec, 3, stride=2, pad=1)
        c = ec
        feats.append((y, c))

    # multibox heads: per scale, loc (A*4) and conf (A*classes) 3x3 convs
    anchors = (4, 6, 6, 6, 4, 4)
    locs, confs = [], []
    for i, ((f, fc), a) in enumerate(zip(feats, anchors)):
        loc = g.add(f"loc{i + 1}", "conv2d", [f], in_channels=fc,
                    out_channels=a * 4, kh=3, kw=3, pad=1, bias=True)
        conf = g.add(f"conf{i + 1}", "conv2d", [f], in_channels=fc,
                     out_channels=a * classes, kh=3, kw=3, pad=1, bias=True)
        locs.append(g.add(f"loc{i + 1}_flat", "flatten", [loc]))
        confs.append(g.add(f"conf{i + 1}_flat", "flatten", [conf]))
    loc_all = g.add("loc_cat", "concat", locs)
    conf_all = g.add("conf_cat", "concat", confs)
    g.mark_output(loc_all)
    g.mark_output(conf_all)
    return g, {"data": (batch, 3, image, image)}
