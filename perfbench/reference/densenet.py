"""DenseNet-BC (Huang et al. 2017, arXiv:1608.06993, Table 1), plain fp32.

The 121-, 169- and 201-layer networks (growth rate k = 32, 64 stem
features) and the 161-layer one (k = 48, 96 features), compression
θ = 0.5:

    stem      y = maxpool_3x3/2(relu(bn(conv_7x7/2(x))))
    layer     h = conv_1x1(relu(bn_1(y)))          to 4k channels
              h = conv_3x3(relu(bn_2(h)))          to k channels
              y = concat([y, h], channels)         the layer's input first
    block     the layers of Table 1 (6, 12, 24, 16 for DenseNet-121), each
              reading the concatenation of every feature map before it
    transition  y = avgpool_2x2/2(conv_1x1(relu(bn(y))))  to ⌊θ C⌋ = C // 2
    head      y = softmax(fc(mean_hw(relu(bn(y)))))

The convs have no bias.  Departures from the paper: inference batch norm,
a per-channel scale and shift (``bn``) with the running statistics folded
in, as the program folds them; and the stem's BN and ReLU before its pool,
which Table 1 does not list (it gives the 7x7 conv and the pool) and the
authors' ImageNet code has.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import bn, conv, dense

# depth -> (growth rate k, stem features, layers of each dense block)
SPECS = {121: (32, 64, (6, 12, 24, 16)), 161: (48, 96, (6, 12, 36, 24)),
         169: (32, 64, (6, 12, 32, 32)), 201: (32, 64, (6, 12, 48, 32))}


def _bn(name: str, c: int):
    return [(name, "scale", (c,), "bn_scale"),
            (name, "shift", (c,), "bn_shift")]


def _layers(depth: int):
    """(layer name, its input channels) of every dense layer, and
    (transition name, its input channels) after each block but the last,
    in order; then ("final", the head's channels)."""
    growth, c, blocks = SPECS[depth]
    for bi, n in enumerate(blocks):
        for li in range(n):
            yield f"b{bi + 1}l{li + 1}", c
            c += growth
        if bi != len(blocks) - 1:
            yield f"t{bi + 1}", c
            c //= 2
    yield "final", c


def param_specs(depth: int = 121, classes: int = 1000, **_):
    growth, feats, _blocks = SPECS[depth]
    specs = [("stem_conv", "w", (feats, 3, 7, 7), "he")] + _bn("stem_bn",
                                                               feats)
    for name, c in _layers(depth):
        if name == "final":
            specs += _bn("final_bn", c)
            specs += [("fc", "w", (c, classes), "he"),
                      ("fc", "b", (classes,), "zero")]
        elif name.startswith("t"):
            specs += _bn(f"{name}_bn", c)
            specs += [(f"{name}_conv", "w", (c // 2, c, 1, 1), "he")]
        else:
            specs += _bn(f"{name}_1_bn", c)
            specs += [(f"{name}_1_conv", "w", (4 * growth, c, 1, 1), "he")]
            specs += _bn(f"{name}_2_bn", 4 * growth)
            specs += [(f"{name}_2_conv", "w", (growth, 4 * growth, 3, 3),
                       "he")]
    return specs


def forward(params, x: torch.Tensor, precision: str = "fp32",
            depth: int = 121, **_) -> torch.Tensor:
    def brc(name, y, pad=0):
        """BN-ReLU-conv, the pre-activation unit of every layer."""
        y = F.relu(bn(y, params[f"{name}_bn"]))
        return conv(y, params[f"{name}_conv"]["w"], pad=pad,
                    precision=precision)

    y = conv(x, params["stem_conv"]["w"], stride=2, pad=3,
             precision=precision)
    y = F.max_pool2d(F.relu(bn(y, params["stem_bn"])), 3, 2, 1)
    for name, _c in _layers(depth):
        if name == "final":
            y = F.relu(bn(y, params["final_bn"]))
        elif name.startswith("t"):
            y = F.avg_pool2d(brc(name, y), 2, 2)
        else:
            h = brc(f"{name}_2", brc(f"{name}_1", y), pad=1)
            y = torch.cat([y, h], dim=1)
    y = y.mean(dim=(2, 3))
    y = dense(y, params["fc"]["w"], params["fc"]["b"], precision=precision)
    return torch.softmax(y, dim=-1)
