"""ResNet v1 (He et al. 2016, arXiv:1512.03385, Table 1), plain fp32.

The 50-, 101- and 152-layer networks: a 7x7/2 stem conv with BN and ReLU,
a 3x3/2 max pool, four stages of bottleneck units (1x1, 3x3, 1x1 convs,
each with BN; the stride on the 3x3 of a stage's first unit; a 1x1
projection with BN on the shortcut where the shape changes; ReLU after the
residual add), global average pooling, a dense layer and softmax.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import bn, conv, dense

UNITS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
WIDTHS = (256, 512, 1024, 2048)


def _units(depth: int):
    """(unit name, in channels, out channels, stride) of every unit."""
    cin = 64
    for si, n in enumerate(UNITS[depth]):
        for ui in range(n):
            stride = 2 if si > 0 and ui == 0 else 1
            yield f"s{si + 1}u{ui + 1}", cin, WIDTHS[si], stride
            cin = WIDTHS[si]


def _conv_bn(name: str, cin: int, cout: int, k: int,
             scale: str = "bn_scale"):
    return [(f"{name}_conv", "w", (cout, cin, k, k), "he"),
            (f"{name}_bn", "scale", (cout,), scale),
            (f"{name}_bn", "shift", (cout,), "bn_shift")]


def param_specs(depth: int = 50, classes: int = 1000, **_):
    specs = _conv_bn("stem", 3, 64, 7)
    for name, cin, cout, stride in _units(depth):
        mid = cout // 4
        specs += _conv_bn(f"{name}_a", cin, mid, 1)
        specs += _conv_bn(f"{name}_b", mid, mid, 3)
        # the last BN of a residual branch scaled down, as a trained
        # network's are: each unit then adds a fraction of its input's
        # variance, not all of it, and activations stay of order one
        specs += _conv_bn(f"{name}_c", mid, cout, 1, "bn_scale_last")
        if stride != 1 or cin != cout:
            specs += _conv_bn(f"{name}_ds", cin, cout, 1)
    specs += [("fc", "w", (WIDTHS[-1], classes), "he"),
              ("fc", "b", (classes,), "zero")]
    return specs


def forward(params, x: torch.Tensor, precision: str = "fp32",
            depth: int = 50, **_) -> torch.Tensor:
    def cbn(name, y, stride=1, pad=0, relu=True):
        y = bn(conv(y, params[f"{name}_conv"]["w"], stride=stride, pad=pad,
                    precision=precision), params[f"{name}_bn"])
        return F.relu(y) if relu else y

    y = cbn("stem", x, 2, 3)
    y = F.max_pool2d(y, 3, 2, 1)
    for name, cin, cout, stride in _units(depth):
        r = cbn(f"{name}_a", y)
        r = cbn(f"{name}_b", r, stride, 1)
        r = cbn(f"{name}_c", r, relu=False)
        if stride != 1 or cin != cout:
            y = cbn(f"{name}_ds", y, stride, relu=False)
        y = F.relu(r + y)
    y = y.mean(dim=(2, 3))
    y = dense(y, params["fc"]["w"], params["fc"]["b"], precision=precision)
    return torch.softmax(y, dim=-1)
