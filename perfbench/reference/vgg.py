"""VGG (Simonyan & Zisserman 2014, arXiv:1409.1556, Table 1), plain fp32.

Configurations A (11 layers), B (13), D (16) and E (19): five stages of
3x3/1 convs with bias and ReLU, each stage closed by a 2x2/2 max pool; the
feature map flattened in NCHW order; fc6 and fc7 of 4,096 with ReLU, fc8 of
the classes, softmax.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import conv, dense

CONVS = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2), 16: (2, 2, 3, 3, 3),
         19: (2, 2, 4, 4, 4)}
WIDTHS = (64, 128, 256, 512, 512)


def _convs(depth: int):
    cin = 3
    for si, n in enumerate(CONVS[depth]):
        for ui in range(n):
            yield f"s{si + 1}c{ui + 1}", cin, WIDTHS[si], ui == n - 1
            cin = WIDTHS[si]


def param_specs(depth: int = 16, image: int = 224, classes: int = 1000,
                **_):
    specs = []
    for name, cin, cout, _last in _convs(depth):
        specs += [(name, "w", (cout, cin, 3, 3), "he"),
                  (name, "b", (cout,), "bias")]
    flat = WIDTHS[-1] * (image // 32) ** 2
    for name, din, dout in (("fc6", flat, 4096), ("fc7", 4096, 4096),
                            ("fc8", 4096, classes)):
        specs += [(name, "w", (din, dout), "he"), (name, "b", (dout,), "zero")]
    return specs


def forward(params, x: torch.Tensor, precision: str = "fp32",
            depth: int = 16, **_) -> torch.Tensor:
    y = x
    for name, _cin, _cout, last in _convs(depth):
        p = params[name]
        y = F.relu(conv(y, p["w"], p["b"], pad=1, precision=precision))
        if last:
            y = F.max_pool2d(y, 2, 2)
    y = y.reshape(y.shape[0], -1)
    for name in ("fc6", "fc7"):
        y = F.relu(dense(y, params[name]["w"], params[name]["b"],
                         precision=precision))
    y = dense(y, params["fc8"]["w"], params["fc8"]["b"], precision=precision)
    return torch.softmax(y, dim=-1)
