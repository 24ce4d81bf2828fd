"""Inception-v3 graph builder (Szegedy et al. 2016) — 299x299 input.

The factorized 1x7/7x1 convolutions exercise the template's asymmetric
padding; the four-branch concat blocks give the global search non-trivial
coupling structure.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.graph import Graph


def _cbr(g: Graph, name: str, x: str, cin: int, cout: int, kh: int, kw: int,
         stride: int = 1, pad: int = 0, pad_w: int = -1) -> str:
    c = g.add(f"{name}_conv", "conv2d", [x], in_channels=cin,
              out_channels=cout, kh=kh, kw=kw, stride=stride, pad=pad,
              pad_w=pad_w)
    b = g.add(f"{name}_bn", "batch_norm", [c])
    return g.add(f"{name}_relu", "relu", [b])


def _inception_a(g: Graph, name: str, x: str, cin: int, pool_f: int) -> Tuple[str, int]:
    b1 = _cbr(g, f"{name}_b1", x, cin, 64, 1, 1)
    b5 = _cbr(g, f"{name}_b5a", x, cin, 48, 1, 1)
    b5 = _cbr(g, f"{name}_b5b", b5, 48, 64, 5, 5, pad=2)
    b3 = _cbr(g, f"{name}_b3a", x, cin, 64, 1, 1)
    b3 = _cbr(g, f"{name}_b3b", b3, 64, 96, 3, 3, pad=1)
    b3 = _cbr(g, f"{name}_b3c", b3, 96, 96, 3, 3, pad=1)
    bp = g.add(f"{name}_pool", "avg_pool", [x], k=3, stride=1, pad=1)
    bp = _cbr(g, f"{name}_bp", bp, cin, pool_f, 1, 1)
    out = g.add(f"{name}_cat", "concat", [b1, b5, b3, bp])
    return out, 64 + 64 + 96 + pool_f


def _inception_b(g: Graph, name: str, x: str, cin: int) -> Tuple[str, int]:
    b3 = _cbr(g, f"{name}_b3", x, cin, 384, 3, 3, stride=2)
    bd = _cbr(g, f"{name}_bda", x, cin, 64, 1, 1)
    bd = _cbr(g, f"{name}_bdb", bd, 64, 96, 3, 3, pad=1)
    bd = _cbr(g, f"{name}_bdc", bd, 96, 96, 3, 3, stride=2)
    bp = g.add(f"{name}_pool", "max_pool", [x], k=3, stride=2)
    out = g.add(f"{name}_cat", "concat", [b3, bd, bp])
    return out, 384 + 96 + cin


def _inception_c(g: Graph, name: str, x: str, cin: int, c7: int) -> Tuple[str, int]:
    b1 = _cbr(g, f"{name}_b1", x, cin, 192, 1, 1)
    b7 = _cbr(g, f"{name}_b7a", x, cin, c7, 1, 1)
    b7 = _cbr(g, f"{name}_b7b", b7, c7, c7, 1, 7, pad=0, pad_w=3)
    b7 = _cbr(g, f"{name}_b7c", b7, c7, 192, 7, 1, pad=3, pad_w=0)
    bd = _cbr(g, f"{name}_bda", x, cin, c7, 1, 1)
    bd = _cbr(g, f"{name}_bdb", bd, c7, c7, 7, 1, pad=3, pad_w=0)
    bd = _cbr(g, f"{name}_bdc", bd, c7, c7, 1, 7, pad=0, pad_w=3)
    bd = _cbr(g, f"{name}_bdd", bd, c7, c7, 7, 1, pad=3, pad_w=0)
    bd = _cbr(g, f"{name}_bde", bd, c7, 192, 1, 7, pad=0, pad_w=3)
    bp = g.add(f"{name}_pool", "avg_pool", [x], k=3, stride=1, pad=1)
    bp = _cbr(g, f"{name}_bp", bp, cin, 192, 1, 1)
    out = g.add(f"{name}_cat", "concat", [b1, b7, bd, bp])
    return out, 192 * 4


def _inception_d(g: Graph, name: str, x: str, cin: int) -> Tuple[str, int]:
    b3 = _cbr(g, f"{name}_b3a", x, cin, 192, 1, 1)
    b3 = _cbr(g, f"{name}_b3b", b3, 192, 320, 3, 3, stride=2)
    b7 = _cbr(g, f"{name}_b7a", x, cin, 192, 1, 1)
    b7 = _cbr(g, f"{name}_b7b", b7, 192, 192, 1, 7, pad=0, pad_w=3)
    b7 = _cbr(g, f"{name}_b7c", b7, 192, 192, 7, 1, pad=3, pad_w=0)
    b7 = _cbr(g, f"{name}_b7d", b7, 192, 192, 3, 3, stride=2)
    bp = g.add(f"{name}_pool", "max_pool", [x], k=3, stride=2)
    out = g.add(f"{name}_cat", "concat", [b3, b7, bp])
    return out, 320 + 192 + cin


def _inception_e(g: Graph, name: str, x: str, cin: int) -> Tuple[str, int]:
    b1 = _cbr(g, f"{name}_b1", x, cin, 320, 1, 1)
    b3 = _cbr(g, f"{name}_b3a", x, cin, 384, 1, 1)
    b3l = _cbr(g, f"{name}_b3l", b3, 384, 384, 1, 3, pad=0, pad_w=1)
    b3r = _cbr(g, f"{name}_b3r", b3, 384, 384, 3, 1, pad=1, pad_w=0)
    b3c = g.add(f"{name}_b3cat", "concat", [b3l, b3r])
    bd = _cbr(g, f"{name}_bda", x, cin, 448, 1, 1)
    bd = _cbr(g, f"{name}_bdb", bd, 448, 384, 3, 3, pad=1)
    bdl = _cbr(g, f"{name}_bdl", bd, 384, 384, 1, 3, pad=0, pad_w=1)
    bdr = _cbr(g, f"{name}_bdr", bd, 384, 384, 3, 1, pad=1, pad_w=0)
    bdc = g.add(f"{name}_bdcat", "concat", [bdl, bdr])
    bp = g.add(f"{name}_pool", "avg_pool", [x], k=3, stride=1, pad=1)
    bp = _cbr(g, f"{name}_bp", bp, cin, 192, 1, 1)
    out = g.add(f"{name}_cat", "concat", [b1, b3c, bdc, bp])
    return out, 320 + 768 + 768 + 192


def build(batch: int = 1, image: int = 299,
          classes: int = 1000) -> Tuple[Graph, Dict[str, Tuple[int, ...]]]:
    g = Graph()
    x = g.add("data", "input")
    y = _cbr(g, "stem1", x, 3, 32, 3, 3, stride=2)
    y = _cbr(g, "stem2", y, 32, 32, 3, 3)
    y = _cbr(g, "stem3", y, 32, 64, 3, 3, pad=1)
    y = g.add("stem_pool1", "max_pool", [y], k=3, stride=2)
    y = _cbr(g, "stem4", y, 64, 80, 1, 1)
    y = _cbr(g, "stem5", y, 80, 192, 3, 3)
    y = g.add("stem_pool2", "max_pool", [y], k=3, stride=2)
    c = 192
    for i, pf in enumerate((32, 64, 64)):
        y, c = _inception_a(g, f"a{i + 1}", y, c, pf)
    y, c = _inception_b(g, "b1", y, c)
    for i, c7 in enumerate((128, 160, 160, 192)):
        y, c = _inception_c(g, f"c{i + 1}", y, c, c7)
    y, c = _inception_d(g, "d1", y, c)
    for i in range(2):
        y, c = _inception_e(g, f"e{i + 1}", y, c)
    y = g.add("gap", "global_avg_pool", [y])
    y = g.add("flat", "flatten", [y])
    y = g.add("fc", "dense", [y], units=classes)
    y = g.add("prob", "softmax", [y])
    g.mark_output(y)
    return g, {"data": (batch, 3, image, image)}
