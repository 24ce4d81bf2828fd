"""Plain PyTorch references of the benchmark's networks.

Each module here is one network family written from its paper in plain
``torch`` operations, fp32, with nothing of the program under test: it
imports no ``repro_torch``, ``repro`` or ``jax``, and takes only the
logical parameters and the inputs the benchmark draws.  A module gives

    param_specs(**args) -> [(node, key, shape, init), ...]
    forward(params, x, precision="fp32", **args) -> class probabilities

``params`` is ``{node: {key: tensor}}`` under the node names of the
published layer list (``stem_conv``, ``s1u1_a_bn``, ``fc6`` ...): the
weights as the benchmark draws them, handed alike to the program's
``compile(..., params=...)`` and to ``forward``.  ``init`` names the draw
(``perfbench.harness.weights``): ``he`` (normal, std sqrt(2 / fan_in)),
``bias`` (normal, small), ``zero``, ``bn_scale``, ``bn_shift``.

``precision`` is ``"fp32"`` (the configurations' precision: every product
in full fp32, TF32 off) or ``"tf32"``, the control of the output check:
the same forward with every conv and matmul operand rounded to TF32's
10-bit mantissa (on the card by its own TF32 path, on the CPU by rounding
the operands, as the card's tensor cores do).
"""
from __future__ import annotations

import contextlib
import importlib

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32")


def load(name: str):
    """The reference module ``name`` of this package."""
    return importlib.import_module(f"{__name__}.{name}")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded to nearest on TF32's 10 explicit mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision_mode(precision: str, device: torch.device):
    """Sets the card's TF32 flags for ``precision`` while the block runs,
    and restores them after."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if device.type != "cuda":
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _operands(precision: str, *ts):
    if precision == "tf32" and ts[0].device.type != "cuda":
        return tuple(round_tf32(t) for t in ts)
    return ts


def conv(x, w, b=None, *, stride=1, pad=0, precision="fp32"):
    x, w = _operands(precision, x, w)
    return F.conv2d(x, w, b, stride=stride, padding=pad)


def dense(x, w, b, *, precision="fp32"):
    """``x @ w + b`` with ``w`` stored (in features, out features)."""
    x, w = _operands(precision, x, w)
    return torch.addmm(b, x, w)


def bn(x, p):
    """Inference batch norm folded to a per-channel scale and shift."""
    return x * p["scale"][None, :, None, None] + p["shift"][None, :, None, None]
