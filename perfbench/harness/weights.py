"""Weights and inputs drawn from ``--seed`` on the device, in a few large
calls: one normal draw for every normal leaf, one uniform draw for the BN
scales, then the images, all from one ``torch.Generator`` on the device.
The leaves are views of those draws, scaled in place."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, str, Tuple[int, ...], str]

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & SEED_MASK)
    return g


def _std(spec: Spec, dist: dict) -> float:
    _node, _key, shape, init = spec
    if init == "he":
        fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
        return math.sqrt(2.0 / fan_in)
    if init == "bias":
        return dist["bias_std"]
    if init == "bn_shift":
        return dist["bn_shift_std"]
    raise ValueError(f"no normal draw for init {init!r}")


def draw_params(specs: List[Spec], dist: dict, g: torch.Generator,
                device: torch.device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{node: {key: tensor}}`` for ``specs`` (``reference.param_specs``):
    fp32 leaves on ``device``; ``dist`` gives ``bias_std``,
    ``bn_shift_std``, and [low, high] of the uniform ``bn_scale`` and
    ``bn_scale_last``."""
    normal = [s for s in specs if s[3] in ("he", "bias", "bn_shift")]
    uniform = [s for s in specs if s[3] in ("bn_scale", "bn_scale_last")]
    z = torch.randn(sum(math.prod(s[2]) for s in normal), generator=g,
                    device=device)
    u = torch.rand(sum(math.prod(s[2]) for s in uniform), generator=g,
                   device=device)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    for pool, group in ((z, normal), (u, uniform)):
        off = 0
        for spec in group:
            n = math.prod(spec[2])
            leaf = pool[off:off + n].view(spec[2])
            off += n
            if pool is z:
                leaf.mul_(_std(spec, dist))
            else:
                lo, hi = dist[spec[3]]
                leaf.mul_(hi - lo).add_(lo)
            params.setdefault(spec[0], {})[spec[1]] = leaf
    for node, key, shape, init in specs:
        if init == "zero":
            params.setdefault(node, {})[key] = torch.zeros(shape,
                                                           device=device)
    return params


def draw_images(n: int, image: int, g: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """``n`` standard-normal RGB images of ``image`` x ``image``, NCHW."""
    return torch.randn((n, 3, image, image), generator=g, device=device)
