"""AdamW with a clip by global norm, momentum SGD, and the cosine schedule
— the port of the reference's ``repro/optim/adamw.py`` over the port's
parameter trees (dicts, lists and tuples of tensors).

The arithmetic is the reference's, step for step: the global norm of the
fp32 gradients, the clip factor ``min(1, clip_norm / max(norm, 1e-9))``,
moments in ``moment_dtype`` (fp32 by default, whatever the parameter's
type), the bias correction from ``step + 1``, the update in fp32 with the
weight decay added to the Adam direction, and the new parameter cast back
to its own type.  ``update`` runs under ``torch.no_grad()`` and returns new
trees; the inputs are not written.  The state is a ``NamedTuple``, so
``checkpoint.CheckpointStore`` saves a trainer's ``(params, opt_state,
err_state)`` under the reference's leaf names (``[1][0]`` the step,
``[1][1].embed`` a first moment, ...).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

__all__ = ["AdamW", "AdamWState", "SGD", "cosine_lr", "tree_leaves",
           "tree_map"]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tree of dicts (in sorted key order, as
    ``jax.tree.leaves`` walks a dict), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in ``tree_leaves``' order, in a tree of ``tree``'s structure
    (a ``NamedTuple`` stays one)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    mu: Any                # first moment, moment_dtype
    nu: Any                # second moment, moment_dtype


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # "bfloat16" halves the moments' bytes

    def init(self, params) -> AdamWState:
        mdt = getattr(torch, self.moment_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)

        dev = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params,
               lr_scale: float | torch.Tensor = 1.0
               ) -> Tuple[Any, AdamWState, Dict]:
        f32 = torch.float32
        gsq = sum(g.float().square().sum() for g in tree_leaves(grads))
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp_max(self.clip_norm / torch.clamp_min(gnorm, 1e-9),
                                1.0)

        step = state.step + 1
        stepf = step.to(f32)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=f32,
                                          device=stepf.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=f32,
                                          device=stepf.device), stepf)
        rate = torch.as_tensor(self.lr, dtype=f32) * torch.as_tensor(
            lr_scale, dtype=f32)
        mdt = getattr(torch, self.moment_dtype)

        def upd(g, m, v, p):
            g = g.float() * scale
            m = self.b1 * m.float() + (1 - self.b1) * g
            v = self.b2 * v.float() + (1 - self.b2) * g.square()
            mhat = m / c1
            vhat = v / c2
            delta = mhat / (torch.sqrt(vhat) + self.eps) \
                + self.weight_decay * p.float()
            newp = p.float() - rate * delta
            return newp.to(p.dtype), m.to(mdt), v.to(mdt)

        out = tree_map(upd, grads, state.mu, state.nu, params)
        pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
        return (pick(0), AdamWState(step, pick(1), pick(2)),
                {"grad_norm": gnorm})


@dataclasses.dataclass(frozen=True)
class SGD:
    """Momentum SGD, the paper-baseline optimizer for ablations."""

    lr: float = 1e-2
    momentum: float = 0.9

    def init(self, params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    @torch.no_grad()
    def update(self, grads, state, params, lr_scale=1.0):
        rate = torch.as_tensor(self.lr, dtype=torch.float32) \
            * torch.as_tensor(lr_scale, dtype=torch.float32)

        def upd(g, m, p):
            m = self.momentum * m + g.float()
            return (p.float() - rate * m).to(p.dtype), m

        out = tree_map(upd, grads, state, params)
        pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
        return pick(0), pick(1), {}


def cosine_lr(step, *, base: float, warmup: int, total: int
              ) -> torch.Tensor:
    """Warmup then cosine, as an ``lr_scale`` factor (a 0-d float32
    tensor on the CPU)."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32)
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    return base * warm * 0.5 * (1 + torch.cos(math.pi * prog))
