"""Training driver: data -> step -> checkpoint -> restart — the port of the
reference's ``repro/launch/train.py``.

Runs the reference's reduced configs (fp32) on ``--device`` (default
``cuda``; with no card there it raises rather than fall back to the CPU,
which ``--device cpu`` asks for).  One step is ``model.loss_fn`` under
autograd, ``loss.backward()``, the optional int8 gradient round trip
(``--compress-grads``) and ``AdamW.update``, run eagerly where the
reference ``jit``s it: on the card every attention layer launches B3,
every Mamba-2 layer B4 and every MoE router B2, forward and, through
their autograd Functions, backward.  Supports:

* checkpoint/restart (``--resume`` picks up the latest step; the data
  stream re-addresses deterministically), from a store that either
  package wrote;
* periodic asynchronous checkpoints (``--ckpt-every``);
* int8 + error-feedback gradient compression (``--compress-grads``).

Example:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch mamba2-130m --steps 30 --batch 4 --seq 32
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCHS, reduced as make_reduced
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.launch.cpu import check_devices
from repro_torch.models.lm import model
from repro_torch.optim import AdamW, cosine_lr
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime import compression

__all__ = ["loss_and_grads", "make_train_step", "main"]


def loss_and_grads(params, cfg, batch):
    """``model.loss_fn`` at ``params`` on ``batch`` (tensors on the
    parameters' device) and its gradients, in a tree of ``params``'
    structure: a parameter that the loss does not reach gets a zero
    gradient, as ``jax.grad`` gives it.  ``params`` is not written."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, _ = model.loss_fn(live, cfg, batch)
        loss.backward()
    return loss.detach(), tree_map(_grad_of, live)


def _grad_of(p):
    """``p``'s gradient, placed as ``p`` is where ``p`` is a DTensor (a
    gradient that the backward left ``Partial`` is summed here)."""
    from torch.distributed.tensor import DTensor

    g = p.grad
    if g is None:
        return torch.zeros_like(p)
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg, opt, compress: bool):
    """``step_fn(params, opt_state, err_state, batch, lr_scale)`` ->
    ``(params, opt_state, err_state, loss, grad_norm)``, the reference's
    jitted step: ``loss_and_grads``, the compression round trip where
    ``compress``, then ``opt.update``.  The inputs are not written."""
    def step_fn(params, opt_state, err_state, batch, lr_scale):
        loss, grads = loss_and_grads(params, cfg, batch)
        if compress:
            grads, err_state = compression.compress_grads(grads, err_state)
        params, opt_state, om = opt.update(grads, opt_state, params,
                                           lr_scale=lr_scale)
        return params, opt_state, err_state, loss, om["grad_norm"]
    return step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train: the card (default; raises "
                         "without one) or the CPU (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    check_devices(1, args.device)
    device = torch.device(args.device)

    cfg = make_reduced(ARCHS[args.arch])
    opt = AdamW(lr=args.lr)
    store = CheckpointStore(Path(args.ckpt_dir) / cfg.name)

    # drawn on the CPU whatever the device, so that a run on the card and
    # one on the CPU train the same weights
    params = model.params_to(model.init_params(cfg, 0, "cpu"), device)
    opt_state = opt.init(params)
    err_state = compression.init_error(params)
    start = 0
    if args.resume and store.latest_step() is not None:
        (params, opt_state, err_state), start, meta = store.restore(
            (params, opt_state, err_state), device=device)
        print(f"resumed from step {start}", flush=True)

    dc = DataConfig(global_batch=args.batch, seq_len=args.seq,
                    vocab=cfg.vocab)
    stream = SyntheticLMStream(dc, cfg)
    step_fn = make_train_step(cfg, opt, args.compress_grads)

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in stream.host_slice(step, 0, 1).items()}
        lr_scale = cosine_lr(step, base=1.0, warmup=10, total=args.steps)
        params, opt_state, err_state, loss, gnorm = step_fn(
            params, opt_state, err_state, batch, lr_scale)
        losses.append(float(loss))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(loss):.4f} "
                  f"gnorm {float(gnorm):.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            store.save(step + 1, (params, opt_state, err_state),
                       meta={"loss": float(loss)}, blocking=False)
    store.wait()
    store.save(args.steps, (params, opt_state, err_state),
               meta={"loss": losses[-1]})
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})",
          flush=True)
    return losses


if __name__ == "__main__":
    main()
