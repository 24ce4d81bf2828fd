"""Fault-tolerant LM training demo: checkpoint/restart, elastic re-mesh
and straggler mitigation, end to end with a reduced config — the port of
the reference's ``examples/train_lm_fault_tolerant.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_fault_tolerant [--device cpu] [--ckpt-dir DIR]

Simulates a 4-host fleet training a reduced qwen2 in one process: host 2
dies at step 12 (its heartbeat times out), the supervisor re-plans the
mesh over the 3 survivors (``plan_elastic_mesh``), restores the latest
checkpoint, re-slices the deterministic data stream, and training goes
on; a straggler is detected and its batch share rebalanced
(``rebalanced_batch_split``).  Each step is ``launch.train``'s step
(``loss_fn`` under autograd, AdamW) on ``--device``: on the card every
attention layer launches the Hopper attention kernel, forward and
backward.

The store lives in ``--ckpt-dir`` (the reference's fixed
``/tmp/repro_ft_demo`` by default); steps that an earlier run left there
are deleted first, so a restore never reads another run's state.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.launch.cpu import check_devices
from repro_torch.launch.train import make_train_step
from repro_torch.models.lm import model
from repro_torch.optim import AdamW
from repro_torch.runtime import (HeartbeatMonitor, StragglerMitigator,
                                 StragglerPolicy, plan_elastic_mesh,
                                 rebalanced_batch_split)

STEPS = 25


def main(argv=None) -> dict:
    """Run the demo; returns ``{"lines": printed lines, "losses": the loss
    of every step}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ft_demo")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default; raises without one) or the "
                         "CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    check_devices(1, args.device)
    device = torch.device(args.device)
    lines, losses = [], []

    def log(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    cfg = reduced(ARCHS["qwen2-1.5b"])
    opt = AdamW(lr=1e-3)
    # drawn on the CPU whatever the device, as launch.train draws them
    params = model.params_to(model.init_params(cfg, 0, "cpu"), device)
    opt_state = opt.init(params)
    store = CheckpointStore(args.ckpt_dir)
    for s in store.steps():
        store.delete(s)

    hosts = [0, 1, 2, 3]
    clock = [0.0]
    mon = HeartbeatMonitor(hosts, timeout_s=3.0, clock=lambda: clock[0])
    strag = StragglerMitigator(hosts, StragglerPolicy(slow_factor=1.5,
                                                      evict_after=3))
    dc = DataConfig(global_batch=8, seq_len=32, vocab=cfg.vocab)
    stream = SyntheticLMStream(dc, cfg)
    train_step = make_train_step(cfg, opt, compress=False)

    alive = list(hosts)
    for step in range(STEPS):
        clock[0] += 1.0
        # hosts post heartbeats; host 2 goes silent from step 12
        for h in alive:
            if not (h == 2 and step >= 12):
                mon.beat(h)
        dead = mon.check()
        if dead:
            log(f"step {step}: hosts {dead} FAILED — re-meshing")
            alive = mon.alive
            d, m = plan_elastic_mesh(len(alive) * 64, model_axis=16)
            log(f"  elastic plan over {len(alive) * 64} chips: "
                f"mesh ({d}, {m})")
            store.wait()           # the checkpoint still being written
            (params, opt_state), ck_step, _ = store.restore(
                (params, opt_state), device=device)
            log(f"  restored checkpoint @ step {ck_step}; data stream "
                f"re-addressed for {len(alive)} hosts")

        # per-host step times: host 3 is a straggler
        times = {h: (2.2 if h == 3 else 1.0) for h in alive}
        strag.record(times)
        slow = strag.stragglers()
        if slow and step % 5 == 0:
            w = strag.batch_weights()
            split = rebalanced_batch_split(
                dc.global_batch, [w[h] for h in alive])
            log(f"step {step}: stragglers {slow}; batch re-split "
                f"{dict(zip(alive, split))}")

        # one real training step on the (simulated) fleet's global batch
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in stream.global_batch(step).items()}
        params, opt_state, _, loss, _ = train_step(params, opt_state, None,
                                                   batch, 1.0)
        losses.append(float(loss))
        if step % 5 == 0 or dead:
            log(f"step {step:3d} loss {float(loss):.4f}")
        if (step + 1) % 6 == 0:
            store.save(step + 1, (params, opt_state), blocking=False)
    store.wait()
    log("done — survived a failure and a straggler without losing the "
        "trajectory")
    return {"lines": lines, "losses": losses}


if __name__ == "__main__":
    main()
