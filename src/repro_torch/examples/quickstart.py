"""Quickstart: plan and run a paper-zoo CNN through the Table-3 ladder —
the port of the reference's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [model] [image] [--device cpu]

Builds ResNet-18 (default) as a graph, runs NeoCPU's optimization ladder
(NCHW baseline -> blocked layout -> transform elimination -> global
search -> operation fusion) as composable pass pipelines
(``Pipeline.preset(mode)``), verifies that every rung produces the same
outputs, and prints the planner's predicted H100 latency (the roofline of
``core/cost.py``'s ``H100`` machine model: ``pred_h100``), the host's
wall clock a predict and the per-pass timing report.  On the card every
blocked conv of a rung launches the Hopper conv kernel; the ``nchw`` rung
runs the unblocked direct conv.

For the compile -> save -> load -> serve lifecycle see
``repro_torch.examples.serve_planned_cnn``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.pipeline import MODES, Pipeline
from repro_torch.engine import compile_model
from repro_torch.launch.cpu import check_devices
from repro_torch.models.cnn import build
from repro_torch.nn.init import init_params

TOL = 1e-4           # the reference's max |difference| between rungs


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the ladder; returns ``{mode: output}`` (CPU tensors)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("model", nargs="?", default="resnet-18")
    ap.add_argument("image", nargs="?", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default; raises without one) or the "
                         "CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    check_devices(1, args.device)
    device = torch.device(args.device)
    name, image = args.model, args.image
    print(f"== {name} @ {image}x{image}, batch 1 ==")

    graph, shapes = build(name, batch=1, image=image)
    params = init_params(graph, shapes, seed=0, device=device)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=shapes["data"]).astype(np.float32)).to(device)

    ref, outs = None, {}
    for mode in MODES:
        p = Pipeline.preset(mode).run(graph, shapes, device=device)
        m = compile_model(p, params)
        with torch.inference_mode():
            out = m.predict(x)                  # the first run builds
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(3):
                out = m.predict(x)
            _sync(device)
        wall = (time.perf_counter() - t0) / 3
        if ref is None:
            ref = out
        err = float((out - ref).abs().max())
        solver = p.solution.method if p.solution else "-"
        passes = " ".join(f"{pr.name}={pr.seconds * 1e3:.0f}ms"
                          for pr in p.report.passes)
        print(f"{mode:15s} pred_h100={p.predicted_total_s * 1e3:7.3f} ms  "
              f"wall_{device.type}={wall * 1e3:8.1f} ms  "
              f"transforms={p.planned.n_transforms:3d}  solver={solver:10s} "
              f"max|Δ|={err:.1e}")
        print(f"{'':15s} passes: {passes}")
        if not err < TOL:
            raise RuntimeError(f"{mode}: outputs differ from the nchw rung "
                               f"by {err:.3g}; the planned graph must be "
                               "semantics-preserving")
        outs[mode] = out.cpu()
    print("all modes numerically identical — planning is free of "
          "semantic drift")
    return outs


if __name__ == "__main__":
    main()
