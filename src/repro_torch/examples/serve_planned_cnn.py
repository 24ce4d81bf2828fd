"""End-to-end serving driver (the paper's workload: latency-focused CNN
inference, many requests) through the persistent ``InferenceSession``
lifecycle and the async dynamic-batching driver — the port of the
reference's ``examples/serve_planned_cnn.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_planned_cnn [model] [n_requests] [--device cpu]

Compiles the model once on ``--device`` (``engine.compile`` runs the
fusion + layout pipeline and binds the weights into their physical
layouts), specializes the serving bucket 8 beside 1, saves the artifact,
then — as a cold-start server would — loads it back and serves a stream
of single-image requests through ``AsyncServer``
(``launch.serve.serve_artifact``): a bounded queue, dynamic batching into
the artifact's buckets, a graceful drain.  The load runs no schedule
search and no weight transformation (``serve_artifact`` checks it), and
every response is bit-identical to serving the same artifact one request
at a time (``engine.padded_predict`` at the response's bucket).
``--artifact DIR`` keeps the artifact there instead of in a temporary
directory.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.engine import compile as compile_session
from repro_torch.launch.cpu import check_devices
from repro_torch.launch.serve import serve_artifact

SERVE_BUCKET = 8


def main(argv=None) -> torch.Tensor:
    """Compile, save, load and serve; returns the last request's output."""
    ap = argparse.ArgumentParser()
    ap.add_argument("model", nargs="?", default="resnet-18")
    ap.add_argument("n_requests", nargs="?", type=int, default=20)
    ap.add_argument("--image", type=int, default=128)
    ap.add_argument("--artifact", default=None,
                    help="where to save the artifact (default: a "
                         "temporary directory, deleted after)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default; raises without one) or the "
                         "CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    check_devices(1, args.device)
    name, image = args.model, args.image

    t0 = time.perf_counter()
    session = compile_session(name, (1, 3, image, image),
                              device=args.device)
    session.specialize(SERVE_BUCKET)     # the bucket the driver packs into
    t_compile = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="neocpu_session_") as tmp:
        artifact = args.artifact or str(Path(tmp) / "artifact")
        session.save(artifact)
        print(f"model={name} compile_time={t_compile:.1f}s -> artifact "
              f"{artifact} (buckets {session.batch_sizes})")
        # cold-start server: load the artifact (no search, no re-binding:
        # serve_artifact checks it) and serve the stream through the
        # async dynamic-batching driver
        out = serve_artifact(artifact, args.n_requests,
                             max_batch=SERVE_BUCKET, max_wait_ms=2.0,
                             device=args.device)
    print(f"top-1 of last request: {int(torch.argmax(out))}")
    return out


if __name__ == "__main__":
    main()
