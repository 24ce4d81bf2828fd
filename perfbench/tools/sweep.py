"""Find a served cell's knee: the highest Poisson rate whose backlog does
not grow over a window.  One process: set-up once, then each rate in turn.

    python3 perfbench/tools/sweep.py --workload resnet50.server \\
        --config resnet50 --traffic poisson_single \\
        --rates 600,800,1000 --seconds 6 --seed 5

Prints one JSON line a rate: offered and completed rate, p50 and p95
latency, the mean latency of the first and last quarter of the window's
requests, and the requests still unanswered when the window closed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])
sys.path.insert(1, str(Path(__file__).resolve().parents[2] / "src"))


def main() -> int:
    import torch

    from perfbench import reference as references
    from perfbench.harness import cell as cells, loops, spec
    from perfbench.harness.profiling import HostSpans
    from perfbench.harness.weights import draw_params, generator
    from perfbench.traffic.generator import arrivals
    from repro_torch.engine.serving import AsyncServer, DynamicBatchPolicy

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--config", help="for a cell BENCHMARK.json does "
                    "not name: its configuration ...")
    ap.add_argument("--traffic", help="... and its traffic mix")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=5)
    a = ap.parse_args()
    entry = None
    if a.config:
        entry = {"name": a.workload, "config": a.config,
                 "traffic": a.traffic, "chips": 1}
    cell = spec.resolve(a.workload, entry=entry)
    dev = torch.device("cuda")
    cfg = cell.config
    ref = references.load(cfg["reference"])
    specs = ref.param_specs(image=cfg["image"], classes=cfg["classes"],
                            **cfg.get("reference_args", {}))
    g = generator(a.seed, dev)
    params = draw_params(specs, cfg["weights"], g, dev)
    pool = cells._pool(cell, g, dev)
    session, buckets = cells._session(cell, params, dev)
    w = cell.workload
    spans = HostSpans()
    for rate in [float(r) for r in a.rates.split(",")]:
        due = [d for d, _ in arrivals(cell.traffic, rate, a.seconds, a.seed)]
        server = AsyncServer(session, DynamicBatchPolicy(**w["policy"]),
                             max_queue=len(due) + 1,
                             workers=w.get("workers", 1))
        try:
            warm = [d for d, _ in arrivals(cell.traffic, rate, 0.5, 1)]
            loops.open_loop(server, pool, warm, 0.5, buckets, spans)
            win = loops.open_loop(server, pool, due, a.seconds, buckets,
                                  spans)
        finally:
            server.close(drain=True)
        print(json.dumps({
            "rate": rate, "requests": win.attempted, "failed": win.failed,
            "completed_per_s": (win.attempted - win.notes["backlog_at_close"])
            / a.seconds,
            "p95_ms": win.e2e["latency_p95_ms"], **win.notes,
            "serving": win.serving}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
