"""The two readings a cell's limit is set from, in one process.

    python3 perfbench/tools/readings.py --workload vgg16.single_stream \\
        --seeds 1,2,3 --control-seeds 1,2,3 --seconds 3

For each of ``--seeds``: one run of the cell (``cell.run_cell``, the
window ``--seconds`` long) and its ``logprob_gap``, the program's
reading.  For each of ``--control-seeds``: the control, the plain
reference computed in TF32 (the precision below the configurations'
fp32 with TF32 off) in the program's place, on the same parameters and
every input of the cell's pool at the cell's batch, against the
reference in fp32.  One JSON line each.
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
    from perfbench.harness import cell as cells, compare, spec
    from perfbench.harness.weights import draw_params, generator

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args()
    dev = torch.device("cuda")
    seeds = [int(s) for s in a.seeds.split(",") if s]
    for seed in seeds:
        out = cells.run_cell(a.workload, seed, a.seconds, False)
        r = out["result"]
        print(json.dumps({"cell": a.workload, "seed": seed, "side": "program",
                          "correct": r["correct"],
                          "gap": r["checks"]["logprob_gap"]["value"],
                          "outputs": out["notes"]["compared_outputs"]}),
              flush=True)
    cell = spec.resolve(a.workload)
    cfg = cell.config
    ref = references.load(cfg["reference"])
    args = dict(cfg.get("reference_args", {}))
    for seed in [int(s) for s in a.control_seeds.split(",") if s]:
        specs = ref.param_specs(image=cfg["image"], classes=cfg["classes"],
                                **args)
        g = generator(seed, dev)
        params = draw_params(specs, cfg["weights"], g, dev)
        pool = cells._pool(cell, g, dev)
        want = compare.reference_outputs(ref, params, pool, args, dev)
        got = compare.reference_outputs(ref, params, pool, args, dev, "tf32")
        gap = compare.logprob_gap(
            [(k, y.cpu()) for k, y in enumerate(got)], want)
        print(json.dumps({"cell": a.workload, "seed": seed, "side": "control",
                          "gap": gap}), flush=True)
        del params, pool, want, got
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
