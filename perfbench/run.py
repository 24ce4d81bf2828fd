"""The port's benchmark: one run of one cell on the card it starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cells, their metrics and configurations are in ``BENCHMARK.json`` at
the root of the checkout; what each one runs is in the files of this
folder, found by name (``harness/spec.py``).  The program under test is
``repro_torch`` from ``src/`` of the checkout.  Its last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, ``breakdown`` with ``--trace 1``, and ``checks``:
each number compared, with its limit); the line before it holds what the
run noted (set-up, the generator's lateness, the trace's own counts).
Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2; it exits 1 if the JAX package or JAX was loaded.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The wall-clock time this process started, from ``/proc``."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = _process_start()
ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)                 # this folder's files stay a package
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import cell, spec
    from perfbench.harness.output import finite, loaded_forbidden

    want = spec.resolve(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"perfbench: {args.workload} needs {want} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = cell.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_process=T_PROCESS)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the process loaded {bad}", file=sys.stderr)
        return 1
    result = finite(out["result"])
    print(json.dumps({"notes": finite(out["notes"])}))
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
