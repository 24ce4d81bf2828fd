"""Spreads of a cell's runs, as the bounds in ``BENCHMARK.json`` are set
from them.

    python3 perfbench/tools/spread.py SET1_DIR SET2_DIR

Each directory holds the standard output of one set of runs of one cell
(``*.out``, the result on the last line).  For each end-to-end metric:
each set's median and spread (the distance between the first and third
quartile of ``statistics.quantiles(values, n=4)``, over the median), the
same with each set's run farthest from its median left out, the spread
of all runs together, and the bound of five times the wider spread.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path


def spread(values):
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def load(folder: Path):
    runs = []
    for path in sorted(folder.glob("*.out")):
        lines = path.read_text().strip().splitlines()
        if lines:
            runs.append(json.loads(lines[-1]))
    return runs


def main(argv) -> int:
    sets = [load(Path(a)) for a in argv]
    names = sorted({m for runs in sets for r in runs for m in r["metrics"]})
    for name in names:
        vals = [[r["metrics"][name]["value"] for r in runs
                 if name in r["metrics"]] for runs in sets]
        row = {"metric": name,
               "medians": [statistics.median(v) for v in vals],
               "spreads": [spread(v) for v in vals],
               "trimmed_spreads": [spread(trimmed(v)) for v in vals],
               "all_runs_spread": spread([x for v in vals for x in v]),
               "correct": [all(r["correct"] for r in runs) for runs in sets]}
        row["bound_5x"] = 5 * max(row["spreads"])
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
