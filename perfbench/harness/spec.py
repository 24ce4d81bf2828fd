"""A cell of ``BENCHMARK.json`` resolved to its files by name.

    BENCHMARK.json            the cells, metrics and configurations
    perfbench/configs/        one file a configuration (its ``file``)
    perfbench/traffic/        <traffic>.json: one file a traffic mix
    perfbench/workloads/      <cell>.json: the cell's own numbers (its
                              rate, buckets, the limits of the check)
    perfbench/metrics/        <metric>.py: one reader a per-layer metric
    perfbench/reference/      <reference>.py: the plain networks

Nothing here names a cell: a cell, a configuration, a traffic mix or a
per-layer metric is added by adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reported(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(name: str, root: Path = ROOT,
            overrides: Optional[Dict[str, dict]] = None,
            entry: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and workload
    files read, and the metrics it reports; ``overrides`` (tests) replaces
    keys of ``config``, ``traffic`` and ``workload``.  ``entry`` stands in
    for the cell's entry in ``workloads``, for a cell whose files are here
    and which ``BENCHMARK.json`` does not name (a sweep, a test)."""
    bench = load_benchmark(root)
    overrides = overrides or {}
    cells = {w["name"]: w for w in bench["workloads"]}
    if entry is None and name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = entry or cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{w['traffic']}.json")
        .read_text())
    workload = json.loads(
        (root / "perfbench" / "workloads" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reported(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in moved)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_merge(config, overrides.get("config")),
                traffic=_merge(traffic, overrides.get("traffic")),
                workload=_merge(workload, overrides.get("workload")),
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
