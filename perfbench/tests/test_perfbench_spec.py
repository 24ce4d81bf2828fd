"""``BENCHMARK.json`` against the benchmark's contract, every cell resolved
by name to its files, a cell added by files alone, and the harness free
of JAX and of the JAX package."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w)
                                               for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) <= 64 * 1024


def test_metrics_follow_the_contract(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        cell = spec.resolve(w)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer


def test_run_seconds_fit_the_check(bench):
    """A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60,
    2 x 90 s a cell to compile, 1,200 s spare, within 43,200 s."""
    n = 24
    total = (2 + 14 * n) * (bench["run_seconds"] + 60) + n * 180 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = spec.resolve(cell)
    assert c.traffic["loop"] in ("offline", "closed", "open")
    assert "logprob_gap" in c.workload["limits"]
    assert (BENCH / "reference" / f"{c.config['reference']}.py").is_file()
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_a_cell_added_by_files_alone(tmp_path):
    """A copy of the benchmark with one more cell and one more per-layer
    metric, added as files and entries: the harness resolves both, and
    nothing existing changed."""
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "resnet50.single_stream",
                               "config": "resnet50",
                               "traffic": "single_stream", "chips": 1,
                               "why": "batch 1, closed loop"})
    for m in bench["end_to_end"]:
        if m["name"] in ("predict_ms", "predict_p95_ms"):
            m["workloads"].append("resnet50.single_stream")
    bench["per_layer"].append({
        "name": "idle_share.r50single", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "predict_ms",
        "workloads": ["resnet50.single_stream"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "perfbench" / "workloads" / "resnet50.single_stream.json"
     ).write_text(json.dumps({"limits": {"logprob_gap": 1e-3}}))
    (tmp_path / "perfbench" / "metrics" / "idle_share.r50single.py"
     ).write_text("def read(run):\n    return 1.5\n")
    c = spec.resolve("resnet50.single_stream", root=tmp_path)
    assert c.config["zoo"] == "resnet-50" and c.traffic["loop"] == "closed"
    assert {m["name"] for m in c.end_to_end} == {"predict_ms",
                                                 "predict_p95_ms", "setup_s"}
    assert [m["name"] for m in c.per_layer] == ["idle_share.r50single"]
    assert spec.metric_reader("idle_share.r50single", root=tmp_path)(None) \
        == 1.5


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_jax_and_no_jax_package():
    """No file of the benchmark imports a module whose top-level name is
    JAX's or the JAX package's (``repro_torch`` is not ``repro``), and the
    references import nothing of the program either."""
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path
        if path.parent.name == "reference":
            assert "repro_torch" not in tops, path


def test_no_card_no_result():
    """Without a card the command prints no result and exits non-zero."""
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "resnet50.offline", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2 and proc.stdout == ""
    assert "needs 1 CUDA device" in proc.stderr


@pytest.mark.parametrize("path", sorted((BENCH / "metrics").glob("*.py")),
                         ids=lambda p: p.stem)
def test_every_reader_reads_nothing_from_an_empty_run(path):
    """Each reader loads by its metric's name and returns None, never 0,
    where the run holds nothing for it."""
    from types import SimpleNamespace

    empty = SimpleNamespace(
        window=SimpleNamespace(enqueue_ms=[], images=0, seconds=0.0,
                               serving=None),
        trace=None, costs=None)
    assert spec.metric_reader(path.stem)(empty) is None
