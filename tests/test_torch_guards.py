"""Guards on the port's boundaries.

``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
reference ``repro`` (the card's machine has no JAX), the package imports in
a process where both are unavailable, and ``chip_smoke.py`` refuses to run
without a card or outside a checkout.
"""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_scan_catches_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "import jax.numpy",
                 "from repro.core import layout", "    import repro"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "import jaxlib_free"):
        assert not FORBIDDEN.search(line), line


def test_port_imports_without_jax_or_reference():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def _run_smoke(script: Path, cwd: Path):
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=cwd, timeout=120)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: chip_smoke.py would run")
    proc = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = _run_smoke(alone, tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
