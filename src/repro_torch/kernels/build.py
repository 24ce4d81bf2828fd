"""Build and load the port's CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C entry; it may
include headers of ``csrc/`` (``#include "<header>.cuh"``).  It is
compiled on first use with ``nvcc`` for ``sm_90a`` into ``_build/`` of this
package (listed in ``.gitignore``) as a shared library keyed by the content
of the source and of every header it includes, and the flags, and loaded
with ``ctypes``.  Nothing is built when a module is imported.

Each wrapper counts its launches in attributes of its function
(``launches``, ``launches_by_route``) through :func:`count_launch`, and
the backwards of its autograd Function (``backward_calls``) through
:func:`count_backward`; both add under one lock: serving workers launch
from several threads at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Sequence

from repro_torch import trace

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the devices on which a wrapper takes its kernel's plain version instead of
# launching: the CPU, and ``meta`` (shapes alone, as ``analysis.flops``
# counts a model at full width: nothing is launched or allocated there)
PLAIN_DEVICES = ("cpu", "meta")

_loaded: dict = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the port's CUDA kernels")
    return found


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly
    or through another header, each once, in the order first reached."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [path.parent / inc for inc in
                 _INCLUDE.findall(path.read_text())
                 if (path.parent / inc).is_file()]
    return out


def digest(name: str) -> str:
    """The key of kernel ``name``'s build: its source, its headers and the
    flags."""
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` (once per source and flags) and return
    ``{"path", "seconds", "ptxas"}``: the shared library, the build's
    wall-clock seconds (0.0 when it was already built) and nvcc's
    ``-Xptxas -v`` report of registers, shared memory and spills.
    Builds of different sources may run in parallel threads."""
    source = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"{name}-{digest(name)}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return {"path": lib, "seconds": 0.0, "ptxas": log.read_text()}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)          # atomic: a concurrent build sees all or none
    return {"path": lib, "seconds": seconds, "ptxas": log.read_text()}


def entry(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel ``name``, built and loaded on
    first use, with its ``argtypes`` declared and an ``int`` (the
    ``cudaError_t`` of the launch) as its result.  Loading a library is
    one cold ``kernel.load`` span (``repro_torch.trace``), noted with
    ``built`` and the build's ``seconds``, and counts in ``kernels_loaded``
    (and ``kernels_built`` where ``nvcc`` ran)."""
    key = (name, symbol)
    fn = _loaded.get(key)
    if fn is None:
        with _lock:
            fn = _loaded.get(key)
            if fn is None:
                lib = _loaded.get(name)
                if lib is None:
                    lib = _load(name)
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _loaded[name] = lib       # keep the library loaded
                _loaded[key] = fn
    return fn


def _load(name: str) -> ctypes.CDLL:
    """Build (where needed) and load kernel ``name``'s library."""
    with trace.span("kernel.load", name) as i:
        built = build(name)
        lib = ctypes.CDLL(str(built["path"]))
        trace.note(i, built=built["seconds"] > 0,
                       seconds=built["seconds"])
    trace.count("kernels_loaded")
    if built["seconds"] > 0:
        trace.count("kernels_built")
    return lib


def count_launch(fn, route=None) -> None:
    """One launch of ``fn``'s kernel: add one to ``fn.launches`` and, with
    a ``route``, to ``fn.launches_by_route[route]``, atomically."""
    with _count_lock:
        fn.launches += 1
        if route is not None:
            fn.launches_by_route[route] += 1


def count_backward(fn, route: str) -> None:
    """One backward of ``fn``'s autograd Function whose forward took
    ``route``: add one to ``fn.backward_calls[route]``, atomically."""
    with _count_lock:
        fn.backward_calls[route] += 1
