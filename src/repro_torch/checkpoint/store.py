"""Checkpointing: save / restore, with async writes — the port of the
reference's ``repro/checkpoint/store.py``, in its on-disk format, so a
store written by either package restores in the other.

Layout (one directory per step):

    <dir>/step_000120/
        manifest.json        # tree structure, shapes, dtypes, step, meta
        leaf_00000.npy       # one file per tree leaf

Properties:
* **Atomic**: written to ``<dir>/.tmp_<step>`` then renamed — a crash
  mid-write never corrupts the latest checkpoint.
* **Async**: ``save(..., blocking=False)`` copies the leaves to the host on
  the caller's thread and hands them to a writer thread.
* **bfloat16**: numpy has no bfloat16.  A bf16 leaf is written as the
  reference's numpy writes an ``ml_dtypes`` bfloat16 array — header
  ``descr '<V2'``, the raw 2-byte values — with ``"dtype": "bfloat16"`` in
  the manifest, and restored from those bytes through ``int16`` as a
  ``torch.bfloat16`` tensor: bit for bit, never through float32.
* Leaves restore as CPU tensors; ``restore(..., device=)`` moves them.
  Restoring onto a mesh (the reference's ``shardings``) waits for the
  multi-chip slice (ROADMAP A10).
"""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"
# the .npy header descr numpy writes for an ml_dtypes bfloat16 array
_BF16_DESCR = "<V2"


def sha256_file(path: str | Path, chunk: int = 1 << 20) -> str:
    """Streaming SHA-256 of one file (constant memory for big blobs)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def dir_checksums(root: str | Path,
                  exclude: Tuple[str, ...] = ()) -> Dict[str, str]:
    """``{posix-relative-path: sha256}`` for every file under ``root``,
    sorted for a stable manifest encoding.  ``exclude`` names relative
    paths to skip (e.g. the manifest that will *hold* the checksums)."""
    root = Path(root)
    out: Dict[str, str] = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = p.relative_to(root).as_posix()
        if rel in exclude:
            continue
        out[rel] = sha256_file(p)
    return out


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _unflatten_like(template, leaves: Dict[str, Any], prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], leaves,
                                   f"{prefix}.{k}" if prefix else k)
                for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_like(v, leaves, f"{prefix}[{i}]")
                for i, v in enumerate(template)]
        if hasattr(template, "_fields"):
            return type(template)(*vals)
        return type(template)(vals)
    return leaves[prefix]


_STEP = re.compile(r"\.?([^.\[\]]+)|\[(\d+)\]")


def _path_keys(path: str) -> list:
    """``_flatten``'s path ``a.b[2].c`` as its keys ``["a", "b", 2, "c"]``."""
    keys, end = [], 0
    for m in _STEP.finditer(path):
        if m.start() != end:
            break
        keys.append(m.group(1) if m.group(2) is None else int(m.group(2)))
        end = m.end()
    if end != len(path) or not keys:
        raise ValueError(f"leaf path {path!r} is not a tree path")
    return keys


def unflatten_dicts(leaves: Dict[str, Any]) -> Dict[str, Any]:
    """The tree of ``_flatten``'s paths without a template: dicts from the
    dotted names, lists from the ``[i]`` indices (the LM parameter trees,
    whose hybrid and encdec layers are lists of dicts).  A list must hold
    every index from 0 up."""
    root: Dict[str, Any] = {}
    for path, leaf in leaves.items():
        *nodes, name = _path_keys(path)
        d = root
        for k in nodes:
            d = d.setdefault(k, {})
        d[name] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"list indices {sorted(node)} are not "
                                 "0..n-1")
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def _to_host(leaf, copy: bool) -> Tuple[np.ndarray, str]:
    """A leaf as C-ordered host values and its manifest dtype name; a
    bf16 tensor as its raw 2-byte values."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=copy)
    arr = np.ascontiguousarray(arr)
    return arr, str(arr.dtype)


def _write_leaf(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _read_leaf(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype != BF16:
        return torch.from_numpy(arr)
    if arr.dtype.itemsize != 2:
        raise ValueError(f"a bfloat16 leaf holds {arr.dtype.itemsize}-byte "
                         "values")
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


class CheckpointStore:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._writer: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, meta: Optional[Dict] = None,
             blocking: bool = True) -> None:
        # device->host copy happens on the caller's thread (cheap, ordered);
        # serialization happens on the writer thread if async, from a copy
        # the caller may overwrite meanwhile
        host_leaves = [(p, *_to_host(l, copy=not blocking))
                       for p, l in _flatten(tree)]

        def write():
            tmp = self.dir / f".tmp_{step:06d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "meta": meta or {}, "leaves": {}}
            for i, (path, arr, dtype) in enumerate(host_leaves):
                fname = f"leaf_{i:05d}.npy"
                _write_leaf(tmp / fname, arr, dtype)
                manifest["leaves"][path] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": dtype}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step:06d}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)

        self.wait()
        if blocking:
            write()
        else:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    # -- restore ----------------------------------------------------------------
    def steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore_flat(self, step: Optional[int] = None
                     ) -> Tuple[Dict[str, torch.Tensor], int, Dict]:
        """Load one step's leaves as a flat ``{path: CPU tensor}`` dict,
        without a structural template — the inference-artifact path
        (``engine/session.py``), where the tree structure is recorded in
        the artifact manifest rather than rebuilt from live objects."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:06d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except json.JSONDecodeError as e:
            raise ValueError(
                f"checkpoint manifest {d}/manifest.json is corrupt "
                f"(not valid JSON): {e}") from e
        leaves = {}
        for path, rec in manifest["leaves"].items():
            try:
                leaves[path] = _read_leaf(d / rec["file"], rec.get("dtype"))
            except (ValueError, OSError, EOFError) as e:
                # np.load on a truncated/garbled .npy raises a bare
                # ValueError — re-raise with the blob named so artifact
                # loaders can wrap it typed
                raise ValueError(
                    f"checkpoint leaf {d / rec['file']} (tree path "
                    f"{path!r}) is corrupt or truncated: {e}") from e
        return leaves, step, manifest["meta"]

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None, device=None) -> Tuple[Any, int, Dict]:
        """Load into the structure of ``template``, on ``device`` (default:
        the CPU).  ``shardings`` — re-laying leaves onto a mesh — waits
        for the multi-chip slice (ROADMAP A10)."""
        if shardings is not None:
            raise NotImplementedError(
                "restoring onto shardings waits for the multi-chip slice "
                "(ROADMAP A10); pass device= instead")
        leaves, step, meta = self.restore_flat(step)
        if device is not None:
            leaves = {p: t.to(device) for p, t in leaves.items()}
        return _unflatten_like(template, leaves), step, meta

    def delete(self, step: int) -> None:
        """Remove one step's directory (no-op if absent)."""
        self.wait()                      # never race an async writer
        d = self.dir / f"step_{step:06d}"
        if d.exists():
            shutil.rmtree(d)

    def prune(self, keep_last: int = 3) -> None:
        for s in self.steps()[:-keep_last]:
            self.delete(s)
