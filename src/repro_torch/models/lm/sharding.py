"""Sharding rules: parameters, activations and the mesh context — the port
of the reference's ``repro/models/lm/sharding.py``.

The mesh axes are fixed by the production topology: ``("data", "model")``
on one pod, ``("pod", "data", "model")`` on several
(``launch/mesh.py``).  Logical roles map onto them:

    batch            -> ("pod", "data")      (DP; pod axis is outer DP)
    tensor-parallel  -> "model"              (heads / d_ff / vocab)
    expert-parallel  -> "model"              (MoE expert axis)

Rules are divisibility-guarded: a dim that does not divide the axis size
is left unsharded (qwen2's 12 heads on a 16-way model axis fall back to
sequence-parallel attention with sharded d_ff).

A spec is what the reference's ``PartitionSpec`` holds, as a tuple with
one entry per tensor dim: ``None``, a mesh axis name, or a tuple of names
(major to minor).  :func:`placements` turns one into DTensor placements
over a ``torch.distributed.device_mesh.DeviceMesh``: ``Shard(d)`` on each
mesh dim of more than one rank that entry ``d`` names, ``Replicate()`` on
the rest.  DTensor
splits a dim sharded over several mesh dims in mesh-dim order, the
outermost first, which is JAX's major-to-minor order where the entry
lists its axes in the mesh's order (every rule here does); an entry that
does not is refused.

The spec functions take a ``DeviceMesh`` or, where no process group
stands behind the mesh, a ``{axis name: size}`` mapping.
:func:`shard_hint` and :func:`shard_attn_q` are the identity outside a
mesh (``use_mesh``) and for a plain tensor; under a mesh they
``redistribute`` a DTensor to the guarded placements, the counterpart of
the reference's ``with_sharding_constraint``.  Importing this module
touches no process group.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Sequence, Tuple

import torch

_state = threading.local()

BATCH = "batch"     # sentinel in specs, resolved to the context's DP axes
MODEL = "model"

Spec = Tuple


def current_mesh():
    return getattr(_state, "mesh", None)


def current_dp() -> Tuple[str, ...]:
    return getattr(_state, "dp", ("pod", "data"))


def current_strategy() -> str:
    return getattr(_state, "strategy", "tp")


@contextlib.contextmanager
def use_mesh(mesh, *, strategy: str = "tp"):
    """strategy "tp": the model axis carries tensor/expert parallelism.
    strategy "pure_dp": the model axis is folded into data parallelism,
    the right choice for models far below the TP-granularity threshold
    (whisper-tiny's 6 heads / d=384 on a 16-way axis)."""
    prev = (current_mesh(), current_dp(), current_strategy())
    _state.mesh = mesh
    _state.strategy = strategy
    _state.dp = ("pod", "data", "model") if strategy == "pure_dp" \
        else ("pod", "data")
    try:
        yield
    finally:
        _state.mesh, _state.dp, _state.strategy = prev


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh (or of such a mapping)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in current_dp() if a in names)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def guarded_spec(mesh, shape: Sequence[int], spec: Sequence) -> Spec:
    """Resolve the BATCH sentinel, drop absent mesh axes (a single-pod mesh
    has no "pod") and spec entries whose mesh-axis size does not divide
    the dim.  The BATCH entry sheds its outermost axes until it divides
    (long_500k's batch of 1 ends up replicated)."""
    names = mesh_axes(mesh)
    out = []
    used: set = set()
    for dim, axes in zip(shape, spec):
        if axes == BATCH:
            cand = tuple(a for a in current_dp()
                         if a in names and a not in used)
            while cand and dim % _axis_size(mesh, cand):
                cand = cand[1:]
            axes = cand or None
        if isinstance(axes, (tuple, list)):
            axes = tuple(a for a in axes
                         if a in names and a not in used) or None
        elif axes is not None and (axes not in names or axes in used):
            axes = None
        if axes is not None and dim % _axis_size(mesh, axes) == 0:
            out.append(axes)
            used.update((axes,) if isinstance(axes, str) else axes)
        else:
            out.append(None)
    return tuple(out)


def placements(mesh, spec: Sequence) -> Tuple:
    """DTensor placements over the DeviceMesh ``mesh`` for ``spec``:
    ``Shard(d)`` on every mesh dim that entry ``d`` names, ``Replicate()``
    on the others and on a mesh dim of size 1 (one shard is the whole
    dim; DTensor would refuse a view that drops a dim of size 1 sharded
    so, as the batch of 1 is on a 1 x 1 mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = list(mesh.mesh.shape)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(
                f"spec entry {axes} lists mesh axes out of the mesh's "
                f"order {tuple(names)}: DTensor splits a dim over several "
                "mesh dims outermost first")
        for m in dims:
            if sizes[m] > 1:
                out[m] = Shard(d)
    return tuple(out)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_hint(x: torch.Tensor, *spec) -> torch.Tensor:
    """Redistribute a DTensor to the guarded ``spec`` on the context's
    mesh.  The identity outside a mesh, and for a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    want = placements(mesh, guarded_spec(mesh, x.shape, spec))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def attn_q_spec(mesh, n_heads: int) -> Spec:
    """The activation spec of (B, H|Hkv, S, D) attention inputs: heads on
    the model axis when they divide it, else sequence-parallel (the kv
    side gathered, cheap under GQA/MQA).  The paper's per-op layout
    selection applied to the sharding tier."""
    if current_strategy() == "pure_dp":
        return (BATCH, None, None, None)
    if n_heads % mesh_axes(mesh)[MODEL] == 0:
        return (BATCH, MODEL, None, None)
    return (BATCH, None, MODEL, None)


def shard_heads(y: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, H*hd) projections about to be split into H heads: gathered
    on the model axis where H does not divide it (qwen2's 12 heads on 16;
    DTensor cannot split a dim sharded unevenly across the heads, where
    GSPMD reshards by itself).  The identity outside a mesh."""
    mesh = current_mesh()
    if mesh is None or n_heads % mesh_axes(mesh).get(MODEL, 1) == 0:
        return y
    return shard_hint(y, BATCH, None, None)


def attn_kernel_spec(mesh, n_heads: int, n_kv: int) -> Spec:
    """The spec that B3 runs its q, k and v under: heads on the model axis
    where both the query and the kv heads divide it, so that each shard's
    attention is local; otherwise the model axis gathers them (the
    sequence-parallel branch: a local q shard would need its global row
    offset for the causal and window masks, which B3 does not take)."""
    m = mesh_axes(mesh).get(MODEL, 1)
    if (current_strategy() != "pure_dp" and n_heads % m == 0
            and n_kv % m == 0):
        return (BATCH, MODEL, None, None)
    return (BATCH, None, None, None)


def shard_attn_q(q: torch.Tensor, n_heads: int) -> torch.Tensor:
    mesh = current_mesh()
    if mesh is None:
        return q
    return shard_hint(q, *attn_q_spec(mesh, n_heads))


def local_kernel(fn, args: Sequence[torch.Tensor], specs: Sequence[Spec],
                 out_like=0):
    """``fn(*args)``, where under a mesh DTensor ``args`` run on their
    local shards (``local_map``): each arg redistributed to the guarded
    spec beside it, the output placed as arg ``out_like`` is (a tuple of
    indices: one a tensor of the tuple ``fn`` returns).  The kernels'
    wrappers take plain tensors, so every call of B2, B3 and B4 on a
    DTensor goes through here, as do the einsums around them that
    DTensor's sharding propagation would take minutes to place.

    Gradients: an arg replicated on a mesh dim that another arg is
    sharded on (a parameter beside activations sharded on the batch: the
    MoE router beside the tokens, mamba2's ``a_log`` beside the SSD's
    rows) takes part in every shard's computation, so each rank holds
    only its rows' share of that arg's gradient.  Its gradient is marked
    ``Partial()`` (a sum) on those mesh dims, and DTensor sums it over
    them where it is read.  Every other arg's gradient is placed as the
    arg is."""
    mesh = current_mesh()
    if mesh is None or not any(_is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    ins = tuple(placements(mesh, guarded_spec(mesh, a.shape, s))
                for a, s in zip(args, specs))
    outs = tuple(ins[i] for i in out_like) if isinstance(out_like, tuple) \
        else (ins[out_like],)
    sharded = [any(p[m].is_shard() for p in ins)
               for m in range(len(mesh.mesh_dim_names))]
    grads = tuple(tuple(Partial() if sharded[m] and q.is_replicate() else q
                        for m, q in enumerate(p)) for p in ins)
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def batch_spec(mesh, batch: int):
    """The DP axes that divide this batch (long_500k's batch of 1
    replicates)."""
    axes = dp_axes(mesh)
    while axes and batch % _axis_size(mesh, axes):
        axes = axes[1:]    # drop the outermost ("pod") first
    return tuple(axes) if axes else None


def leaf_spec(mesh, shape: Sequence[int], batch: int) -> Spec:
    """An input's or a cache leaf's spec: its first dim of size ``batch``
    on the DP axes, then its largest dim that the model axis divides on
    "model", guarded."""
    spec = [None] * len(shape)
    bspec = batch_spec(mesh, batch)
    for i, d in enumerate(shape):
        if bspec and d == batch and batch > 1:
            spec[i] = bspec
            break
    m = mesh_axes(mesh).get(MODEL, 1)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if spec[i] is None and shape[i] % m == 0 and shape[i] >= m:
            spec[i] = MODEL
            break
    return guarded_spec(mesh, shape, spec)


def distribute_like_inputs(tree, batch: int):
    """Every plain tensor of ``tree`` as a DTensor over the context's mesh
    under :func:`leaf_spec` (a prefill's fresh cache); the tree itself
    outside a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return tree
    from torch.distributed.tensor import distribute_tensor

    return map_with_paths(
        lambda _, t: t if _is_dtensor(t) else distribute_tensor(
            t, mesh, placements(mesh, leaf_spec(mesh, t.shape, batch)),
            src_data_rank=None),
        tree)


# ---------------------------------------------------------------------------
# Parameter shardings by name pattern
# ---------------------------------------------------------------------------

def _param_spec(path: str, shape: Tuple[int, ...]) -> list:
    """Logical spec (before the divisibility guard).  Stacked leaves have a
    leading L dim (never sharded)."""
    nd = len(shape)
    mp = MODEL

    def tail(spec2):   # pad leading dims (layer stack) with None
        return [None] * (nd - len(spec2)) + list(spec2)

    if "embed" in path:
        return tail([mp, None])          # (V, d): shard vocab
    if "lm_head" in path:
        return tail([None, mp])          # (d, V)
    if any(k in path for k in ("wq", "wk", "wv")):
        return tail([None, mp])          # (d, H*hd): shard heads*dim
    if path.endswith("wo") or ".wo" in path:
        return tail([mp, None])          # (H*hd, d)
    if "router" in path:
        return tail([None, mp])          # (d, E)
    if "experts" in path:
        # (E, d, f) / (E, f, d): expert-parallel on E
        return tail([mp] + [None] * (min(nd, 3) - 1))
    if any(k in path for k in ("wg", "wu")):
        return tail([None, mp])          # (d, ff)
    if path.endswith("wd") or ".wd" in path:
        return tail([mp, None])          # (ff, d)
    if "in_proj" in path or "out_proj" in path or path.endswith("wx") \
            or path.endswith("wy"):
        return tail([None, mp])          # ssm/hybrid projections
    if nd >= 2 and any(k in path for k in ("w_gates", "w_in_gate",
                                           "w_rec_gate")):
        # RG-LRU gate weights: shard the output dim, so the block needs
        # one all-gather of y, not an all-reduce of a (B, T, 2W) product
        return tail([None, mp])
    return [None] * nd                   # norms, biases, conv, gates


def is_spec(x) -> bool:
    """A spec is a plain tuple; a tree's tuples are NamedTuples."""
    return type(x) is tuple


def _is_node(x, specs: bool) -> bool:
    if isinstance(x, dict):
        return True
    return isinstance(x, (list, tuple)) and not (specs and is_spec(x))


def flatten_with_paths(tree, prefix="", specs: bool = False):
    """(dotted path, leaf) pairs of a tree of dicts, lists and
    NamedTuples, under the reference's path names (``layers.attn.wq``,
    ``layers_list[2].rec.wx``).  ``specs``: the leaves are specs."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_with_paths(
                v, f"{prefix}.{k}" if prefix else k, specs)
    elif _is_node(tree, specs):
        for i, v in enumerate(tree):
            yield from flatten_with_paths(v, f"{prefix}[{i}]", specs)
    else:
        yield prefix, tree


def map_with_paths(fn, tree, prefix=""):
    """``tree`` (of tensors) with every leaf replaced by ``fn(path,
    leaf)``; dicts, lists and NamedTuples keep their type."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [map_with_paths(fn, v, f"{prefix}[{i}]")
             for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):     # NamedTuple (AdamWState)
            return type(tree)(*t)
        return type(tree)(t)
    return fn(prefix, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape)


def param_shardings(mesh, params_shape, strategy: str = "tp",
                    fsdp_axes: Tuple[str, ...] = ()):
    """Tree of specs matching ``params_shape`` (a tree of tensors, meta
    tensors included).  strategy "pure_dp" replicates every parameter
    (the gradient all-reduce is the only collective).  ``fsdp_axes`` also
    shards each leaf's largest remaining dim over those axes (ZeRO-3-style
    weight sharding; the redistributions gather it per use)."""
    names = mesh_axes(mesh)

    def one(path, leaf):
        shape = _shape(leaf)
        spec = [None] * len(shape) if strategy == "pure_dp" \
            else _param_spec(path, shape)
        p = guarded_spec(mesh, shape, spec)
        if fsdp_axes:
            entries = list(p) + [None] * (len(shape) - len(p))
            axes = tuple(a for a in fsdp_axes if a in names)
            n = _axis_size(mesh, axes)
            cands = [(d, i) for i, (d, s) in enumerate(zip(shape, entries))
                     if s is None and d % n == 0 and d >= n and n > 1]
            if cands:
                _, i = max(cands)
                entries[i] = axes
                p = tuple(entries)
        return p

    return map_with_paths(one, params_shape)


def zero_shardings(mesh, params_shape, strategy: str = "tp"):
    """ZeRO-style optimizer-state sharding: also shard the largest
    remaining unsharded dim over the DP axes where they divide it (the
    distributed-optimizer trick; else the parameter's spec)."""
    base = param_shardings(mesh, params_shape, strategy=strategy)
    dp = dp_axes(mesh)
    dp_n = _axis_size(mesh, dp)
    flat_base = dict(flatten_with_paths(base, specs=True))

    def one(path, leaf):
        shape = _shape(leaf)
        spec_t = flat_base[path]
        spec = list(spec_t) + [None] * (len(shape) - len(spec_t))
        if not dp or dp_n <= 1:
            return spec_t
        cands = [(d, i) for i, (d, s) in enumerate(zip(shape, spec))
                 if s is None and d % dp_n == 0]
        if not cands:
            return spec_t
        _, i = max(cands)
        spec[i] = dp if len(dp) > 1 else dp[0]
        return tuple(spec)

    return map_with_paths(one, params_shape)


def distribute(tree, specs, mesh):
    """Every tensor of ``tree`` as a DTensor over ``mesh`` under the spec
    at the same path of ``specs``: each rank keeps its own shard of the
    full tensor it is given (``src_data_rank=None``: no data moves, so
    every rank must hold the same tree); a meta tensor stays meta."""
    from torch.distributed.tensor import distribute_tensor

    flat = dict(flatten_with_paths(specs, specs=True))
    return map_with_paths(
        lambda path, t: distribute_tensor(t, mesh,
                                          placements(mesh, flat[path]),
                                          src_data_rank=None),
        tree)
