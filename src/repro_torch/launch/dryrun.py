"""Multi-pod dry run: every (arch x shape x mesh) cell over meta DTensors —
the port of the reference's ``repro/launch/dryrun.py``.

For each cell:
  * parameters and optimizer state on the ``meta`` device (shapes, no
    storage), made DTensors under the rule engine's placements
    (``models/lm/sharding.py``: ``param_shardings``, ``zero_shardings``);
  * the inputs from ``configs.input_specs``, placed by ``batch_shardings``;
  * the step run once on the production mesh, over a ``"fake"`` process
    group that stands in for its 256 or 512 devices in this one process
    (``launch/mesh.py``), under a ``CommDebugMode`` that records every
    collective DTensor issues;
  * the record written to ``dryrun_out/*.json`` at the repo's root.

What stands in for the reference's figures:
  * ``lower_s``: the seconds to build the mesh, the meta parameters, the
    optimizer state and the inputs and to place them; ``run_s`` the
    seconds of the step itself.  There is no compile step, so
    ``compile_s`` is ``null``;
  * ``memory`` (XLA's ``memory_analysis()``: argument, output, temp and
    code bytes) has no counterpart and stays ``null`` key by key; what
    one device holds is ``device_bytes``, the bytes of the local shards of
    the parameters, the optimizer state, the inputs and the outputs;
  * FLOPs and heavy bytes come from ``analysis.flops.count_costs`` of the
    unsharded step, as the reference counts its global program;
  * the collectives (XLA's HLO, parsed) are those the step dispatched, by
    kind, each one's bytes the sum of its operands' local sizes
    (``analysis.roofline.CollectiveCounter``); ``ca_*`` (XLA's
    ``cost_analysis()``) stay 0.

A failure (a sharding mismatch, an op DTensor cannot place) is recorded
with its traceback and the sweep goes on, as in the reference.  Importing
this module starts no process group and touches no CUDA state.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.flops import count_costs
from repro_torch.configs import ARCHS, SHAPES, applicable, input_specs
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD,
                                     fake_process_group,
                                     make_production_mesh)
from repro_torch.launch.train import loss_and_grads
from repro_torch.models.lm import model
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.sharding import (distribute, leaf_spec,
                                            map_with_paths, param_shardings,
                                            use_mesh, zero_shardings)
from repro_torch.optim.adamw import AdamW, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"


# ---------------------------------------------------------------------------
# Step functions (what production would run)
# ---------------------------------------------------------------------------

def make_train_step(cfg: LMConfig, opt: AdamW, microbatch: int = 1,
                    grad_dtype=torch.float32):
    """``train_step(params, opt_state, batch)`` -> ``(params, opt_state,
    loss)``.  ``microbatch > 1``: gradient accumulation over that many
    slices of the batch (the reference's ``lax.scan``), each through
    ``loss_fn`` under autograd (the kernels' autograd Functions); the
    activations of one slice at a time, the same FLOPs.  Gradients are
    summed in ``grad_dtype`` and divided by ``microbatch``, as is the
    fp32 loss."""
    def train_step(params, opt_state, batch):
        if microbatch == 1:
            loss, grads = loss_and_grads(params, cfg, batch)
        else:
            def split(x):
                return x.reshape((microbatch, x.shape[0] // microbatch)
                                 + tuple(x.shape[1:]))

            mb = {k: split(v) for k, v in batch.items()}
            loss = None
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=grad_dtype),
                             params)
            for i in range(microbatch):
                l_i, g = loss_and_grads(params, cfg,
                                        {k: v[i] for k, v in mb.items()})
                grads = tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
                loss = l_i.float() if loss is None else loss + l_i.float()
            loss = loss / microbatch
            grads = tree_map(lambda g: g / microbatch, grads)
        new_params, new_state, _ = opt.update(grads, opt_state, params)
        return new_params, new_state, loss
    return train_step


def make_prefill(cfg: LMConfig, seq: int):
    def prefill_step(params, batch):
        return model.prefill(params, cfg, batch["tokens"], max_len=seq,
                             img_embeds=batch.get("img_embeds"),
                             frames=batch.get("frames"))
    return prefill_step


def make_serve_step(cfg: LMConfig):
    def serve_step(params, token, cache, pos):
        return model.decode_step(params, cfg, token, cache, pos)
    return serve_step


# ---------------------------------------------------------------------------
# Input shardings
# ---------------------------------------------------------------------------

def _leaf_sharding(mesh, leaf, batch: int):
    """Batch dim -> DP axes; then the largest model-divisible dim ->
    model (``sharding.leaf_spec``)."""
    return leaf_spec(mesh, tuple(leaf.shape), batch)


def batch_shardings(mesh, tree, batch: int):
    """The spec of every leaf of ``tree`` (dicts and lists of tensors)."""
    return map_with_paths(lambda _, leaf: _leaf_sharding(mesh, leaf, batch),
                          tree)


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _leaves(tree):
        local = t.to_local() if isinstance(t, DTensor) else t
        total += local.numel() * local.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@contextlib.contextmanager
def _world(n: int):
    """A fake process group of ``n`` ranks for the cell, or the one the
    caller initialised (which must be ``n`` ranks)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"the initialised process group has "
                               f"{dist.get_world_size()} ranks; the cell's "
                               f"mesh spans {n}")
        yield
        return
    with fake_process_group(n):
        yield


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True, *, cfg: LMConfig = None,
             microbatch: int = 1, fsdp_axes=(), opt: AdamW = None,
             tag: str = "", mesh_shape=None) -> dict:
    """Run one cell and return its record.  ``mesh_shape`` replaces the
    production mesh with a smaller one of the same axes (2 dims:
    ("data", "model"), 3: ("pod", "data", "model"))."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg or ARCHS[arch]
    shape = SHAPES[shape_name]
    if mesh_shape is None:
        dims = (MULTI_POD if multi_pod else SINGLE_POD)[0]
    else:
        dims = tuple(mesh_shape)
    mesh_name = "x".join(str(d) for d in dims)
    ok, why = applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "skipped", "reason": why, "tag": tag}
    if not ok:
        return rec

    t0 = time.time()
    with _world(math.prod(dims)):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod)
        else:
            names = (MULTI_POD if len(dims) == 3 else SINGLE_POD)[1]
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        chips = mesh.size()
        params = model.init_params(cfg, 0, "meta")
        specs = input_specs(cfg, shape)
        with use_mesh(mesh, strategy=cfg.shard_strategy):
            dparams = distribute(
                params, param_shardings(mesh, params,
                                        strategy=cfg.shard_strategy,
                                        fsdp_axes=tuple(fsdp_axes)), mesh)
            if shape.kind == "train":
                opt = opt or AdamW()
                opt_state = opt.init(params)
                dopt = distribute(opt_state, zero_shardings(
                    mesh, opt_state, strategy=cfg.shard_strategy), mesh)
                dbatch = distribute(
                    specs, batch_shardings(mesh, specs, shape.batch), mesh)
                grad_dt = getattr(torch, cfg.dtype) if microbatch > 1 \
                    else torch.float32
                step = make_train_step(cfg, opt, microbatch=microbatch,
                                       grad_dtype=grad_dt)
                step_args = (dparams, dopt, dbatch)
                plain_args = (params, opt_state, specs)
            elif shape.kind == "prefill":
                dbatch = distribute(
                    specs, batch_shardings(mesh, specs, shape.batch), mesh)
                step = make_prefill(cfg, shape.seq)
                step_args = (dparams, dbatch)
                plain_args = (params, specs)
            else:
                # pos: the cache's last position (a full-length read)
                tok, cache = specs["token"], specs["cache"]
                step = make_serve_step(cfg)
                step_args = (dparams,
                             distribute(tok, batch_shardings(
                                 mesh, tok, shape.batch), mesh),
                             distribute(cache, batch_shardings(
                                 mesh, cache, shape.batch), mesh),
                             shape.seq - 1)
                plain_args = (params, tok, cache, shape.seq - 1)
            t_lower = time.time() - t0

            t0 = time.time()
            with rl.CollectiveCounter() as comm, implicit_replication():
                out = step(*step_args)
            t_run = time.time() - t0
            device_bytes = {"params": _local_bytes(step_args[0]),
                            "inputs": _local_bytes(step_args[1:]),
                            "outputs": _local_bytes(out)}

    # exact structural FLOPs / bytes of the global (unsharded) step
    jx = count_costs(step, *plain_args)
    coll = comm.collective_bytes()
    report = rl.RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=jx["flops"] / chips,
        bytes_per_device=jx["heavy_bytes"] / chips,
        collective_bytes_per_device=float(coll["total"]),
        collectives=dict(comm.counts),
        model_flops_total=rl.model_flops(cfg, shape.kind, shape.batch,
                                         shape.seq),
        model_bytes_total=rl.model_bytes(cfg, shape.kind, shape.batch,
                                         shape.seq))
    rec.update(
        status="ok",
        lower_s=round(t_lower, 1), compile_s=None, run_s=round(t_run, 1),
        memory={"argument_bytes": None, "output_bytes": None,
                "temp_bytes": None, "code_bytes": None},
        device_bytes=device_bytes,
        collective_bytes=coll,
        roofline=report.to_dict(),
    )
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] OK "
              f"lower={t_lower:.0f}s run={t_run:.0f}s "
              f"flops/dev={report.flops_per_device:.3e} "
              f"coll/dev={coll['total']:.3e}B "
              f"bottleneck={report.bottleneck} "
              f"roofline={report.roofline_fraction:.3f}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                tag = f"{arch}__{shape}__{mesh_name}"
                path = outdir / f"{tag}.json"
                if path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[{tag}] cached ({prev['status']})",
                              flush=True)
                        n_ok += prev["status"] == "ok"
                        n_skip += prev["status"] == "skipped"
                        continue
                    path.unlink()     # retry failures
                try:
                    rec = run_cell(arch, shape, mp)
                    if rec["status"] == "ok":
                        n_ok += 1
                    else:
                        n_skip += 1
                        print(f"[{tag}] SKIPPED: {rec['reason']}",
                              flush=True)
                except Exception as e:   # noqa: BLE001 — record, move on
                    n_fail += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "failed", "error": str(e),
                           "traceback": traceback.format_exc()}
                    print(f"[{tag}] FAILED: {e}", flush=True)
                path.write_text(json.dumps(rec, indent=1))
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed", flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
