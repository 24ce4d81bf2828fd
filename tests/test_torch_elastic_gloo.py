"""The elastic restart over ``gloo`` processes: ``CheckpointStore.save``
of a sharded (parameters, AdamW state) and ``restore(shardings=)`` onto a
smaller mesh, as the reference's ``restore(..., shardings)`` re-lays a
checkpoint after a topology change.

* Four processes (a 2 x 2 ("data", "model") mesh) take one
  ``launch.dryrun.make_train_step`` of reduced qwen2 and mamba2 on
  DTensors and save the state (every rank gathers each leaf, rank 0
  writes).
* Two processes restore it onto the mesh that ``plan_elastic_mesh``
  plans for two devices at a model axis of 2 ((1, 2)), under
  ``param_shardings`` and ``zero_shardings`` of that mesh: every local
  shard equals its rows of the saved leaf (``torch.chunk`` along each
  sharded dim, the outer mesh dim first), and the next step on the
  restored DTensors equals the unsharded step from the same checkpoint
  (parameters within 2 lr + 1e-6 of the leaf's largest value, the loss
  within rtol 1e-5).
* The same for a store that the reference wrote from the same weights
  (``repro.checkpoint.CheckpointStore`` of its ``AdamW`` state).
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import CheckpointStore as RStore
from repro.optim import AdamW as RAdamW
from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import _flatten
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.launch import dryrun
from repro_torch.models.lm.model import init_params
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime import plan_elastic_mesh
from test_torch_dp_train_gloo import (BATCH, LR, SEQ, assert_params_close,
                                      finish, free_port,
                                      one_torch_thread, spawn)  # noqa: F401

FAMILIES = ("qwen2-1.5b", "mamba2-130m")

_WORKER = '''
import sys, torch
import torch.distributed as dist
import torch.multiprocessing as mp


def batch_of(cfg, step):
    from repro_torch.data import DataConfig, SyntheticLMStream
    data = SyntheticLMStream(DataConfig(BATCH, SEQ, cfg.vocab),
                             cfg).global_batch(step)
    return {k: torch.from_numpy(v) for k, v in data.items()}


def placed(mesh, batch):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.lm import sharding as sh
    return {k: distribute_tensor(v, mesh, sh.placements(
        mesh, sh.leaf_spec(mesh, v.shape, v.shape[0])), src_data_rank=None)
        for k, v in batch.items()}


def rows(full, dt, mesh):
    """This rank's rows of ``full`` under ``dt``'s placements."""
    coord = mesh.get_coordinate()
    for m, p in enumerate(dt.placements):
        if p.is_shard():
            full = torch.chunk(full, mesh.size(m), dim=p.dim)[coord[m]]
    return full


def save_sharded(rank, work, port):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import sharding as sh
    from repro_torch.optim import AdamW

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for name, (cfg, params) in torch.load(
                work + "/cases.pt", weights_only=False).items():
            opt = AdamW(lr=LR)
            with sh.use_mesh(mesh), implicit_replication():
                dp = sh.distribute(params, sh.param_shardings(mesh, params),
                                   mesh)
                state = opt.init(params)
                ds = sh.distribute(state, sh.zero_shardings(mesh, state),
                                   mesh)
                p1, s1, _ = dryrun.make_train_step(cfg, opt)(
                    dp, ds, placed(mesh, batch_of(cfg, 0)))
                CheckpointStore(f"{work}/{name}").save(1, (p1, s1))
            dist.barrier()
    finally:
        dist.destroy_process_group()


def restore_elastic(rank, work, port, shape):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import sharding as sh
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_map

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        out = {}
        for name, (cfg, params) in torch.load(
                work + "/cases.pt", weights_only=False).items():
            opt = AdamW(lr=LR)
            template = (params, opt.init(params))
            for src in ("port", "ref"):
                store = CheckpointStore(f"{work}/{name}" if src == "port"
                                        else f"{work}/{name}-ref")
                full, step, _ = store.restore_flat()
                with sh.use_mesh(mesh), implicit_replication():
                    shardings = (sh.param_shardings(mesh, params),
                                 sh.zero_shardings(mesh, template[1]))
                    (p, s), got_step, _ = store.restore(
                        template, shardings=shardings)
                    leaves = list(_flatten((p, s)))
                    same = [isinstance(t, DTensor) and torch.equal(
                        t.to_local(), rows(full[path], t, mesh))
                        for path, t in leaves]
                    split = sum(t.to_local().numel() < t.numel()
                                for _, t in leaves)
                    p2, _, loss = dryrun.make_train_step(cfg, opt)(
                        p, s, placed(mesh, batch_of(cfg, step)))
                    out[name, src] = {
                        "step": got_step, "shards_equal": all(same),
                        "leaves": len(leaves), "split": split,
                        "loss": loss.full_tensor() if isinstance(
                            loss, DTensor) else loss,
                        "params": tree_map(lambda t: t.full_tensor(), p2)}
        if rank == 0:
            torch.save(out, work + "/restored.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    work, port1, port2 = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    mp.spawn(save_sharded, args=(work, port1), nprocs=4)
    shape = tuple(int(x) for x in sys.argv[4].split("x"))
    mp.spawn(restore_elastic, args=(work, port2, shape), nprocs=2)
'''


def _batch(cfg, step):
    data = SyntheticLMStream(DataConfig(BATCH, SEQ, cfg.vocab),
                             cfg).global_batch(step)
    return {k: torch.from_numpy(v) for k, v in data.items()}


def test_elastic_restore_onto_two_gloo_processes(tmp_path):
    shape = plan_elastic_mesh(2, model_axis=2)
    assert shape == (1, 2)
    cases, want = {}, {}
    for name in FAMILIES:
        cfg = reduced(ARCHS[name])
        params = init_params(cfg, 0, "cpu")
        cases[name] = (cfg, params)
        # the reference's store of the same weights and a fresh AdamW
        r_p = tree_map(lambda t: jnp.asarray(t.numpy()), params)
        RStore(tmp_path / f"{name}-ref").save(0, (r_p, RAdamW(lr=LR).init(
            r_p)))
    torch.save(cases, tmp_path / "cases.pt")
    script = f"BATCH, SEQ, LR = {BATCH}, {SEQ}, {LR}\n" + _WORKER
    finish(spawn(script, tmp_path, str(free_port()),
                 "x".join(map(str, shape))))
    out = torch.load(tmp_path / "restored.pt")
    opt = AdamW(lr=LR)
    for name, (cfg, params) in cases.items():
        for src, step in (("port", 1), ("ref", 0)):
            got = out[name, src]
            assert got["step"] == step and got["shards_equal"], (name, src)
            assert got["split"] > 0 and got["leaves"] == 3 * len(
                list(_flatten(params))) + 1
            store = CheckpointStore(tmp_path / (
                name if src == "port" else f"{name}-ref"))
            (p, s), _, _ = store.restore((params, opt.init(params)))
            p2, _, loss = dryrun.make_train_step(cfg, opt)(
                p, s, _batch(cfg, step))
            np.testing.assert_allclose(float(got["loss"]), float(loss),
                                       rtol=1e-5)
            assert_params_close(
                {k: v.numpy() for k, v in _flatten(got["params"])},
                {k: v.numpy() for k, v in _flatten(p2)})
