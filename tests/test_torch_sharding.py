"""``models/lm/sharding.py`` and ``launch/mesh.py`` against the reference's
``repro/models/lm/sharding.py``.

The rules are compared entry by entry with the reference's
``PartitionSpec``s, on the reference's ``AbstractMesh`` (16 x 16 and
2 x 16 x 16) and the port's mesh over a ``"fake"`` process group of the
same shape (one process standing in for 256 or 512 devices), for every
arch at full width: the parameters as meta tensors in the port and
``jax.eval_shape`` stand-ins in the reference.  ``PartitionSpec`` writes a
one-name tuple as the name, so entries are compared that way.  A dim
sharded over two mesh axes is also checked by the rows each rank holds:
DTensor's shard against the device's rows in JAX's ``NamedSharding`` over
8 forced host devices (a child process).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as R_ARCHS
from repro.models.lm import model as r_model
from repro.models.lm import sharding as rs
from repro.optim import AdamW as RAdamW
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import (fake_process_group, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.lm import model
from repro_torch.models.lm import sharding as ts
from repro_torch.optim import AdamW

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _r_specs(tree):
    return {p: _norm(tuple(s.spec))
            for p, s in rs._flatten_with_paths(tree)}


def _t_specs(tree):
    return {p: _norm(s) for p, s in ts.flatten_with_paths(tree, specs=True)}


@pytest.fixture(scope="module")
def shapes():
    """Every arch's parameters: meta tensors (port), stand-ins (ref)."""
    out = {}
    for a in sorted(ARCHS):
        r = jax.eval_shape(lambda k, c=R_ARCHS[a]: r_model.init_params(c, k),
                           jax.random.PRNGKey(0))
        out[a] = (model.init_params(ARCHS[a], 0, "meta"), r)
    return out


def test_param_spec_patterns():
    """The reference's ``test_param_spec_patterns``."""
    assert ts._param_spec("embed", (1000, 64))[0] == "model"
    assert ts._param_spec("layers.attn.wq", (4, 64, 128))[-1] == "model"
    assert ts._param_spec("layers.attn.wo", (4, 128, 64))[-2] == "model"
    assert ts._param_spec("layers.moe.experts.wu", (4, 8, 64, 96))[1] \
        == "model"
    assert ts._param_spec("layers.mlp.wd", (4, 96, 64))[-2] == "model"
    assert ts._param_spec("layers_list[0].rec.w_gates", (64, 128))[-1] \
        == "model"
    assert ts._param_spec("final_norm.w", (64,)) == [None]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_spec_of_every_leaf_is_the_references(shapes, arch):
    t, r = shapes[arch]
    r_leaves = dict(rs._flatten_with_paths(r))
    t_leaves = dict(ts.flatten_with_paths(t))
    assert sorted(t_leaves) == sorted(r_leaves)
    for path, leaf in t_leaves.items():
        assert tuple(leaf.shape) == tuple(r_leaves[path].shape), path
        assert ts._param_spec(path, tuple(leaf.shape)) == rs._param_spec(
            path, r_leaves[path].shape), path


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("strategy", ["tp", "pure_dp"])
def test_guarded_and_batch_specs_match(mesh_name, strategy):
    dims, names = MESHES[mesh_name]
    r_mesh = AbstractMesh(dims, names)
    t_mesh = dict(zip(names, dims))
    cases = [((256, 4096), (ts.BATCH, None)), ((1, 4096), (ts.BATCH, None)),
             ((32, 128, 1536), (ts.BATCH, None, ts.MODEL)),
             ((12, 2048, 128), (None, ts.MODEL, None)),
             ((8, 16, 1024), (ts.MODEL, ts.BATCH, None)),
             ((64, 12, 2048, 128), (ts.BATCH, ts.MODEL, None, None)),
             ((64, 12, 2048, 128), (ts.BATCH, None, ts.MODEL, None)),
             ((48, 7), (("pod", "data"), ts.MODEL)),
             ((3, 32), (ts.MODEL, ("data",)))]
    with rs.use_mesh(r_mesh, strategy=strategy), \
            ts.use_mesh(t_mesh, strategy=strategy):
        for shape, spec in cases:
            assert _norm(ts.guarded_spec(t_mesh, shape, spec)) == _norm(
                tuple(rs.guarded_spec(r_mesh, shape, spec))), shape
        for batch in (1, 2, 16, 32, 128, 256, 512, 3):
            assert ts.batch_spec(t_mesh, batch) == rs.batch_spec(r_mesh,
                                                                  batch)
        assert ts.dp_axes(t_mesh) == rs.dp_axes(r_mesh)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [(), ("pod", "data")])
def test_param_shardings_match_for_every_arch(shapes, mesh_name, fsdp):
    """On the fake group's DeviceMesh, every arch at full width."""
    dims, names = MESHES[mesh_name]
    r_mesh = AbstractMesh(dims, names)
    with fake_process_group(int(np.prod(dims))):
        t_mesh = (make_production_mesh(multi_pod=len(dims) == 3))
        assert ts.mesh_axes(t_mesh) == dict(zip(names, dims))
        for arch, (t, r) in shapes.items():
            strategy = ARCHS[arch].shard_strategy
            got = _t_specs(ts.param_shardings(t_mesh, t, strategy=strategy,
                                              fsdp_axes=fsdp))
            want = _r_specs(rs.param_shardings(r_mesh, r, strategy=strategy,
                                               fsdp_axes=fsdp))
            assert got == want, arch
            pure = _t_specs(ts.param_shardings(t_mesh, t,
                                               strategy="pure_dp"))
            assert pure == _r_specs(rs.param_shardings(
                r_mesh, r, strategy="pure_dp")), arch


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("strategy", ["tp", "pure_dp"])
def test_zero_shardings_match_for_every_arch(shapes, mesh_name, strategy):
    dims, names = MESHES[mesh_name]
    r_mesh = AbstractMesh(dims, names)
    t_mesh = dict(zip(names, dims))
    for arch, (t, r) in shapes.items():
        t_opt = AdamW().init(t)
        r_opt = jax.eval_shape(RAdamW().init, r)
        with ts.use_mesh(t_mesh, strategy=strategy), \
                rs.use_mesh(r_mesh, strategy=strategy):
            got = _t_specs(ts.zero_shardings(t_mesh, t_opt,
                                             strategy=strategy))
            want = _r_specs(rs.zero_shardings(r_mesh, r_opt,
                                              strategy=strategy))
        assert got == want, arch


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    with fake_process_group(8):
        mesh = make_host_mesh(model_axis=2)
        assert ts.mesh_axes(mesh) == {"data": 4, "model": 2}
        assert ts.placements(mesh, ("data", None, "model")) == (
            Shard(0), Shard(2))
        assert ts.placements(mesh, (None, None)) == (Replicate(),
                                                     Replicate())
        with pytest.raises(ValueError, match="out of the mesh's order"):
            ts.placements(mesh, (("model", "data"),))


_JAX_ROWS = textwrap.dedent("""
    import json, jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                ("pod", "data", "model"))
    out = {}
    for name, spec, shape in json.loads(%r):
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
        out[name] = {str(d.id): [[s.start or 0, s.stop or n]
                                 for s, n in zip(sl, shape)]
                     for d, sl in idx.items()}
    print(json.dumps(out))
""")


def test_two_axis_shards_hold_jax_rows():
    """A dim over ("pod", "data") (a batch) and a leaf's largest dim over
    the fsdp axes: each rank's local rows are the rows JAX's device at the
    same mesh coordinates holds."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh

    mesh_dict = {"pod": 2, "data": 2, "model": 2}
    with ts.use_mesh(mesh_dict):
        batch = ts.guarded_spec(mesh_dict, (16, 6), (ts.BATCH, ts.MODEL))
    fsdp = ts.param_shardings(mesh_dict, {"w": torch.empty(6, 16)},
                              fsdp_axes=("pod", "data"))["w"]
    assert _norm(batch) == (("pod", "data"), "model")
    assert _norm(fsdp) == (None, ("pod", "data"))
    cases = [("batch", batch, (16, 6)), ("fsdp", fsdp, (6, 16))]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_ROWS % json.dumps(
            [(n, [list(e) if isinstance(e, tuple) else e for e in s], sh)
             for n, s, sh in cases])],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for rank in range(8):
        with fake_process_group(8) if rank == 0 else _fake_rank(rank):
            mesh = init_device_mesh("cpu", (2, 2, 2),
                                    mesh_dim_names=("pod", "data", "model"))
            for name, spec, shape in cases:
                full = torch.arange(int(np.prod(shape))).reshape(shape)
                local = distribute_tensor(
                    full, mesh, ts.placements(mesh, spec),
                    src_data_rank=None).to_local()
                (r0, r1), (c0, c1) = want[name][str(rank)]
                assert torch.equal(local, full[r0:r1, c0:c1]), (name, rank)


class _fake_rank:
    """A fake group of 8 in which this process is ``rank``."""

    def __init__(self, rank):
        self.rank = rank

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=self.rank,
                                world_size=8)

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


def test_production_mesh_needs_a_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="fake_process_group"):
        make_production_mesh()
    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.mesh.shape) == (2, 16, 16)
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_process_group(4):
                pass
    assert not dist.is_initialized()


def test_hints_are_the_identity_outside_a_mesh():
    x = torch.randn(2, 4, 8)
    assert ts.current_mesh() is None and ts.current_strategy() == "tp"
    assert ts.shard_hint(x, ts.BATCH, None, ts.MODEL) is x
    q = torch.randn(2, 4, 8, 16)
    assert ts.shard_attn_q(q, 4) is q
    assert ts.local_kernel(lambda a: a * 2, (x,), ((None,) * 3,)).equal(
        x * 2)
