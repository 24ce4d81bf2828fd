"""The sharded train step's numbers: reduced qwen2 and mamba2 (and, in
``tests/test_torch_dp_train_gloo_moe_hybrid.py``, arctic and
recurrentgemma, in ``tests/test_torch_dp_train_gloo_encdec_vlm.py``,
whisper and llava: each pair's four processes on a test worker of its
own) trained over four ``gloo`` processes
(``torch.multiprocessing.spawn``, a 2 x 2 ("data", "model") mesh, fp32):
the parameters as DTensors under ``param_shardings``, the AdamW state
under ``zero_shardings``, the compression's error state as the
parameters, the batch under ``leaf_spec``.

* The sharded loss and every gradient leaf
  (``launch.train.loss_and_grads``) equal the unsharded port's and the
  reference's ``jax.value_and_grad`` of ``loss_fn`` on the same weights
  and batch: the loss within rtol 1e-5, each leaf within 1e-4 of its
  largest value plus 1e-5 of the largest gradient of all (a leaf whose
  exact gradient is 0, whisper's key bias, holds rounding noise only).
  Each gradient is placed as its parameter is.  These include mamba2's
  ``layers.a_log`` and arctic's ``layers.moe.router``, replicated inputs
  of ``sharding.local_kernel`` beside activations sharded on the batch,
  whose gradients are summed over the data axis.
  The gradients are those the sharded ``launch.dryrun.make_train_step``
  takes (its ``loss_and_grads``, recorded).
* One step of ``launch.dryrun.make_train_step`` and one of
  ``launch.train.make_train_step(compress=True)`` (the int8 round trip
  of the global gradient, as the reference's jitted step quantizes it)
  on the DTensors leave the parameters within 2 lr + 1e-6 of the leaf's
  largest value of the unsharded steps': at step 1 the update is ~lr
  sign(g), and a gradient near 0 may take either sign.  The unsharded
  steps are held to the reference in ``tests/test_torch_optim.py`` and
  ``tests/test_torch_train_main.py``.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS, reduced as r_reduced
from repro.models.lm import model as RM
from repro_torch.checkpoint.store import _flatten
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.launch import dryrun, train
from repro_torch.models.lm.model import init_params
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime import compression

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-3
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-5
BATCH, SEQ = 4, 16
FAMILIES = ("qwen2-1.5b", "mamba2-130m")

_WORKER = textwrap.dedent("""
    import sys, torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def run(rank, work, port):
        torch.set_num_threads(1)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, distribute_tensor
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.launch import dryrun, train
        from repro_torch.models.lm import sharding as sh
        from repro_torch.optim import AdamW
        from repro_torch.optim.adamw import tree_leaves, tree_map
        from repro_torch.runtime import compression

        # the gradients the sharded step takes
        seen, real = [], dryrun.loss_and_grads
        dryrun.loss_and_grads = lambda *a: seen.append(real(*a)) or seen[-1]

        def full(tree):
            return tree_map(lambda t: t.full_tensor()
                            if isinstance(t, DTensor) else t, tree)

        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        try:
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            cases = torch.load(work + "/cases.pt", weights_only=False)
            for name, (cfg, params, batch, lr) in cases.items():
                opt = AdamW(lr=lr)
                strategy = cfg.shard_strategy
                with sh.use_mesh(mesh, strategy=strategy), \\
                        implicit_replication():
                    specs = sh.param_shardings(mesh, params,
                                               strategy=strategy)
                    dp = sh.distribute(params, specs, mesh)
                    state = opt.init(params)
                    ds = sh.distribute(state, sh.zero_shardings(
                        mesh, state, strategy=strategy), mesh)
                    de = sh.distribute(compression.init_error(params),
                                       specs, mesh)
                    db = {k: distribute_tensor(v, mesh, sh.placements(
                        mesh, sh.leaf_spec(mesh, v.shape, v.shape[0])),
                        src_data_rank=None) for k, v in batch.items()}
                    p1, _, l1 = dryrun.make_train_step(cfg, opt)(dp, ds, db)
                    loss, grads = seen.pop()
                    placed = all(
                        tuple(g.placements) == tuple(p.placements)
                        for g, p in zip(tree_leaves(grads), tree_leaves(dp)))
                    p2, _, _, l2, _ = train.make_train_step(
                        cfg, opt, compress=True)(dp, ds, de, db, 1.0)
                    out = {"loss": full(loss), "grads": full(grads),
                           "placed": placed,
                           "dryrun": (full(l1), full(p1)),
                           "compressed": (full(l2), full(p2))}
                if rank == 0:
                    torch.save(out, f"{work}/{name}.pt")
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], int(sys.argv[2])), nprocs=4)
""")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread in this process, as in the ranks: the
    shapes are tiny, and under the suite's parallel workers a pool of
    threads a worker oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(script: str, work: Path, *args: str) -> subprocess.Popen:
    """``script`` as ``work/worker.py`` in a child process, given ``work``,
    a free port and ``args``; its ranks on one torch thread each."""
    (work / "worker.py").write_text(script)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, str(work / "worker.py"),
                             str(work), str(free_port()), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc: subprocess.Popen, timeout: int = 300) -> None:
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]


@functools.lru_cache(maxsize=None)
def _r_value_and_grad():
    return jax.jit(jax.value_and_grad(RM.loss_fn, has_aux=True),
                   static_argnums=1)


def setup(name, seed=0):
    """The port's reduced config, weights (drawn by the port) and batch,
    and the reference's config and the same weights as JAX arrays."""
    cfg = reduced(ARCHS[name])
    params = init_params(cfg, seed, "cpu")
    batch = SyntheticLMStream(DataConfig(BATCH, SEQ, cfg.vocab),
                              cfg).global_batch(0)
    r_p = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    return (r_reduced(R_ARCHS[name]), r_p, batch), \
        (cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})


def reference_grads(r_cfg, r_p, batch):
    """The reference's loss and gradients (flat ``{path: array}``)."""
    (loss, _), grads = _r_value_and_grad()(
        r_p, r_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {p: np.asarray(v) for p, v in _flatten(
        jax.tree.map(np.asarray, grads))}


def port_steps(cfg, params, batch):
    """The unsharded port's loss, gradients and parameters after one step
    of each train step."""
    opt = AdamW(lr=LR)
    loss, grads = train.loss_and_grads(params, cfg, batch)
    p1, _, _ = dryrun.make_train_step(cfg, opt)(params, opt.init(params),
                                                batch)
    p2, _, _, _, _ = train.make_train_step(cfg, opt, compress=True)(
        params, opt.init(params), compression.init_error(params), batch, 1.0)
    flat = lambda t: {p: v.numpy() for p, v in _flatten(t)}  # noqa: E731
    return float(loss), flat(grads), flat(p1), flat(p2)


def assert_grads_close(got, want):
    """Each leaf within GRAD_REL of its largest value plus GRAD_FLOOR of
    the largest gradient of all."""
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        g = np.asarray(got[path])
        err = float(np.abs(g - w).max())
        bound = GRAD_REL * float(np.abs(w).max()) + GRAD_FLOOR * top
        assert err <= bound, (path, err, bound)


def assert_params_close(got, want):
    """Each leaf within 2 lr plus 1e-6 of its largest value."""
    assert set(got) == set(want)
    for path, w in want.items():
        err = float(np.abs(np.asarray(got[path]) - w).max())
        bound = 2 * LR + 1e-6 * float(np.abs(w).max())
        assert err <= bound, (path, err, bound)


def check_families(names, tmp_path):
    """Train ``names`` sharded over four ``gloo`` processes, while this
    process computes the unsharded port's steps and the reference's
    gradients, and hold them to each other."""
    cases, sides = {}, {}
    for name in names:
        sides[name] = setup(name)
        cases[name] = sides[name][1] + (LR,)
    torch.save(cases, tmp_path / "cases.pt")
    proc = spawn(_WORKER, tmp_path)
    try:
        want = {name: (reference_grads(*ref), port_steps(*port))
                for name, (ref, port) in sides.items()}
    finally:
        finish(proc)
    flat = lambda t: {p: v.numpy() for p, v in _flatten(t)}  # noqa: E731
    for name, (ref, plain) in want.items():
        out = torch.load(tmp_path / f"{name}.pt")
        assert out["placed"], name
        for other in (plain, ref):
            np.testing.assert_allclose(float(out["loss"]), other[0],
                                       rtol=1e-5)
            assert_grads_close(flat(out["grads"]), other[1])
        for i, step in ((2, "dryrun"), (3, "compressed")):
            loss, params = out[step]
            np.testing.assert_allclose(float(loss), plain[0], rtol=1e-5)
            assert_params_close(flat(params), plain[i])


def test_sharded_train_steps_over_four_gloo_processes(tmp_path):
    check_families(FAMILIES, tmp_path)


def test_remat_recompute_runs_under_the_callers_mesh():
    """A card's backward runs on an autograd thread of its own, where the
    caller's ``use_mesh`` context (thread-local) is not set; the remat
    recompute of each layer still runs under the caller's mesh, and the
    gradients equal the unsharded ones.  Here the backward is started on
    another thread (a ``gloo`` group of one, a 1 x 1 mesh, reduced mamba2
    with remat)."""
    import dataclasses
    import threading

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.lm import model, sharding as sh, ssm
    from repro_torch.optim.adamw import tree_leaves

    cfg = dataclasses.replace(reduced(ARCHS["mamba2-130m"]), remat=True)
    params = init_params(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMStream(
        DataConfig(2, SEQ, cfg.vocab), cfg).global_batch(0).items()}
    _, want = train.loss_and_grads(params, cfg, batch)
    seen, real = [], ssm.mamba2_layer

    def spy(*args, **kw):
        seen.append(sh.current_mesh())
        return real(*args, **kw)

    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{free_port()}")
    ssm.mamba2_layer = spy
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        with implicit_replication():
            with sh.use_mesh(mesh):
                live = tree_map(lambda p: p.detach().requires_grad_(),
                                sh.distribute(params, sh.param_shardings(
                                    mesh, params), mesh))
                db = {k: distribute_tensor(v, mesh, sh.placements(
                    mesh, sh.leaf_spec(mesh, v.shape, v.shape[0])))
                    for k, v in batch.items()}
                loss, _ = model.loss_fn(live, cfg, db)
            errors = []

            def backward():
                try:
                    loss.backward()
                except Exception as e:      # noqa: BLE001 — reported below
                    errors.append(e)

            thread = threading.Thread(target=backward)
            thread.start()
            thread.join()
        assert not errors, errors
        got = [p.grad.full_tensor() for p in tree_leaves(live)]
    finally:
        ssm.mamba2_layer = real
        dist.destroy_process_group()
    assert len(seen) == 2 * cfg.n_layers and all(m is mesh for m in seen)
    assert_grads_close({str(i): g.numpy() for i, g in enumerate(got)},
                       {str(i): w.numpy()
                        for i, w in enumerate(tree_leaves(want))})
