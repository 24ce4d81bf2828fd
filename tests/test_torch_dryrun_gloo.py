"""The sharded LM's numbers: a reduced qwen2 prefill, the same with 3
query heads and 1 kv head (``shard_attn_q``'s sequence-parallel branch on
a 2-wide model axis, where B3 runs on q gathered over the model axis) and
a reduced mamba2 prefill (B4 on each rank's rows of the batch) and a
reduced arctic prefill (the MoE routed over all tokens on every rank, the
expert products expert-parallel), sharded
over four ``gloo`` processes (``torch.multiprocessing.spawn``, a 2 x 2
("data", "model") mesh, fp32, the parameters as DTensors under
``param_shardings``), against the unsharded port and the reference's
``forward`` on the same weights: within 1e-5 of the largest logit.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as R_ARCHS, reduced as r_reduced
from repro.models.lm import forward as r_forward, init_params as r_init
from repro_torch.engine import lm_params_from_numpy
from repro_torch.models.lm import model

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5


# ---------------------------------------------------------------------------
# four gloo processes
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent("""
    import dataclasses, sys, torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def run(rank, work, port):
        torch.set_num_threads(1)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.models.lm import model, sharding as sh

        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        try:
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            for name, (cfg, params, toks, max_len) in torch.load(
                    work + "/cases.pt", weights_only=False).items():
                with torch.no_grad(), sh.use_mesh(mesh), \\
                        implicit_replication():
                    dp = sh.distribute(params, sh.param_shardings(
                        mesh, params, strategy=cfg.shard_strategy), mesh)
                    dtok = distribute_tensor(toks, mesh, sh.placements(
                        mesh, sh.leaf_spec(mesh, toks.shape, toks.shape[0])),
                        src_data_rank=None)
                    _, logits = model.prefill(dp, cfg, dtok, max_len=max_len)
                    q = sh.attn_q_spec(mesh, cfg.n_heads)
                    full = logits.full_tensor()
                if rank == 0:
                    torch.save({"logits": full, "q_spec": q},
                               f"{work}/{name}.pt")
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], int(sys.argv[2])), nprocs=4)
""")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_prefills_over_four_gloo_processes(tmp_path):
    qwen = dataclasses.replace(r_reduced(R_ARCHS["qwen2-1.5b"]))
    cases = {"qwen2": r_reduced(R_ARCHS["qwen2-1.5b"]),
             "qwen2_seq": dataclasses.replace(qwen, n_heads=3, n_kv=1),
             "mamba2": r_reduced(R_ARCHS["mamba2-130m"]),
             "arctic": r_reduced(R_ARCHS["arctic-480b"])}
    toks = np.random.default_rng(1).integers(0, 512, (4, 24))
    want, saved = {}, {}
    for name, r_cfg in cases.items():
        r_p = r_init(r_cfg, jax.random.PRNGKey(3))
        ref, _ = r_forward(r_p, r_cfg, jnp.asarray(toks))
        t_cfg = _port_cfg(r_cfg)
        params = lm_params_from_numpy(r_p, "cpu")
        with torch.no_grad():
            _, plain = model.prefill(params, t_cfg, torch.from_numpy(toks),
                                     max_len=32)
        want[name] = (np.asarray(ref)[:, -1], plain.numpy())
        saved[name] = (t_cfg, params, torch.from_numpy(toks), 32)
    torch.save(saved, tmp_path / "cases.pt")
    (tmp_path / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(tmp_path / "worker.py"),
                           str(tmp_path), str(_free_port())], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name, (ref, plain) in want.items():
        out = torch.load(tmp_path / f"{name}.pt")
        got = out["logits"].numpy()
        for other in (plain, ref):
            np.testing.assert_allclose(got, other, rtol=0,
                                       atol=REL * np.abs(other).max())
        if name == "qwen2_seq":
            # 3 query heads on a 2-wide model axis: sequence-parallel q
            assert out["q_spec"] == ("batch", None, "model", None)
        if name == "qwen2":
            assert out["q_spec"] == ("batch", "model", None, None)


def _port_cfg(r_cfg):
    from repro_torch.models.lm.config import LMConfig

    return LMConfig(**dataclasses.asdict(r_cfg))
