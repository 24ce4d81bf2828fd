"""``launch/dryrun.py`` and ``launch/perf.py``: the reference's dry run over
meta DTensors, and the sharded model's numbers over real processes.

* ``run_cell`` on reduced configs over small fake meshes (2 x 2 for a
  train cell, 2 x 2 x 2 for a prefill and a decode cell, one process
  standing in for every rank): status "ok", the FLOPs of the unsharded
  step (``count_costs``), and the collectives DTensor issued under "tp".
  The reduced configs' attention chunks are widened to the cell's
  sequence and their SSD chunks to a quarter of it, so the plain
  attention loop runs once a layer, and the inter-chunk loop four times,
  on the meta device.
* The microbatched step against the full batch: the reference's
  ``test_microbatch_matches_full_batch`` (micro 2 and 4, its tolerances),
  the gradients read through an optimizer that returns them.
* Importing the dry run starts no process group and touches no CUDA
  state (a child process), the reference's
  ``test_importing_dryrun_has_no_device_side_effect``.

The sharding's numbers over four ``gloo`` processes are in
``tests/test_torch_dryrun_gloo.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.flops import count_costs
from repro_torch.configs import ARCHS, SHAPES, input_specs, reduced
from repro_torch.launch import dryrun, perf
from repro_torch.models.lm import model
from repro_torch.optim import AdamW

ROOT = Path(__file__).resolve().parents[1]


def _cfg(arch, seq):
    return dataclasses.replace(reduced(ARCHS[arch]), attn_q_chunk=seq,
                               attn_kv_chunk=seq, ssm_chunk=seq // 4)


CELLS = [("qwen2-1.5b", "train_4k", (2, 2)),
         ("qwen2-1.5b", "prefill_32k", (2, 2, 2)),
         ("qwen2-1.5b", "decode_32k", (2, 2, 2)),
         ("mamba2-130m", "prefill_32k", (2, 2))]


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_run_cell_on_a_fake_mesh(arch, shape, mesh):
    s = SHAPES[shape]
    cfg = _cfg(arch, s.seq)
    rec = dryrun.run_cell(arch, shape, cfg=cfg, mesh_shape=mesh,
                          verbose=False)
    assert rec["status"] == "ok", rec
    assert rec["mesh"] == "x".join(map(str, mesh))
    chips = int(np.prod(mesh))
    roof = rec["roofline"]
    assert roof["chips"] == chips
    # the FLOPs and heavy bytes of the unsharded step, on meta
    params = model.init_params(cfg, 0, "meta")
    specs = input_specs(cfg, s)
    if s.kind == "train":
        opt = AdamW()
        args = (dryrun.make_train_step(cfg, opt), params, opt.init(params),
                specs)
    elif s.kind == "prefill":
        args = (dryrun.make_prefill(cfg, s.seq), params, specs)
    else:
        args = (dryrun.make_serve_step(cfg), params, specs["token"],
                specs["cache"], s.seq - 1)
    want = count_costs(*args)
    assert roof["flops_per_device"] * chips == pytest.approx(want["flops"])
    assert roof["bytes_per_device"] * chips == pytest.approx(
        want["heavy_bytes"])
    # collectives from CommDebugMode under "tp"
    coll = roof["collectives"]
    assert set(coll) == {"all-reduce", "all-gather", "reduce-scatter",
                         "all-to-all", "collective-permute"}
    assert sum(coll.values()) > 0
    assert rec["collective_bytes"]["total"] == \
        roof["collective_bytes_per_device"] > 0
    # no compile step, no XLA memory analysis: recorded as null
    assert rec["compile_s"] is None
    assert set(rec["memory"].values()) == {None}
    assert rec["device_bytes"]["params"] > 0


def test_skipped_cell_and_perf_variants(tmp_path, monkeypatch):
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    # importing the reference's perf module writes XLA_FLAGS (its 512
    # placeholder devices); monkeypatch puts the variable back after
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch.perf import variants as r_variants

    for arch in ("qwen2-1.5b", "whisper-tiny"):
        got, want = perf.variants(arch), r_variants(arch)
        assert list(got) == list(want)
        for name, kw in got.items():
            assert set(kw) == set(want[name]), name
            for k, v in kw.items():
                if k == "cfg":
                    assert dataclasses.asdict(v) == dataclasses.asdict(
                        want[name][k]), name
                elif k == "opt":
                    assert v.moment_dtype == want[name][k].moment_dtype
                else:
                    assert v == want[name][k], name
    # a variant through run(): recorded, then read back
    monkeypatch.setattr(perf, "PERF_DIR", tmp_path)
    cfg = _cfg("mamba2-130m", SHAPES["prefill_32k"].seq)
    rec = perf.run("mamba2-130m/prefill_32k", "pure-dp", mesh_shape=(2, 2),
                   cfg=dataclasses.replace(cfg, shard_strategy="pure_dp"))
    assert rec["status"] == "ok" and rec["tag"] == "pure-dp"
    path = tmp_path / "mamba2-130m__prefill_32k__2x2__pure-dp.json"
    assert json.loads(path.read_text())["status"] == "ok"
    assert perf.run("mamba2-130m/prefill_32k", "pure-dp",
                    mesh_shape=(2, 2)) == json.loads(path.read_text())


class _Grads:
    """An optimizer whose update returns the gradients it is given."""

    def update(self, grads, state, params):
        return grads, state, {}


@pytest.mark.parametrize("micro", [2, 4])
def test_microbatch_matches_full_batch(micro):
    """The reference's test: accumulated microbatch gradients equal the
    full batch's (rtol 5e-3, atol 5e-4 of the gradients' norm), and the
    mean microbatch loss the full batch's (rel 1e-4)."""
    cfg = reduced(ARCHS["qwen2-1.5b"])
    params = model.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 16)))
    batch = {"tokens": toks, "targets": toks}
    g_full, _, l_full = dryrun.make_train_step(cfg, _Grads())(params, None,
                                                              batch)
    g_acc, _, l_acc = dryrun.make_train_step(cfg, _Grads(), microbatch=micro)(
        params, None, batch)
    assert float(l_full) == pytest.approx(float(l_acc), rel=1e-4)
    full = dict(_flat(g_full))
    scale = float(torch.sqrt(sum((g.float() ** 2).sum()
                                 for g in full.values())))
    for path, g in _flat(g_acc):
        np.testing.assert_allclose(full[path].numpy(), g.numpy(), rtol=5e-3,
                                   atol=5e-4 * scale, err_msg=path)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_importing_dryrun_has_no_side_effect():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""
            import torch, torch.distributed as dist
            import repro_torch.launch.dryrun, repro_torch.launch.perf
            import repro_torch.launch.mesh, repro_torch.models.lm.sharding
            assert not dist.is_initialized(), "a process group started"
            assert not torch.cuda.is_initialized(), "CUDA was touched"
            assert "jax" not in __import__("sys").modules
            print("IMPORT-CLEAN")
        """)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORT-CLEAN" in proc.stdout
