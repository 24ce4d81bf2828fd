"""Performance hillclimbing harness over the dry run — the port of the
reference's ``repro/launch/perf.py``.

Each variant is a named change set over the baseline cell: a config
replacement (remat, fused gates, sharding strategy, chunk sizes), the
optimizer (bf16 moments), the step's structure (microbatching) or the
parameter layout (FSDP axes).  Records land in ``dryrun_out/perf/`` as
``<arch>__<shape>__<mesh>__<variant>.json``, with the dry run's record
schema (``launch/dryrun.py``), so before/after tables diff directly; a
record that is already there with status "ok" is read back, not re-run.
``unroll_layers`` changes nothing in the port (its layer loop is already
Python), so its variants record the same step as their base.

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --cell whisper-tiny/train_4k --variant pure-dp
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback

from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun
from repro_torch.optim.adamw import AdamW

PERF_DIR = dryrun.OUT_DIR / "perf"


def _cfg(arch, **over):
    return dataclasses.replace(ARCHS[arch], **over)


def variants(arch: str):
    """Variant name -> keyword arguments of ``dryrun.run_cell`` (cfg,
    microbatch, fsdp_axes, opt)."""
    bf16 = AdamW(moment_dtype="bfloat16")
    return {
        "pure-dp": dict(cfg=_cfg(arch, shard_strategy="pure_dp")),
        "remat": dict(cfg=_cfg(arch, remat=True)),
        "fused-gates": dict(cfg=_cfg(arch, fused_gates=True)),
        "fused-gates+dp-model": dict(
            cfg=_cfg(arch, fused_gates=True, shard_strategy="pure_dp")),
        "micro4": dict(microbatch=4),
        "micro8": dict(microbatch=8),
        "micro16": dict(microbatch=16),
        "bf16-moments": dict(opt=bf16),
        "fsdp": dict(fsdp_axes=("pod", "data")),
        "fsdp+bf16-moments+micro8": dict(
            fsdp_axes=("pod", "data"), microbatch=8, opt=bf16),
        "fsdp+bf16-moments+micro16": dict(
            fsdp_axes=("pod", "data"), microbatch=16, opt=bf16),
        "remat+micro8": dict(cfg=_cfg(arch, remat=True), microbatch=8),
        "pure-dp+zero-bf16": dict(
            cfg=_cfg(arch, shard_strategy="pure_dp"), opt=bf16),
        "remat-dots+fsdp+bf16+micro16": dict(
            cfg=_cfg(arch, remat_policy="dots"),
            fsdp_axes=("pod", "data"), microbatch=16, opt=bf16),
        "pure-dp+attn4k": dict(
            cfg=_cfg(arch, shard_strategy="pure_dp", attn_q_chunk=4096,
                     attn_kv_chunk=4096)),
        "pure-dp+chunk128": dict(
            cfg=_cfg(arch, shard_strategy="pure_dp", ssm_chunk=128)),
        "pure-dp+chunk64": dict(
            cfg=_cfg(arch, shard_strategy="pure_dp", ssm_chunk=64)),
        "pure-dp+zero-bf16+micro8": dict(
            cfg=_cfg(arch, shard_strategy="pure_dp"), microbatch=8,
            opt=bf16),
        "baseline+unroll": dict(cfg=_cfg(arch, unroll_layers=True)),
        "best+unroll-kimi": dict(
            cfg=_cfg(arch, unroll_layers=True),
            fsdp_axes=("pod", "data"), microbatch=16, opt=bf16),
        "pure-dp+chunk128+unroll": dict(
            cfg=_cfg(arch, shard_strategy="pure_dp", ssm_chunk=128,
                     unroll_layers=True)),
        "pure-dp+unroll": dict(
            cfg=_cfg(arch, shard_strategy="pure_dp", unroll_layers=True)),
    }


def run(cell: str, variant: str, multi_pod: bool = False, **cell_kw):
    """Run (or read back) one variant of one ``arch/shape`` cell.
    ``cell_kw`` goes to ``run_cell`` beside the variant's own (a smaller
    ``mesh_shape``, say)."""
    arch, shape = cell.split("/")
    kw = dict(variants(arch)[variant], **cell_kw)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if cell_kw.get("mesh_shape"):
        mesh_name = "x".join(str(d) for d in cell_kw["mesh_shape"])
    tag = f"{arch}__{shape}__{mesh_name}__{variant}"
    path = PERF_DIR / f"{tag}.json"
    if path.exists():
        rec = json.loads(path.read_text())
        if rec.get("status") == "ok":
            print(f"[{tag}] cached")
            return rec
    PERF_DIR.mkdir(parents=True, exist_ok=True)
    try:
        rec = dryrun.run_cell(arch, shape, multi_pod, tag=variant, **kw)
    except Exception as e:   # noqa: BLE001 — record, move on
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "tag": variant, "status": "failed", "error": str(e),
               "traceback": traceback.format_exc()}
        print(f"[{tag}] FAILED: {e}", flush=True)
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch/shape")
    ap.add_argument("--variant", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    rec = run(args.cell, args.variant, args.multi_pod)
    return 0 if rec.get("status") == "ok" else 1


if __name__ == "__main__":
    raise SystemExit(main())
