#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each a function of a device and a size:

1. build      — compile the seven sources of ``src/repro_torch/csrc``
                (``conv2d_nchwc_sm90.cu`` B1; B2's three routes,
                ``matmul_splitk.cu``, ``matmul_blocked_sm90.cu`` and
                ``matmul_blocked.cu``; ``flash_attention_sm90.cu`` B3's
                bf16 route and ``flash_attention.cu`` its fp32 route;
                ``ssd_chunk_sm90.cu`` B4) with nvcc for sm_90a, one nvcc
                each, all started together, and print ptxas's registers,
                shared memory and spills (and the sm90 kernels' dynamic
                shared memory, B1's against its launch plan at every conv
                of ResNet-50's plan, the stem's recompute factor, B2's
                cluster sizes at the router's shapes, and B4's launch plan
                at every B4 case);
2. kernels    — B1 against its plain PyTorch version on the card, on every
                distinct conv of ResNet-50's plan at batch 1 and 8 (its
                planned blocks and epilogues), a DenseNet-style
                concat-offset store and a ceil-mode avg-pool with
                asymmetric conv pads, and every distinct conv of the
                batch-1 plans of the ``ZOO`` networks (VGG-16's pooled
                convs, DenseNet-121's and Inception-v3's concat stores,
                Inception's 1x7, 7x1, 1x3, 3x1 and 5x5 taps, SSD's heads
                as plain conv2d nodes at K = 18,432), each case naming
                the route it took and two launches bit-identical;
3. main       — ``compile("resnet-50", (1, 3, 224, 224))`` on the card
                answers 8 batch-1 requests and one batch-8 request; every
                predict must launch B1 once per conv node, every launch on
                its sm90 route, and every request's outputs (the batch-8
                one too) must match a CPU session of the same seed and
                plan;
   variants   — the reference's other engine path: ResNet-50 and VGG-16 at
                224, each as two sessions with ``use_kernel=False`` (fp32
                and ``dtype="int8"``), through phase 3 (4 batch-1 requests
                and one batch-8 request, one lowering a conv node, no B1
                launch, every request held to a CPU session of the same
                plan); one line a session: the plan's count of each
                lowering (per_tap, tap_stack, scan, patch_gemm; int8
                tap_stack and patch_gemm), the calls of each, latency,
                device time per predict and of each lowering's conv nodes
                beside B1's on the same nodes (the default session's
                trace) and cuDNN's fp32 conv, the bound conv-weight bytes
                and, not gated, the int8 logits against the fp32 ones.
                Between them the four sessions must run all six lowerings;
4. lm_kernels — B2, B3 and B4 against their plain versions on the card:
                B2 (each case naming its route, two launches bit-identical)
                at arctic-480b's router shapes (prefill and decode, fp32
                and bf16 operands), kimi-k2's (384 experts), the splitk /
                sm90 boundary (M = 16, 63, 64), the identity tail at the
                prefill shape under the fp64 bound, every matmul tail of
                the reference's tests, attention_probs, ragged and
                padded-operand cases; B3
                (each case naming the route it took) at qwen2-1.5b's,
                arctic-480b's and kimi-k2's prefill shapes, plus ragged,
                windowed, non-causal, MHA, head dims 80 and 112 on both
                routes, and reduced cases, and at the A8 families' shapes
                (recurrentgemma-2b's window of 2,048 at 4,608 tokens and
                head dim 256, llava's 3,392 tokens, whisper-tiny's
                non-causal 1,500 and its cross-attention of 1, 4 and 448
                queries against 1,500 keys);
                B4 (two launches bit-identical) at mamba2-130m's, with
                slow, steep, no and overflowing decay, and ragged shapes;
5. lm_main    — ``compile("qwen2-1.5b", (1, 2048))`` answers four requests
                (a full bucket, an exact bucket, a bucket plus 188 catch-up
                steps, decode only) and a batch-4 session one request; B3
                must launch 28 times per prefill, every launch on its sm90
                route.  The same for
                ``mamba2-130m`` with B4, 24 times per prefill, and, last,
                for arctic-480b at full width and 2 layers, with B3 once per
                layer per prefill and B2 once per layer per prefill (its
                sm90 route) and per decode step (its splitk route);
6. lm_parity  — each model at full width, fp32 (qwen2 and mamba2 at 2
                layers, arctic at 1 layer and 8 experts): a session on the
                card and one on the CPU, from the same weights, agree on
                the logits of every step and on the greedy tokens under the
                top-2 margin rule (and, for arctic, the routing margin
                rule); their fp32 attention must take B3's fma route, and
                arctic's fp32 router B2's fma and splitk routes only;
7. times      — per conv of the batch-1 plan: B1 (its route), its plain
                version and cuDNN's fp32 conv2d, each by the card's time
                per call from a ``torch.profiler`` trace and by CUDA
                events, beside two bounds (3xTF32 on the tensor cores and
                fp32 FMA); end-to-end predict latency at batch 1 and 8;
                device time by node group and by kernel over batch-1
                predicts from a ``torch.profiler`` trace that must hold
                every B1 launch (as in phase 9);
8. lm_times   — B3 per prefill bucket, at arctic-480b's and kimi-k2's
                2,048-token shapes and at the A8 families' (kernel, plain,
                SDPA, bound over the pairs its masks keep), B4 at
                mamba2's prefill shapes (kernel by events and by profiler
                device time, plain, both bounds), B2 at the
                router shapes in bf16 and fp32 (kernel by events and by
                profiler device time, plain, bound, and torch's matmul and
                softmax on fp32 copies and on the bf16 operands); per model
                prefill ms per bucket and the card's time per
                full-bucket prefill, decode ms per
                token, tokens/s at batch 1 and 4, peak device memory of a
                largest-bucket generate and 16 decode steps at the
                cache's last positions, and
                the card's idle share over a decode loop from a
                ``torch.profiler`` trace;
9. zoo        — phase 3 for vgg-16 at 224, densenet-121 at 224,
                inception-v3 at 299 and ssd-resnet-50 at 512 (4 batch-1
                requests and one batch-8 request each, all held to the
                CPU session's; SSD's two outputs as they are), then one
                line per network:
                batch-1 latency, the card's time per predict by node
                group (B1, layout transforms and pads, concat buffers,
                BN/ReLU/pools, dense) from a trace that must hold every
                B1 launch, and its idle share, B1 alone on
                each distinct conv and cuDNN's fp32 conv2d over the
                plan's convs, by the card's time, and B1's two bounds.
   tuning     — A5 on the card: ResNet-50 and VGG-16 at 224 on B1, each
                compiled with ``tuning="roofline"`` and ``"measured"``
                (the guided search timing B1 on the card, the relayout
                bandwidth probed on the same clock): compile seconds,
                searches, measurements and the workloads the tie-break
                decided, ``transform_bw``, each plan's transforms, B1 once
                per conv node a predict (all sm90), both plans' latency
                (interleaved A, B, B, A), device time by node group and
                B1's time on each conv node the plans block differently;
                every distinct conv of the measured plan held against B1's
                plain version first, the measured session against a CPU
                session built with ``tuning="cached"`` on its database
                (plans equal).  ResNet-50 measured on the lowerings
                (``use_kernel=False``: no B1 launch, its lowerings beside
                the roofline plan's).  The paper's Table 3 ladder: each of
                ``MODES`` with measured tuning on ResNet-50, on one
                database (transforms, latency, device time; every blocked
                conv of a rung held against B1's plain version first),
                beside cuDNN's fp32 NCHW conv over the same convs;
10. artifacts — A6 on the card: phase 3's ResNet-50 session (batch 1 and
                8, the source packed), a ResNet-50 ``dtype="int8"``
                session on the lowerings (batch 1), phase 5's
                mamba2-130m session and the tuning phase's measured
                ResNet-50 session are each saved and loaded cold in a
                fresh ``python3 chip_smoke.py --load-artifact`` process,
                which must predict (generate) bit for bit as the saving
                session did, with every weight leaf bit-identical, no
                schedule search and no calibration probe, the saved
                ``transform_bw``, B1 53 times a ResNet-50 predict, all
                sm90 (none on the lowerings, whose artifact carries
                ``quantized.json``), B4 24 times a mamba2 prefill; the
                child also plans batch 2 from the packed source (held to
                the parent's at ``LOGIT_TOL``), and a copy of the ResNet-50
                artifact with one flipped byte must raise
                ``ArtifactCorruptError``.  One line an artifact: save
                seconds, bytes and files, the child's start, load and
                first-predict seconds beside ``compile_s``.
11. serving   — A7 on the card (``phase_serving``): phase 3's ResNet-50
                session behind ``AsyncServer`` (every batch through the
                batch-8 plan, each worker on its own CUDA stream):
                ``load`` — 64 requests of 1-3 rows from 4 client threads,
                paired rounds of sequential ``padded_predict``, the server
                at 1 and 2 workers and nearest-bucket sequential, with
                requests/s, p50/p99 and the card's idle share from a trace;
                ``chaos`` — a killed worker, two failed batches and one
                stalled past the watchdog; ``trace`` — a bursty trace of
                96 requests in three priority classes replayed in real
                time, packed earliest-deadline-first; ``stream`` — 4
                mamba2-130m prompts of 512-1,056 tokens, each prefilled
                at its bucket, streamed through ``submit_stream`` (time to
                first token, time per token); ``startup`` — the
                ResNet-50 artifact of phase 10 served from a fresh process
                (under 30 s from the spawn to the first response);
                ``fleet`` — ResNet-50 and VGG-16 tenants of a
                ``FleetServer`` under a memory budget that evicts.  Every
                response must be bit-identical to ``padded_predict`` at
                its bucket, streamed tokens equal ``generate``'s, B1
                launch 53 times a served batch (sm90) and B4 24 times a
                streamed prefill; nothing may fail outside the chaos step.
                The earlier models' sessions are released before
                arctic-480b's phases, and each phase prints the card's
                peak allocated memory and the script's elapsed seconds.
12. a8        — A8 on the card, after arctic-480b's weights are released
                (``phase_a8``): recurrentgemma-2b at full depth through
                ``compile("recurrentgemma-2b", (1, 4608))`` (buckets
                1,152 below its window of 2,048, 2,304 and 4,608 past it)
                answering three requests, B3 8 times a prefill (sm90);
                llava-next-mistral-7b at full depth: 2,880 stub image
                embeddings and 512 text tokens through the model's
                ``prefill``, 32 ``decode_step``s, B3 32 times a prefill;
                whisper-tiny: 1,500 stub frames and a 4-token prompt, 60
                decode steps at batch 1 and 4, B3 12 times a prefill and 4
                (the cross-attention, 1,500 keys) a decode step; each
                model's end-to-end line as in phase 8; then fp32 copies at
                full width against the CPU (recurrentgemma at 3 layers
                with a bucket past its window, llava and whisper at 2).

    python3 chip_smoke.py --latency-only

runs phase 3's session alone: ResNet-50's predict latency at batch 1 and 8
and its device time per batch-1 predict, one JSON line with the card's
name and power limit.  Copied into a checkout of another commit, it
measures that commit's package with the same code: an A/B of two commits
runs it in both checkouts, in turns, in one call.

    python3 chip_smoke.py --prefill-only

does the same for mamba2-130m's prefill at full depth: host ms per bucket
and the card's time per 2,048-token prefill.

    python3 chip_smoke.py --tuning-only

runs the tuning phase alone,

    python3 chip_smoke.py --a8-only

B3 at the A8 families' shapes and phase 12 alone, and

    python3 chip_smoke.py --serving-only

the serving phase alone, on sessions it compiles itself, and

    python3 chip_smoke.py --b3-times [CHECKOUT]

B3 at the earlier slices' causal prefill shapes (qwen2-1.5b's buckets,
arctic-480b's and kimi-k2's 2,048 tokens) with the kernel of CHECKOUT
(default this one), one JSON line: an A/B of two commits runs it for each
checkout, in turns, in one call.

Run with no arguments, it prints one JSON line per item, the card's
``nvidia-smi`` name and power limit, the kernels' summary line, and as its
last line
``{"ok": true, "device": {...}}``.  A failed phase raises and the script
exits non-zero; without a card, or outside a checkout of the repository, it
exits non-zero before printing any result.  Full results also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
START = time.perf_counter()     # the script's start, for each phase's end
MODEL, IMAGE, BIG_BATCH = "resnet-50", 224, 8
KERNEL_SOURCE = "src/repro_torch/csrc/conv2d_nchwc_sm90.cu"
KERNEL_NAMES = ("conv2d_nchwc_sm90", "matmul_blocked", "matmul_splitk",
                "matmul_blocked_sm90", "flash_attention_sm90",
                "flash_attention", "ssd_chunk_sm90")
PEAK_FP32 = 67e12          # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12         # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_TF32 = 495e12         # H100 SXM dense TF32 tensor-core FLOP/s
TF32_PRODUCTS = 3          # B1's and B4's 3xTF32: lo*hi + hi*lo + hi*hi
MEM_BW = 3.35e12           # H100 SXM device-memory bytes/s
# kernel vs plain on one card: fp32 sums of up to 18,432 terms (SSD's 3x3
# heads on the 2,048-channel map) in another order, on outputs of order 1
# (B1's 3xTF32 products carry ~2^-22 of each product besides)
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
# card vs CPU session after 53 convs: the same sums in another order,
# compounded through the depth of the network.  Random weights drive the
# logits to ~1e4, so the softmax is one-hot and the logits are compared,
# to a tolerance relative to the largest logit.
E2E_TOL = dict(rtol=1e-3, atol=1e-5)
LOGIT_TOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def _build_report(name: str, info: dict) -> dict:
    ptxas = info["ptxas"]
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", ptxas)]
    smem = [int(m) for m in re.findall(r"(\d+) bytes smem", ptxas)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", ptxas)]
    return {"phase": "build", "source": f"src/repro_torch/csrc/{name}.cu",
            "seconds": info["seconds"], "registers": max(regs, default=None),
            "smem_bytes": max(smem, default=0),
            "spill_store_bytes": max(spills, default=0),
            "ptxas": [ln.strip() for ln in ptxas.splitlines() if ln.strip()]}


def phase_build() -> list:
    """One nvcc per source, all started together."""
    from repro_torch.kernels import build as kbuild

    with ThreadPoolExecutor(len(KERNEL_NAMES)) as pool:
        infos = list(pool.map(kbuild.build, KERNEL_NAMES))
    outs = [_build_report(n, i) for n, i in zip(KERNEL_NAMES, infos)]
    from repro_torch.kernels.flash_attention import sm90_smem_bytes
    from repro_torch.kernels.matmul_blocked import (cluster_size,
                                                    sm90_smem_bytes as mm_smem)

    for out in outs:
        if out["source"].endswith("conv2d_nchwc_sm90.cu"):
            out.update(b1_plan_report())
        if out["source"].endswith("flash_attention_sm90.cu"):
            out["dynamic_smem_bytes"] = {d: sm90_smem_bytes(d)
                                         for d in (64, 128, 192, 256)}
        if out["source"].endswith("matmul_blocked_sm90.cu"):
            out["dynamic_smem_bytes"] = {n: mm_smem(n)
                                         for n in (64, 128, 256, 384, 512)}
            out["cluster_blocks"] = {f"{m}x{ROUTER_K}": cluster_size(
                "sm90", m, ROUTER_K) for m in (64, 512, 2048)}
        if out["source"].endswith("matmul_splitk.cu"):
            out["cluster_blocks"] = {f"{m}x{ROUTER_K}": cluster_size(
                "splitk", m, ROUTER_K) for m in (1, 4, 63)}
        if out["source"].endswith("ssd_chunk_sm90.cu"):
            out.update(b4_plan_report())
        emit(out)
    return outs


def plan_shapes(c) -> tuple:
    """The padded blocked x shape, the blocked w shape, the stride and the
    epilogue of a ``plan_convs`` entry: what B1's ``launch_plan`` and
    ``_route`` take."""
    wl = c["wl"]
    x = (wl.batch, wl.in_channels // c["ic_bn"], wl.height + 2 * wl.pad,
         wl.width + 2 * wl.pw, c["ic_bn"])
    w = (wl.out_channels // c["oc_bn"], wl.in_channels // c["ic_bn"], wl.kh,
         wl.kw, c["ic_bn"], c["oc_bn"])
    return x, w, wl.stride, wl.epilogue_spec()


def b1_plan_report() -> dict:
    """B1's launch plan at every conv of ResNet-50's plan (batch 1 and 8):
    the dynamic shared memory the kernel computes for it against the
    wrapper's ``smem_bytes`` (they must agree), and the stem's recompute
    factor (conv values computed over the layer's, and wgmma rows)."""
    import ctypes

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.conv2d_nchwc import launch_plan

    query = kbuild.entry("conv2d_nchwc_sm90", "conv2d_sm90_smem",
                         [ctypes.c_int] * 2)
    smem, stem = {}, {}
    for batch in (1, BIG_BATCH):
        for c in plan_convs(MODEL, batch, IMAGE):
            plan = launch_plan(*plan_shapes(c))
            got = query(plan["kt_per"], plan["ch"] * plan["cw"])
            if got != plan["smem"]:
                raise RuntimeError(f"B1 {wl_name(c)}: the kernel lays out "
                                   f"{got} bytes, the plan {plan['smem']}")
            smem[f"b{batch}_{wl_name(c)}"] = got
            if c["wl"].fused_pool:
                stem[f"batch{batch}"] = {
                    k: plan[k] for k in ("pph", "ppw", "ch", "cw",
                                         "recompute", "mma_rows")}
    return {"dynamic_smem_bytes": smem, "stem_recompute": stem}


def b4_plan_report() -> dict:
    """B4's launch plan at every ``ssd_cases`` shape: heads a block, grid,
    blocks and stages, and the dynamic shared memory the kernel lays out
    against the plan's (they must agree)."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.ssd_chunk import launch_plan

    got = kbuild.entry("ssd_chunk_sm90", "ssd_intra_smem", [])()
    plans = {}
    for name, bcn, h, q, n, p, _ in ssd_cases():
        plan = launch_plan(bcn, h, q, n, p)
        if got != plan["smem"]:
            raise RuntimeError(f"B4 {name}: the kernel lays out {got} "
                               f"bytes, the plan {plan['smem']}")
        plans[name] = {k: plan[k] for k in ("heads", "grid", "blocks",
                                            "stages", "longest")}
    return {"dynamic_smem_bytes": got, "launch_plans": plans}


# ---------------------------------------------------------------------------
# 2. kernels: each distinct conv of the plan, kernel vs plain
# ---------------------------------------------------------------------------

CONV_OPS = ("conv_block", "conv2d")


def plan_convs(model: str, batch: int, image: int) -> list:
    """``planned_convs`` of the port's default (roofline, B1) plan."""
    from repro_torch.core.pipeline import Pipeline
    from repro_torch.models.cnn import build

    graph, shapes = build(model, batch=batch, image=image)
    return planned_convs(Pipeline.preset("fusion").run(graph, shapes))


def planned_convs(plan) -> list:
    """Distinct (workload, ic_bn, oc_bn) of a plan's blocked convs, with
    their multiplicity in one predict.  An unfused ``conv2d`` node (SSD's
    heads) launches B1 with the identity epilogue and no shift: ``"shift"``
    is False for it."""
    from repro_torch.core.pipeline import make_workload

    planned = plan.planned
    convs: dict = {}
    for node in planned.graph.topo_order():
        if node.op not in CONV_OPS or node.name not in planned.schedules:
            continue
        s = planned.schedules[node.name]
        wl = make_workload(node, planned.graph.nodes[node.inputs[0]].shape)
        shift = node.op == "conv_block"
        key = (wl, s.ic_bn, s.oc_bn, shift)
        convs.setdefault(key, {"wl": wl, "ic_bn": s.ic_bn, "oc_bn": s.oc_bn,
                               "shift": shift, "count": 0})["count"] += 1
    return list(convs.values())


def make_case(wl, ic_bn: int, oc_bn: int, device, seed: int = 0,
              shift: bool = True) -> dict:
    """Random operands of one B1 launch, blocked as the plan has them (a
    conv_block's, or with ``shift=False`` a plain conv2d's).  The concat
    buffer is random so the copy-through is checked."""
    from repro_torch.core.layout import kernel_to_kcrs_ck, to_nchwc
    from repro_torch.kernels.ops import pad_blocked

    rng = np.random.default_rng(seed)
    spec = wl.epilogue_spec()
    cin, cout = wl.in_channels, wl.out_channels
    oh, ow = wl.out_hw
    ph, pw = spec.out_hw(oh, ow)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    x = t(rng.normal(size=(wl.batch, cin, wl.height, wl.width)))
    w = t(rng.normal(0, np.sqrt(2.0 / (cin * wl.kh * wl.kw)),
                     size=(cout, cin, wl.kh, wl.kw)))
    vec = t(rng.normal(0, 0.1, size=(cout,)))
    case = {
        "spec": spec, "stride": wl.stride, "pad": (wl.pad, wl.pw),
        "x_nchw": x, "w_kcrs": w, "shift_vec": vec,
        "x": pad_blocked(to_nchwc(x, ic_bn), (wl.pad, wl.pw)),
        "w": kernel_to_kcrs_ck(w, ic_bn, oc_bn),
        "scale": None,
        "shift": vec.reshape(-1, oc_bn).contiguous() if shift else None,
        "residual": None, "out_buf": None}
    if wl.fused_residual:
        case["residual"] = to_nchwc(
            t(rng.normal(size=(wl.batch, cout, oh, ow))), oc_bn)
    if spec.writes_concat:
        case["out_buf"] = to_nchwc(
            t(rng.normal(size=(wl.batch, spec.concat_total, ph, pw))), oc_bn)
    return case


def run_case(case, plain: bool) -> torch.Tensor:
    from repro_torch.kernels.conv2d_nchwc import (conv2d_nchwc,
                                                  conv2d_nchwc_plain)

    fn = conv2d_nchwc_plain if plain else conv2d_nchwc
    return fn(case["x"], case["w"], case["scale"], case["shift"],
              case["residual"], case["out_buf"], stride=case["stride"],
              epilogue=case["spec"])


def extra_cases() -> list:
    """What ResNet does not reach: a DenseNet-style concat-offset store and
    a ceil-mode avg pool behind a conv with asymmetric pads."""
    from repro_torch.core.schedule import ConvWorkload

    dense = ConvWorkload(batch=1, in_channels=128, out_channels=32,
                         height=28, width=28, kh=3, kw=3, pad=1,
                         fused_bn=True, fused_relu=True,
                         concat_offset=64, concat_total=160)
    avg = ConvWorkload(batch=2, in_channels=32, out_channels=64, height=15,
                       width=15, kh=3, kw=3, stride=1, pad=1, pad_w=0,
                       fused_bn=True, fused_relu=True, fused_residual=True,
                       fused_pool="avg", pool_k=3, pool_stride=2, pool_pad=1,
                       pool_ceil=True)
    return [{"name": "densenet_concat", "wl": dense, "ic_bn": 32,
             "oc_bn": 32, "count": 0},
            {"name": "avgpool_ceil_asym", "wl": avg, "ic_bn": 8,
             "oc_bn": 16, "count": 0}]


def wl_name(c) -> str:
    wl = c["wl"]
    name = (f"c{wl.in_channels}_k{wl.out_channels}_h{wl.height}_r{wl.kh}"
            f"_s{wl.stride}_p{wl.pad}" + (f"x{wl.pw}" if wl.pad_w >= 0 else "")
            + f"_ic{c['ic_bn']}_oc{c['oc_bn']}")
    if wl.fused_residual:
        name += "_res"
    if wl.fused_pool:
        name += f"_{wl.fused_pool}pool{'c' if wl.pool_ceil else ''}"
    if wl.concat_total:
        name += f"_cat{wl.concat_offset}of{wl.concat_total}"
    if not c.get("shift", True):
        name += "_conv2d"
    return c.get("name", name)


def b1_route(case) -> str:
    from repro_torch.kernels.conv2d_nchwc import _route

    return _route(case["x"].shape, case["w"].shape, case["stride"],
                  case["spec"], case["x"].dtype)


def b1_launch(case):
    """One B1 launch and the routes it took, by ``launches_by_route``."""
    from repro_torch.kernels.conv2d_nchwc import conv2d_nchwc

    before = dict(conv2d_nchwc.launches_by_route)
    out = run_case(case, plain=False)
    return out, [r for r, n in conv2d_nchwc.launches_by_route.items()
                 if n != before[r]]


def phase_kernels(device, convs: list) -> float:
    """Kernel vs plain on every case, each on the route ``_route`` names
    for it and bit-identical over two launches; returns the largest abs
    error."""
    worst = 0.0
    for c in convs:
        case = make_case(c["wl"], c["ic_bn"], c["oc_bn"], device,
                         shift=c.get("shift", True))
        got, routes = b1_launch(case)
        again, _ = b1_launch(case)
        want = run_case(case, plain=True)
        torch.cuda.synchronize(device)
        route = b1_route(case)
        if routes != [route]:
            raise RuntimeError(f"B1 {wl_name(c)}: took route {routes}, "
                               f"expected {route}")
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{wl_name(c)}: non-finite kernel output")
        if not torch.equal(got, again):
            raise RuntimeError(f"B1 {wl_name(c)}: two launches differ")
        err = float((got - want).abs().max())
        emit({"phase": "kernel_vs_plain", "case": wl_name(c),
              "batch": c["wl"].batch, "route": route, "max_abs_err": err,
              "bit_identical": True, **KERNEL_TOL})
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# 3. main path
# ---------------------------------------------------------------------------

def with_logits(m):
    """The same plan and bound weights as the ``CompiledModel`` ``m``, with
    each softmax's input (the logits) as a further output."""
    from repro_torch.engine import CompiledModel

    plan = copy.deepcopy(m.plan)
    graph = plan.planned.graph
    for o in list(graph.outputs):
        if graph.nodes[o].op == "softmax":
            graph.mark_output(graph.nodes[o].inputs[0])
    return CompiledModel(plan=plan, params=m.params, use_kernel=m.use_kernel)


def plan_variants(plan) -> dict:
    """The plan's count of each conv lowering, as ``"variant/dtype"``."""
    p = plan.planned
    counts: dict = {}
    for name in plan_conv_names(plan):
        s = p.schedules[name]
        key = f"{s.resolved_variant()}/{s.dtype}"
        counts[key] = counts.get(key, 0) + 1
    return counts


def plan_conv_names(plan) -> list:
    """The plan's conv nodes (conv_block or conv2d), in execution order."""
    return [n.name for n in plan.planned.graph.topo_order()
            if n.op in CONV_OPS]


def lowering_calls() -> dict:
    from repro_torch.kernels.ops import conv2d_lowered

    return dict(conv2d_lowered.calls)


def requests_for(image: int, requests: int, big_batch: int,
                 seed: int = 0) -> list:
    """The inputs of ``phase_main``'s requests: ``requests`` batch-1
    images and one ``big_batch`` batch."""
    rng = np.random.default_rng(seed + 1)
    xs = [rng.normal(size=(1, 3, image, image)).astype(np.float32)
          for _ in range(requests)]
    return xs + [rng.normal(size=(big_batch, 3, image, image)).astype(
        np.float32)]


def phase_main(device, image: int = 224, requests: int = 8,
               big_batch: int = 8, model: str = "resnet-50",
               seed: int = 0, use_kernel: bool = True,
               dtype: str = "fp32") -> dict:
    """The user's path: compile, then answer ``requests`` batch-1 requests
    and one ``big_batch`` request.  Every predict on a CUDA device must
    launch the conv kernel once per conv node (conv_block or conv2d), each
    launch on its sm90 route, and run no lowering; with
    ``use_kernel=False`` (and ``dtype``) every predict must run one
    lowering per conv node and launch the kernel no time.  Every output
    must have the plan's shape and
    be finite, a softmax output must sum to one.  Every request's outputs
    (the batch-1 ones and the ``big_batch`` one, whose B1 launches take
    other launch plans) must match a CPU session of the same seed, whose
    plan at both batch sizes must be the same: a softmax output to
    ``E2E_TOL`` with the same top-1 in every row, and to ``LOGIT_TOL`` of
    the largest its logits (marked as a second output, ``with_logits``)
    and every other output (SSD's ``loc_cat`` and ``conf_cat``)."""
    from repro_torch.engine import compile
    from repro_torch.engine.session import _plan_to_json
    from repro_torch.kernels.conv2d_nchwc import conv2d_nchwc

    *xs, x_big = requests_for(image, requests, big_batch, seed)
    on_card = torch.device(device).type == "cuda"
    kw = dict(seed=seed, use_kernel=use_kernel, dtype=dtype)

    def run(m, x, on=device):
        y = m.predict(torch.from_numpy(x).to(on))
        return [t.cpu().numpy() for t in (y if isinstance(y, tuple)
                                          else (y,))]

    t0 = time.perf_counter()
    session = compile(model, (1, 3, image, image), device=device, **kw)
    compile_s = time.perf_counter() - t0
    graph = session.plan_for(1).planned.graph
    nodes = graph.topo_order()
    n_blocks = sum(1 for n in nodes if n.op == "conv_block")
    n_convs = sum(1 for n in nodes if n.op in CONV_OPS)
    reset_counts()
    lowered0 = lowering_calls()
    outs, per_predict, lowered_per_predict = [], [], []
    for x in xs + [x_big]:
        before, low = conv2d_nchwc.launches, sum(lowering_calls().values())
        outs.append(run(session, x))
        per_predict.append(conv2d_nchwc.launches - before)
        lowered_per_predict.append(sum(lowering_calls().values()) - low)
    counts = read_counts()
    lowered = {k: v - lowered0[k] for k, v in lowering_calls().items()
               if v != lowered0[k]}
    launches = counts["conv2d_nchwc"]
    by_route = dict(conv2d_nchwc.launches_by_route)
    if on_card and by_route != {"sm90": launches}:
        raise RuntimeError(f"B1 launches by route {by_route}, expected all "
                           f"{launches} on sm90")
    others = {k: v for k, v in counts.items() if k != "conv2d_nchwc" and v}
    if others:
        raise RuntimeError(f"unexpected kernel launches {others}")

    want_launches = n_convs if on_card and use_kernel else 0
    if any(n != want_launches for n in per_predict):
        raise RuntimeError(f"kernel launches per predict {per_predict}, "
                           f"expected {want_launches} each")
    want_lowered = 0 if use_kernel else n_convs
    if any(n != want_lowered for n in lowered_per_predict):
        raise RuntimeError(f"lowerings per predict {lowered_per_predict}, "
                           f"expected {want_lowered} each")
    softmax = [graph.nodes[o].op == "softmax" for o in graph.outputs]
    for x, ys in zip(xs + [x_big], outs):
        for o, y, sm in zip(graph.outputs, ys, softmax):
            shape = (x.shape[0],) + tuple(graph.nodes[o].shape[1:])
            if y.shape != shape or not np.isfinite(y).all():
                raise RuntimeError(f"bad output {o}: shape {y.shape}, "
                                   f"expected {shape}, finite "
                                   f"{np.isfinite(y).all()}")
            if sm:
                np.testing.assert_allclose(y.sum(axis=1), 1.0, rtol=1e-5,
                                           atol=1e-5)

    ref = compile(model, (1, 3, image, image), device="cpu", **kw)
    for batch in (1, big_batch):
        plans = [_plan_to_json(s.plan_for(batch)) for s in (session, ref)]
        for p in plans:
            p.pop("report")
        if plans[0] != plans[1]:
            raise RuntimeError(f"the card's plan at batch {batch} differs "
                               "from the CPU session's")

    n_out = len(graph.outputs)

    def check(x, ys, card, cpu) -> tuple:
        """``ys`` (the card's outputs for ``x``) against the CPU session's,
        and the logits of both: the largest abs error of a softmax output,
        and of the rest relative to their largest."""
        want, got = run(cpu, x, "cpu"), run(card, x)
        raw = list(zip(got[n_out:], want[n_out:]))
        err = raw_err = 0.0
        for y, w, sm in zip(ys, want, softmax):
            if not sm:
                raw.append((y, w))
                continue
            np.testing.assert_allclose(y, w, **E2E_TOL)
            if (y.argmax(axis=1) != w.argmax(axis=1)).any():
                raise RuntimeError("top-1 class differs from the CPU session")
            err = max(err, float(np.abs(y - w).max()))
        for g, w in raw:
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL * scale)
            raw_err = max(raw_err, float(np.abs(g - w).max()) / scale)
        return err, raw_err

    pair = [with_logits(s.specialize(1)) for s in (session, ref)]
    errs = [check(x, ys, *pair) for x, ys in zip(xs, outs)]
    big_err = check(x_big, outs[-1], *[with_logits(s.specialize(big_batch))
                                       for s in (session, ref)])
    out = {"phase": "main", "model": model, "image": image,
           "use_kernel": use_kernel, "dtype": dtype,
           "requests": [1] * requests + [big_batch],
           "conv_blocks": n_blocks, "conv_nodes": n_convs,
           "plan_variants": plan_variants(session.plan_for(1)),
           "launches": launches, "launches_by_route": by_route,
           "launches_per_predict": per_predict,
           "lowering_calls": lowered, "compile_s": compile_s,
           "max_abs_err_vs_cpu": max(e for e, _ in errs) if any(softmax)
           else None,
           "max_logit_err_vs_cpu_rel": max(r for _, r in errs),
           "big_batch_vs_cpu": {
               "max_abs_err": big_err[0] if any(softmax) else None,
               "max_logit_err_rel": big_err[1]},
           **E2E_TOL, "logit_tol_rel": LOGIT_TOL}
    emit(out)
    return {"session": session, **out}


# ---------------------------------------------------------------------------
# 7. times
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_ms(fn, iters: int) -> float:
    """The host's time per call of ``fn`` over ``iters`` back-to-back calls
    that end without a synchronize: what a caller's thread spends to launch
    it (the card drains the queue afterwards)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def roofline(case, out: torch.Tensor, wl) -> dict:
    """The least time of one launch, two ways: ``bound_ms`` on the tensor
    cores, the larger of its 3xTF32 work (three TF32 products for each fp32
    one) over the dense TF32 peak and its bytes (each operand read once,
    the output written once) over the memory rate; ``fma_bound_ms`` the
    same with its fp32 FLOP over the FMA units' peak."""
    flop = wl.flops
    nbytes = 4 * (out.numel() + sum(
        case[k].numel() for k in ("x", "w", "scale", "shift", "residual",
                                  "out_buf") if case[k] is not None))
    t_op = TF32_PRODUCTS * flop / PEAK_TF32 * 1e3
    t_fma, t_mem = flop / PEAK_FP32 * 1e3, nbytes / MEM_BW * 1e3
    return {"flop": flop, "bytes": nbytes, "bound_ms": max(t_op, t_mem),
            "bound_by": "operations" if t_op >= t_mem else "bytes",
            "fma_bound_ms": max(t_fma, t_mem)}


def phase_times(device, convs: list, iters: int = 20) -> list:
    """Per conv: B1 on its route, its plain version and cuDNN's fp32
    ``F.conv2d`` (TF32 off) on the same values in NCHW, each by the card's
    time per call from a profiler trace (``device_ms``) and by CUDA events
    over back-to-back calls (which at the 7x7 and 14x14 layers time the
    host's enqueue), and the host's enqueue time per call of B1's wrapper
    (``host_ms``), beside both bounds."""
    import torch.nn.functional as F

    rows = []
    for c in convs:
        case = make_case(c["wl"], c["ic_bn"], c["oc_bn"], device,
                         shift=c.get("shift", True))
        out = run_case(case, plain=False)

        def kernel():
            return run_case(case, plain=False)

        def lib():
            return F.conv2d(case["x_nchw"], case["w_kcrs"], case["shift_vec"],
                            stride=case["stride"], padding=case["pad"])

        row = {"phase": "times", "case": wl_name(c), "count": c["count"],
               "route": b1_route(case),
               "device_ms": _device_busy(kernel, iters, b1=iters)[
                   "device_ms"],
               "ms": cuda_ms(kernel, iters),
               "host_ms": enqueue_ms(kernel, iters),
               "plain_ms": cuda_ms(lambda: run_case(case, plain=True), iters),
               "library_device_ms": _device_busy(lib, iters)["device_ms"],
               "library_ms": cuda_ms(lib, iters),
               **roofline(case, out, c["wl"])}
        emit(row)
        rows.append(row)
    return rows


def phase_latency(session, device, image: int, batch: int,
                  iters: int) -> dict:
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(batch, 3, image, image)).astype(np.float32)).to(device)
    session.predict(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        session.predict(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"phase": "latency", "batch": batch, "iters": iters,
           "median_ms": statistics.median(times), "min_ms": min(times),
           "max_ms": max(times)}
    emit(out)
    return out


def phase_profile(session, device, image: int, iters: int = 5) -> dict:
    """Device time over batch-1 predicts, from a ``torch.profiler`` trace
    that holds every B1 launch (``device_ms_by_group``): by node group
    and by kernel name, and how long the card idles.  The profiler's own
    host cost inflates the wall time here, so the idle share is an upper
    bound."""
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 3, image, image)).astype(np.float32)).to(device)
    n_convs = sum(1 for n in session.plan_for(1).planned.graph.topo_order()
                  if n.op in CONV_OPS)
    r = device_ms_by_group(lambda: session.predict(x), iters,
                           iters * n_convs)
    out = {"phase": "profile", "batch": 1, "iters": iters,
           "wall_ms_per_predict": r["wall_ms"],
           "device_ms_per_predict": r["device_ms"],
           "idle_share": 1 - r["device_ms"] / r["wall_ms"],
           "top_ms_per_predict": r["top_ms"],
           "device_ms_by_group": r["by_group"],
           "b1_launches_traced": r["b1_launches"],
           "launch_gaps": r["launch_gaps"]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# zoo: one network of each other family of the paper's Table 2
# ---------------------------------------------------------------------------

# (model, published resolution), served like ResNet-50 in phase 3
ZOO = (("vgg-16", 224), ("densenet-121", 224), ("inception-v3", 299),
       ("ssd-resnet-50", 512))
ZOO_REQUESTS = 4
# the executor's node ops, grouped as the zoo line reports their device
# time ("pad" is the pad of a conv's blocked input, inside its conv node)
NODE_GROUPS = {"conv_block": "conv", "conv2d": "conv",
               "layout_transform": "transforms_and_pads",
               "pad": "transforms_and_pads",
               "concat": "concat", "concat_alloc": "concat",
               "batch_norm": "bn_relu_pool", "relu": "bn_relu_pool",
               "max_pool": "bn_relu_pool", "avg_pool": "bn_relu_pool",
               "global_avg_pool": "bn_relu_pool", "dense": "dense"}
B1_KERNEL = "conv_sm90_kernel"       # the __global__ of conv2d_nchwc_sm90.cu
NODE_RANGE = "node:"


@contextlib.contextmanager
def node_ranges(labels: dict | None = None):
    """While the block runs, each graph node the executor evaluates, and
    each pad of a conv's blocked input, runs inside a profiler range named
    ``node:<op>`` (``node:pad`` for the pad), or ``node:<label>`` for a
    node that ``labels`` (node name -> label) names."""
    from torch.profiler import record_function

    from repro_torch.engine import executor
    from repro_torch.kernels import ops as kops

    eval_node, pad = executor._eval_node, kops.pad_blocked
    labels = labels or {}

    def ranged_eval(node, *args):
        with record_function(NODE_RANGE + labels.get(node.name, node.op)):
            return eval_node(node, *args)

    def ranged_pad(x, p):
        with record_function(NODE_RANGE + "pad"):
            return pad(x, p)

    executor._eval_node, kops.pad_blocked = ranged_eval, ranged_pad
    try:
        yield
    finally:
        executor._eval_node, kops.pad_blocked = eval_node, pad


def device_ms_by_group(fn, iters: int, b1: int,
                       labels: dict | None = None) -> dict:
    """The card's ms per call of ``fn`` by node group, from a
    ``torch.profiler`` trace under ``node_ranges(labels)`` that must hold
    ``b1`` B1 launches (``_profiled``); a node that ``labels`` names is
    its own group, its label.  B1's launches go through ``ctypes``,
    outside the profiler's op correlation, so its group ``b1`` is summed
    by kernel name; every other kernel counts for the innermost ``node:``
    range around the op that launched it (group ``conv``: a conv node's
    own torch ops, the bias add of a plain conv2d), and what neither
    claims is ``unattributed``.  Also the wall ms per call (the ranges'
    host cost included), the top kernels by device time, the B1 launches
    the trace holds beside ``b1``, and ``_launch_gaps``."""
    from torch.autograd import DeviceType

    labels = labels or {}
    prof, wall_ms, held, gaps = _profiled(fn, iters, b1, labels)
    lead = gaps.pop("lead_ids")
    own = set(labels.values())
    groups: dict = {"b1": 0.0}
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(NODE_RANGE) or e.id in lead:
                continue                 # a range's span, or a lead kernel
            ms = e.time_range.elapsed_us() / 1e3 / iters
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
            if B1_KERNEL in e.name:
                groups["b1"] += ms
            continue
        ms = sum(k.duration for k in e.kernels
                 if not k.name.startswith(NODE_RANGE)) / 1e3 / iters
        if not ms:
            continue
        owner = e
        while owner is not None and not owner.name.startswith(NODE_RANGE):
            owner = owner.cpu_parent
        tag = None if owner is None else owner.name[len(NODE_RANGE):]
        group = ("unattributed" if tag is None else tag if tag in own
                 else NODE_GROUPS.get(tag, "other"))
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(by_name.values())
    groups["unattributed"] = groups.get("unattributed", 0.0) + busy - sum(
        groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": busy, "wall_ms": wall_ms, "by_group": groups,
            "top_ms": [[name[:80], ms] for name, ms in top],
            "b1_launches": [held, b1], "launch_gaps": gaps}


def b1_out(case) -> torch.Tensor:
    """A meta tensor of the shape B1 returns for ``case``."""
    from repro_torch.kernels.conv2d_nchwc import _geometry

    shape = _geometry(tuple(case["x"].shape), tuple(case["w"].shape),
                      case["stride"], case["spec"])[2]
    return torch.empty(shape, device="meta")


def phase_zoo_times(session, image: int, convs: list, device,
                    iters: int = 5) -> dict:
    """A zoo network's times at batch 1: predict latency (median of 20 on
    the host clock around a synchronize); the card's time per predict, in
    all and by node group (``device_ms_by_group``: a trace of ``iters``
    predicts that must hold every B1 launch they made), and its idle share;
    B1 alone on every distinct conv by CUDA events (name, ms a launch,
    launches a predict; the five largest shares first); cuDNN's fp32
    ``F.conv2d`` (TF32 off) with bias on every conv of the plan, by the
    card's time; and B1's two bounds (``roofline``) summed over the plan's
    convs."""
    import torch.nn.functional as F

    lat = phase_latency(session, device, image, 1, 20)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 3, image, image)).astype(np.float32)).to(device)
    n_convs = sum(c["count"] for c in convs)
    groups = device_ms_by_group(lambda: session.predict(x), iters,
                                iters * n_convs)
    cases = [(make_case(c["wl"], c["ic_bn"], c["oc_bn"], device,
                        shift=c.get("shift", True)), c) for c in convs]
    # B1 alone on each distinct conv, by CUDA events over 20 back-to-back
    # launches: the card's time where a launch outlasts the host's enqueue
    # (~0.02 ms a call), the enqueue's below that
    alone = sorted(((wl_name(c), cuda_ms(
        lambda case=case: run_case(case, plain=False), 20), c["count"])
        for case, c in cases), key=lambda a: -a[1] * a[2])

    def cudnn():
        for case, c in cases:
            for _ in range(c["count"]):
                F.conv2d(case["x_nchw"], case["w_kcrs"], case["shift_vec"],
                         stride=case["stride"], padding=case["pad"])

    bounds = [roofline(case, b1_out(case), c["wl"]) for case, c in cases]
    t_op, t_mem, t_fma = (sum(b[k] * c["count"] for b, c in zip(bounds, convs))
                          for k in ("flop", "bytes", "fma_bound_ms"))
    t_op, t_mem = TF32_PRODUCTS * t_op / PEAK_TF32 * 1e3, t_mem / MEM_BW * 1e3
    dev = groups["device_ms"]
    return {"distinct_convs": len(convs),
            "latency_ms_batch1": lat["median_ms"],
            "device_ms_per_predict": dev,
            "idle_share": 1 - dev / groups["wall_ms"],
            "idle_share_unprofiled": 1 - dev / lat["median_ms"],
            "b1_device_ms": groups["by_group"]["b1"],
            "device_ms_by_group": groups["by_group"],
            "b1_launches_traced": groups["b1_launches"],
            "launch_gaps": groups["launch_gaps"],
            "b1_slowest_alone_ms_events": alone[:5],
            "cudnn_device_ms": _device_busy(cudnn, 3)["device_ms"],
            "b1_bound_ms": max(t_op, t_mem),
            "b1_bound_by": "operations" if t_op >= t_mem else "bytes",
            "b1_fma_bound_ms": t_fma, "b1_alone_ms_events": alone}


# ---------------------------------------------------------------------------
# variants: the reference's other engine path, the lowerings, on the card
# ---------------------------------------------------------------------------

VARIANT_MODELS = (("resnet-50", 224), ("vgg-16", 224))
VARIANT_REQUESTS = 4


def b1_ms_by_node(session, x, iters: int = 5) -> dict:
    """B1's time on the card for each conv node of a default session's
    batch-1 predict, from a profiler trace that holds every launch: the
    launches of a predict come in the plan's conv order, so the k-th B1
    kernel of each predict is the k-th conv node's."""
    from torch.autograd import DeviceType

    names = plan_conv_names(session.plan_for(1))
    n = len(names)
    prof, _, _, gaps = _profiled(lambda: session.predict(x), iters,
                                 b1=iters * n)
    ks = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and B1_KERNEL in e.name and e.id not in gaps["lead_ids"]),
                key=lambda e: e.time_range.start)
    return {name: sum(ks[i * n + j].time_range.elapsed_us()
                      for i in range(iters)) / 1e3 / iters
            for j, name in enumerate(names)}


def conv_weight_bytes(model) -> int:
    """Bytes of a bound ``CompiledModel``'s conv weights."""
    return sum(model.params[n]["w"].nbytes for n in plan_conv_names(
        model.plan))


def phase_variant_times(run: dict, image: int, b1_node_ms: dict, device,
                        iters: int = 5) -> dict:
    """A lowering session's times at batch 1: predict latency (median of
    20 on the host clock around a synchronize); the card's time per
    predict, in all, by node group, and for each lowering (``variant/dtype``)
    the card's time of the conv nodes it runs, from a trace of ``iters``
    predicts under ``node_ranges`` with each conv node labelled by its
    lowering, which must hold no B1 launch; beside each lowering, B1's
    time on the same nodes (``b1_node_ms``, from the default session's
    trace) and cuDNN's fp32 ``F.conv2d`` + bias (TF32 off) on the same
    convs, by the card's time."""
    import torch.nn.functional as F

    from repro_torch.core.pipeline import make_workload

    session = run["session"]
    plan = session.plan_for(1)
    p = plan.planned
    labels = {}
    for name in plan_conv_names(plan):
        sc = p.schedules[name]
        labels[name] = f"{sc.resolved_variant()}/{sc.dtype}"
    lat = phase_latency(session, device, image, 1, 20)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 3, image, image)).astype(np.float32)).to(device)
    groups = device_ms_by_group(lambda: session.predict(x), iters, 0, labels)
    rows = {}
    for label in sorted(set(labels.values())):
        nodes = [nm for nm, lb in labels.items() if lb == label]
        cases: dict = {}
        for nm in nodes:
            node = p.graph.nodes[nm]
            wl = make_workload(node, p.graph.nodes[node.inputs[0]].shape)
            sc = p.schedules[nm]
            cases.setdefault(wl, [make_case(wl, sc.ic_bn, sc.oc_bn, device,
                                            shift=node.op == "conv_block"),
                                  0])[1] += 1

        def cudnn():
            for case, count in cases.values():
                for _ in range(count):
                    F.conv2d(case["x_nchw"], case["w_kcrs"],
                             case["shift_vec"], stride=case["stride"],
                             padding=case["pad"])

        rows[label] = {"nodes": len(nodes),
                       "device_ms": groups["by_group"].get(label, 0.0),
                       "b1_device_ms": sum(b1_node_ms[nm] for nm in nodes),
                       "cudnn_device_ms": _device_busy(cudnn, 3)["device_ms"]}
        del cases
    dev = groups["device_ms"]
    return {"latency_ms_batch1": lat["median_ms"],
            "device_ms_per_predict": dev,
            "idle_share_unprofiled": 1 - dev / lat["median_ms"],
            "device_ms_by_group": groups["by_group"],
            "b1_launches_traced": groups["b1_launches"],
            "launch_gaps": groups["launch_gaps"], "by_lowering": rows}


def phase_variants(device, smi: str, models=VARIANT_MODELS,
                   requests: int = VARIANT_REQUESTS,
                   big_batch: int = BIG_BATCH) -> list:
    """The reference's other engine path on the card: for each network,
    two sessions with ``use_kernel=False``, one fp32 and one
    ``dtype="int8"``, each through ``phase_main`` (``requests`` batch-1
    requests and one ``big_batch`` request, one lowering a conv node and
    no B1 launch a predict, every request held to a CPU session of the
    same plan: logits to ``LOGIT_TOL`` of the largest, equal top-1).  One
    line a session: the plan's lowerings, the lowering calls, B1's
    launches (0), its times (``phase_variant_times``) beside B1's on the
    same nodes of the default session, and, not gated, the int8 session's
    bound conv-weight bytes and its logits against the fp32 session's.
    Between them the sessions must run every lowering (the four fp32
    variants and the two int8 forms)."""
    from repro_torch.engine import compile

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 is on: the lowerings' cuBLAS products and "
                           "cuDNN would round their operands to 10 bits")
    lines, ran = [], {}
    for model, image in models:
        default = compile(model, (1, 3, image, image), seed=0, device=device)
        x = torch.from_numpy(np.random.default_rng(8).normal(
            size=(1, 3, image, image)).astype(np.float32)).to(device)
        b1_node_ms = b1_ms_by_node(default, x)
        del default
        runs = {}
        for dtype in ("fp32", "int8"):
            runs[dtype] = phase_main(device, image, requests=requests,
                                     big_batch=big_batch, model=model,
                                     use_kernel=False, dtype=dtype)
        wbytes = {d: conv_weight_bytes(r["session"].specialize(1))
                  for d, r in runs.items()}
        # the int8 session's logits against the fp32 session's, on the
        # same requests (not gated: random networks saturate)
        dev, top1 = 0.0, []
        for xr in requests_for(image, requests, big_batch):
            b = xr.shape[0]
            xt = torch.from_numpy(xr).to(device)
            f32, i8 = (with_logits(runs[d]["session"].specialize(b))
                       .predict(xt)[1].cpu().numpy() for d in runs)
            dev = max(dev, float(np.abs(i8 - f32).max() / np.abs(f32).max()))
            top1 += list(f32.argmax(axis=1) == i8.argmax(axis=1))
        for dtype, run in runs.items():
            for k, v in run["lowering_calls"].items():
                ran[k] = ran.get(k, 0) + v
            t = phase_variant_times(run, image, b1_node_ms, device)
            line = {"phase": "variants", "model": model, "image": image,
                    "dtype": dtype, "use_kernel": False, "card": smi,
                    **{k: run[k] for k in (
                        "requests", "conv_nodes", "plan_variants",
                        "lowering_calls", "launches",
                        "max_logit_err_vs_cpu_rel", "big_batch_vs_cpu")},
                    "conv_weight_bytes": wbytes[dtype], **t}
            if dtype == "int8":
                line.update(
                    conv_weight_bytes_fp32=wbytes["fp32"],
                    logits_vs_fp32_rel=dev,
                    top1_agrees_with_fp32=[sum(map(bool, top1)), len(top1)])
            emit(line)
            lines.append(line)
        del runs
        gc.collect()
        torch.cuda.empty_cache()
    missing = [k for k in lowering_calls() if not ran.get(k)]
    if missing:
        raise RuntimeError(f"no session ran the lowerings {missing}")
    return lines


# ---------------------------------------------------------------------------
# tuning: A5, the measured schedule search on the card, and Table 3
# ---------------------------------------------------------------------------

TUNING_MODELS = (("resnet-50", 224), ("vgg-16", 224))
# measured tuning's (top_k, per_variant, repeats): the reference's shortlist,
# ten back-to-back calls a candidate on the card's clock
TUNING_BUDGET = (6, 2, 10)
TUNING_ITERS = 20             # latency samples of each plan


def measured_search_stats(db, searches: int) -> dict:
    """What a database's measured entries took: searches, measurements
    (one a shortlisted candidate) and the workloads whose winner the
    analytical tie-break decided (more than one candidate within the noise
    floor of the fastest)."""
    from repro_torch.core.local_search import ties

    entries = [r for r in db._mem.values() if r.measured]
    return {"searches": searches, "measured_workloads": len(entries),
            "measurements": sum(len(r.ranked) for r in entries),
            "decided_by_tie_break": sum(1 for r in entries if ties(r) > 1)}


def interleaved_latency(a, b, x, iters: int) -> tuple:
    """Batch-1 predict latency of sessions ``a`` and ``b`` (ms, host clock
    around a synchronize), in the order A, B, B, A, ``iters`` samples each:
    the medians and each side's quartile spread."""
    for s in (a, b):
        s.predict(x)
    times = {id(a): [], id(b): []}
    for s in (a, b, b, a):
        for _ in range(iters // 2):
            t0 = time.perf_counter()
            s.predict(x)
            torch.cuda.synchronize()
            times[id(s)].append((time.perf_counter() - t0) * 1e3)

    def stats(t):
        q = statistics.quantiles(t, n=4)
        return {"median_ms": statistics.median(t), "iqr_ms": q[2] - q[0]}

    return stats(times[id(a)]), stats(times[id(b)])


def b1_per_predict(session, x) -> dict:
    """B1's launches in one predict of ``session``, in all and by route,
    with every count set to 0 just before."""
    from repro_torch.kernels.conv2d_nchwc import conv2d_nchwc

    reset_counts()
    session.predict(x)
    counts = read_counts()
    return {"launches": counts["conv2d_nchwc"],
            "by_route": {k: v for k, v in
                         conv2d_nchwc.launches_by_route.items() if v},
            "others": {k: v for k, v in counts.items()
                       if k != "conv2d_nchwc" and v}}


def held_to_cpu(card, model: str, image: int, xs: list, device) -> dict:
    """``card`` (a measured session) against a CPU session of the same seed
    built with ``tuning="cached"`` on the card session's database and
    transform bandwidth: the plans at batch 1 must be equal, and every
    request's outputs and logits held as ``phase_main`` holds them."""
    from repro_torch.engine import compile
    from repro_torch.engine.session import _plan_to_json

    cpu = compile(model, (1, 3, image, image), device="cpu",
                  tuning="cached", db=card.db,
                  transform_bw=card.transform_bw,
                  use_kernel=card.use_kernel)
    plans = [_plan_to_json(s.plan_for(1)) for s in (card, cpu)]
    for p in plans:
        p.pop("report")
    if plans[0] != plans[1]:
        raise RuntimeError(f"{model}: the measured plan differs from the "
                           "CPU session's on the same database")
    graph = card.plan_for(1).planned.graph
    softmax = [graph.nodes[o].op == "softmax" for o in graph.outputs]
    pair = [with_logits(s.specialize(1)) for s in (card, cpu)]
    err = raw_err = 0.0
    for x in xs:
        got, want = (_outputs(m.predict(torch.from_numpy(x).to(on)))
                     for m, on in zip(pair, (device, "cpu")))
        for i, (g, w) in enumerate(zip(got, want)):
            if i < len(softmax) and softmax[i]:
                np.testing.assert_allclose(g, w, **E2E_TOL)
                if (g.argmax(axis=1) != w.argmax(axis=1)).any():
                    raise RuntimeError(f"{model}: top-1 differs from the "
                                       "CPU session")
                err = max(err, float(np.abs(g - w).max()))
                continue
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL * scale)
            raw_err = max(raw_err, float(np.abs(g - w).max()) / scale)
    return {"plans_equal": True, "max_abs_err_vs_cpu": err,
            "max_logit_err_vs_cpu_rel": raw_err, **E2E_TOL,
            "logit_tol_rel": LOGIT_TOL}


def plan_times(session, image: int, device, iters: int = 5) -> dict:
    """Device ms per batch-1 predict of ``session``'s plan, in all and by
    node group (``device_ms_by_group``, a trace that must hold every B1
    launch), or "not measured" off the card."""
    if torch.device(device).type != "cuda":
        return {"device_ms_per_predict": "not measured"}
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 3, image, image)).astype(np.float32)).to(device)
    n_b1 = b1_per_predict(session, x)["launches"]
    g = device_ms_by_group(lambda: session.predict(x), iters, iters * n_b1)
    return {"device_ms_per_predict": g["device_ms"],
            "device_ms_by_group": g["by_group"],
            "b1_launches_traced": g["b1_launches"]}


def pass_seconds(session) -> dict:
    """Seconds of each pipeline pass of the session's batch-1 plan."""
    return {p.name: p.seconds for p in session.plan_for(1).report.passes}


def b1_node_diffs(roof, meas, x) -> list:
    """The conv nodes whose (ic_bn, oc_bn) the two plans set differently,
    each with B1's device ms in either plan (``b1_ms_by_node``) and what
    the measured search saw of the two schedules, slowest difference
    first: where the search and the end-to-end time may disagree."""
    from repro_torch.core.pipeline import make_workload

    a, b = (b1_ms_by_node(s, x) for s in (roof, meas))
    pa, pb = (s.plan_for(1).planned.schedules for s in (roof, meas))
    graph = meas.plan_for(1).planned.graph
    rows = []
    for name in a:
        blocks = [(p[name].ic_bn, p[name].oc_bn) for p in (pa, pb)]
        if blocks[0] == blocks[1]:
            continue
        node = graph.nodes[name]
        costs = meas.db.search(make_workload(
            node, graph.nodes[node.inputs[0]].shape),
            use_kernel=True).layout_costs()
        rows.append({"node": name,
                     "roofline": [*blocks[0], a[name]],
                     "measured": [*blocks[1], b[name]],
                     "search_ms": [costs[k] * 1e3 if k in costs else None
                                   for k in blocks]})
    return sorted(rows, key=lambda r: r["roofline"][2] - r["measured"][2])


def tuned_pair(device, model: str, image: int, budget, xs: list) -> dict:
    """One network at batch 1 on B1, compiled with ``tuning="roofline"``
    and with ``tuning="measured"`` (a fresh database): compile seconds,
    the measured search's searches, measurements and tie-break decisions,
    the probed ``transform_bw``, each plan's transforms, B1's launches a
    predict (once per conv node, all sm90), the interleaved latencies and
    each plan's device ms by node group; the measured session held to a
    CPU session on its database (``held_to_cpu``).  Every distinct conv of
    the measured plan goes through ``phase_kernels`` first."""
    from repro_torch.core.calibrate import probe_calls
    from repro_torch.core.local_search import SEARCH_COUNTERS
    from repro_torch.core.local_search import ScheduleDatabase
    from repro_torch.engine import compile

    on_card = torch.device(device).type == "cuda"
    spec = (1, 3, image, image)
    t0 = time.perf_counter()
    roof = compile(model, spec, seed=0, device=device)
    roof_s = time.perf_counter() - t0
    db = ScheduleDatabase()
    searches, probes = SEARCH_COUNTERS["guided_local_search"], probe_calls()
    t0 = time.perf_counter()
    meas = compile(model, spec, seed=0, device=device, tuning="measured",
                   db=db, search_budget=budget)
    meas_s = time.perf_counter() - t0
    stats = measured_search_stats(
        db, SEARCH_COUNTERS["guided_local_search"] - searches)
    stats["pass_seconds"] = pass_seconds(meas)
    convs = planned_convs(meas.plan_for(1))
    kernel_err = phase_kernels(device, convs) if on_card else None
    n_convs = sum(c["count"] for c in convs)
    x = torch.from_numpy(xs[0]).to(device)
    out = {"phase": "tuning", "model": model, "image": image,
           "budget": list(budget), "compile_s": {"roofline": roof_s,
                                                 "measured": meas_s},
           **stats, "probes": probe_calls() - probes,
           "transform_bw": meas.transform_bw,
           "transforms": {"roofline": roof.plan_for(1).planned.n_transforms,
                          "measured": meas.plan_for(1).planned.n_transforms},
           "conv_nodes": n_convs, "distinct_convs": len(convs),
           "kernel_vs_plain_max_abs_err": kernel_err}
    launches = {k: b1_per_predict(s, x) for k, s in
                (("roofline", roof), ("measured", meas))}
    for k, b1 in launches.items():
        want = n_convs if on_card else 0
        if (b1["launches"] != want or b1["others"]
                or (on_card and b1["by_route"] != {"sm90": want})):
            raise RuntimeError(f"{model} {k}: B1 launches a predict {b1}, "
                               f"expected {want}, all sm90")
    out["b1_per_predict"] = {k: b1["launches"] for k, b1 in launches.items()}
    if on_card:
        la, lb = interleaved_latency(roof, meas, x, TUNING_ITERS)
        out["latency"] = {"roofline": la, "measured": lb,
                          "order": "A B B A", "samples": TUNING_ITERS}
    out["times"] = {"roofline": plan_times(roof, image, device),
                    "measured": plan_times(meas, image, device)}
    if on_card:
        out["convs_b1_differs"] = b1_node_diffs(roof, meas, x)
    out.update(held_to_cpu(meas, model, image, xs, device))
    emit(out)
    return {"line": out, "session": meas, "compile_s": meas_s, "db": db}


def tuned_lowerings(device, model: str, image: int, budget,
                    xs: list) -> dict:
    """The reference's other engine measured: ``model`` fp32 with
    ``use_kernel=False`` and ``tuning="measured"``; the lowerings its plan
    chose beside the roofline plan's, no B1 launch and one lowering a conv
    node a predict, and the outputs held to a CPU session on its
    database."""
    from repro_torch.core.cost import machine_for
    from repro_torch.core.pipeline import Pipeline
    from repro_torch.engine import compile
    from repro_torch.models.cnn import build

    graph, shapes = build(model, batch=1, image=image)
    roof = Pipeline.preset("fusion").run(graph, shapes,
                                         machine=machine_for(False))
    t0 = time.perf_counter()
    meas = compile(model, (1, 3, image, image), seed=0, device=device,
                   tuning="measured", use_kernel=False, search_budget=budget)
    compile_s = time.perf_counter() - t0
    x = torch.from_numpy(xs[0]).to(device)
    low = sum(lowering_calls().values())
    b1 = b1_per_predict(meas, x)
    low = sum(lowering_calls().values()) - low
    n_convs = len(plan_conv_names(meas.plan_for(1)))
    if b1["launches"] or b1["others"] or low != n_convs:
        raise RuntimeError(f"{model} lowerings: B1 {b1}, lowerings {low} "
                           f"of {n_convs} conv nodes")
    out = {"phase": "tuning_lowerings", "model": model, "image": image,
           "compile_s": compile_s, "transform_bw": meas.transform_bw,
           "plan_variants": {"roofline": plan_variants(roof),
                             "measured": plan_variants(meas.plan_for(1))},
           "transforms": {"roofline": roof.planned.n_transforms,
                          "measured": meas.plan_for(1).planned.n_transforms},
           "b1_per_predict": 0, "lowerings_per_predict": low}
    if torch.device(device).type == "cuda":
        g = device_ms_by_group(lambda: meas.predict(x), 5, 0)
        out["device_ms_per_predict"] = g["device_ms"]
        out["device_ms_by_group"] = g["by_group"]
    out.update(held_to_cpu(meas, model, image, xs, device))
    emit(out)
    return out


def ladder(device, model: str, image: int, db, budget, x,
           modes=None) -> list:
    """The paper's Table 3 on the card: ``model`` at batch 1 under each
    pipeline of ``MODES`` with measured tuning on B1, all on ``db`` (the
    search runs once a workload); each rung's distinct blocked convs go
    through ``phase_kernels`` before it is timed.  One line a rung:
    compile seconds, transforms, B1 launches a predict, latency (median of
    ``TUNING_ITERS``) and device ms a predict by node group.  The ``nchw``
    rung runs no blocked conv: its convs are the unblocked direct conv
    (``nn/ops.py::conv2d_nchw_direct``), B1 launches none."""
    from repro_torch.core.pipeline import MODES, Pipeline
    from repro_torch.engine import compile

    on_card = torch.device(device).type == "cuda"
    lines = []
    for mode in modes or MODES:
        t0 = time.perf_counter()
        sess = compile(model, (1, 3, image, image), seed=0, device=device,
                       pipeline=Pipeline.preset(mode), tuning="measured",
                       db=db, search_budget=budget)
        compile_s = time.perf_counter() - t0
        convs = planned_convs(sess.plan_for(1))
        err = phase_kernels(device, convs) if on_card and convs else None
        b1 = b1_per_predict(sess, x)
        want = sum(c["count"] for c in convs) if on_card else 0
        if b1["launches"] != want or b1["others"]:
            raise RuntimeError(f"ladder {mode}: B1 {b1}, expected {want}")
        line = {"phase": "ladder", "model": model, "image": image,
                "mode": mode, "compile_s": compile_s,
                "pass_seconds": pass_seconds(sess),
                "transforms": sess.plan_for(1).planned.n_transforms,
                "b1_per_predict": b1["launches"],
                "distinct_convs": len(convs),
                "kernel_vs_plain_max_abs_err": err}
        if on_card:
            line["latency_ms"] = phase_latency(sess, device, image, 1,
                                               TUNING_ITERS)["median_ms"]
            line.update(plan_times(sess, image, device))
        emit(line)
        lines.append(line)
        del sess
    return lines


def cudnn_nchw(device, convs: list) -> dict:
    """cuDNN's fp32 ``F.conv2d`` (TF32 off) with bias over ``convs`` (each
    its count), in NCHW: the library's baseline for the ladder, by the
    card's time."""
    import torch.nn.functional as F

    cases = [(make_case(c["wl"], c["ic_bn"], c["oc_bn"], device,
                        shift=c.get("shift", True)), c["count"])
             for c in convs]

    def run():
        for case, count in cases:
            for _ in range(count):
                F.conv2d(case["x_nchw"], case["w_kcrs"], case["shift_vec"],
                         stride=case["stride"], padding=case["pad"])

    return {"phase": "ladder", "mode": "cudnn_nchw",
            "convs": sum(n for _, n in cases),
            "device_ms": _device_busy(run, 3)["device_ms"]}


def phase_tuning(device, smi: str, models=TUNING_MODELS,
                 budget=TUNING_BUDGET, lowerings=True, modes=None) -> dict:
    """A5 on the card: the card's SM count and shared memory
    (``MachineModel.from_device``) beside ``h100()``'s; for each network
    ``tuned_pair`` (roofline against measured on B1, held to a CPU
    session); ``tuned_lowerings`` on the first; then the Table 3 ladder
    (``ladder``) on the first network, sharing its measured database,
    beside cuDNN NCHW.  Returns the lines and the first network's
    measured session (for ``phase_artifacts``)."""
    if torch.device(device).type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 is on: the lowerings' cuBLAS products and "
                           "cuDNN would round their operands to 10 bits")
    lines, first = [], None
    if torch.device(device).type == "cuda":
        from repro_torch.core.cost import H100, MachineModel

        card = MachineModel.from_device(device)
        lines.append({"phase": "tuning_machine", "card": smi,
                      "cores": card.cores,
                      "fast_mem_bytes": card.fast_mem_bytes,
                      "equals_h100": card == H100})
        emit(lines[-1])
    for model, image in models:
        xs = requests_for(image, 2, 1)[:2]
        run = tuned_pair(device, model, image, budget, xs)
        lines.append({**run["line"], "card": smi})
        if first is None:
            first = {**run, "model": model, "image": image}
        else:
            del run
    model, image = first["model"], first["image"]
    xs = requests_for(image, 2, 1)[:2]
    if lowerings:
        lines.append({**tuned_lowerings(device, model, image, budget, xs),
                      "card": smi})
    x = torch.from_numpy(xs[0]).to(device)
    rungs = ladder(device, model, image, first["db"], budget, x, modes)
    if torch.device(device).type == "cuda":
        rungs.append(cudnn_nchw(device, planned_convs(
            first["session"].plan_for(1))))
        emit({**rungs[-1], "model": model, "image": image})
    lines += [{**r, "card": smi} for r in rungs]
    gc.collect()
    return {"lines": lines, "session": first["session"],
            "model": model, "image": image,
            "compile_s": first["compile_s"]}


# ---------------------------------------------------------------------------
# 4. lm_kernels: B3 and B4 against their plain versions
# ---------------------------------------------------------------------------

# B3 kernel vs plain: fp32 sums of up to 2,048 terms (scores over D, then
# the weighted sum over keys) in another order, on outputs of order 1;
# bf16 inputs, both outputs rounded to bf16 and compared in fp32: the two
# roundings may differ by one bf16 step (2^-7 relative at most), which the
# rtol covers; the atol was set at twice the largest error of the FMA
# kernel on bf16 (3.9e-3), so that a wrong tile in the late rows of
# S = 2,048, whose outputs average ~700 keys to ~0.04, fails.  The sm90
# route also rounds the probabilities P to bf16 before P.V (2^-9 relative
# each); its largest errors (1.56e-2 = 2^-6) are one bf16 step at outputs
# in [2, 4), the early rows that average few keys, inside the rtol; each
# case reports the largest share of the tolerance it used (gate_share)
ATTN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=8e-3)}
# B4 kernel vs plain: fp32 sums of 128 + 256 terms in another order (the
# kernel's 3xTF32 products carry ~2^-22 of each product besides); the
# inputs are scaled so that c.b is of order 1 and y at most ~16 (no decay)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
# B4's per-position log-decay steps -dt*A: "slow" lies in Mamba-2's dt*A
# range and decays exp(-2.7) at most over a 256-token chunk, so every
# (row tile, column tile) pair adds well above SSD_TOL; "none" (acum = 0)
# weighs every column alike; "steep" (mean 0.25 per step) checks the
# exponent's range but hides columns more than ~40 positions back;
# "cliff" (mean 0.65 per step) takes acum_i - acum_j past 88 for j > i
# over a chunk, where exp overflows fp32 unless the mask comes first
SSD_DECAY = {"slow": (1e-3, 2e-2), "steep": (0.01, 0.5), "none": None,
             "cliff": (0.3, 1.0)}
# LM card vs CPU, fp32 at full width and 2 layers: the same sums through
# the projections (K up to 8,960) and the head, in another order, compared
# relative to the largest logit
LM_LOGIT_TOL = 1e-4
# B2 kernel vs plain, for a softmax tail: fp32 logits summed in another
# order, then the same exp and normalisation; the inputs are scaled like
# arctic-480b's router (weights N(0, 0.02^2)), so the logits are of order 1
# and the probabilities not one-hot.  Other tails are held against the fp64
# product instead: a dot product of K fp32 terms lies within
# K * 2^-24 * (|a| @ |b|) of the exact one in any order (ROADMAP C), times
# |scale|, plus one rounding of the scale and, for a bf16 output, half a
# bf16 step (2^-8 relative: 8 significant bits).  That bound is loose at
# K = 7,168 (~2 against values of ~85), so the same outputs are also held
# against plain, which takes the same fp32 operands: within PLAIN_REL of
# the largest unmasked |plain| (fp32 sums in another order differ by
# ~4e-7 of it at the router's identity tail; operands rounded to TF32
# would miss by ~4e-4, to bf16 by ~2e-3), plus one bf16 step (2^-7
# relative) for a bf16 output, whose
# rounding of two nearly equal fp32 sums may differ; masked entries
# (NEG_INF) must be equal.
PROB_TOL = dict(rtol=1e-4, atol=1e-6)
PLAIN_REL = 1e-5
U32 = 2.0 ** -24
MM_SPECS = {
    "identity": {}, "softmax": dict(softmax=True),
    "scale_softmax": dict(scale=0.125, softmax=True),
    "causal_softmax": dict(mask="causal", softmax=True),
    "attention_tail": dict(scale=0.25, mask="causal", softmax=True),
    "scale_only": dict(scale=2.0), "causal_only": dict(mask="causal"),
    "scale_relu": dict(scale=0.5, relu=True)}
ROUTER_K, ROUTER_N = 7168, 128       # arctic-480b's d_model and experts
ROUTER_M = (2048, 1, 4)              # tokens: prefill, decode at batch 1, 4
KIMI_N = 384                         # kimi-k2's experts (its d_model is 7,168)


def attn_cases() -> list:
    """(name, B, Hq, Hkv, S, D, causal, window, dtype, Sk): Sk, the keys'
    length, is S but for cross-attention."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for s in (512, 1024, 2048):
        for dt in (bf, f32):
            cases.append((f"qwen2_s{s}_{str(dt)[6:]}", 1, 12, 2, s, 128,
                          True, 0, dt))
    # arctic-480b's prefill shapes (56:8 heads), as its served path runs
    # them: bf16, the three buckets at batch 1 and the batch-4 session
    cases += [(f"arctic_s{s}_bfloat16", 1, 56, 8, s, 128, True, 0, bf)
              for s in (512, 1024, 2048)]
    cases.append(("arctic_b4_s512_bfloat16", 4, 56, 8, 512, 128, True, 0,
                  bf))
    cases += [("qwen2_b4_s512_bfloat16", 4, 12, 2, 512, 128, True, 0, bf),
              ("qwen2_ragged_s700_bfloat16", 1, 12, 2, 700, 128, True, 0, bf),
              ("window64_d256_s300_float32", 1, 10, 1, 300, 256, True, 64,
               f32),
              ("window64_d256_s300_bfloat16", 1, 10, 1, 300, 256, True, 64,
               bf),
              # kimi-k2's prefill (64:8 heads, head dim 112) and a head
              # dim of 80 (stablelm-3b's)
              ("kimi_k2_s2048_d112_bfloat16", 1, 64, 8, 2048, 112, True, 0,
               bf),
              ("mha_d80_s512_bfloat16", 1, 32, 32, 512, 80, True, 0, bf),
              # the same two head dims on the fp32 route (stablelm-3b's
              # and kimi-k2's fp32 sessions)
              ("kimi_k2_s512_d112_float32", 1, 64, 8, 512, 112, True, 0,
               f32),
              ("mha_d80_s512_float32", 1, 32, 32, 512, 80, True, 0, f32),
              ("noncausal_s512_float32", 1, 12, 2, 512, 128, False, 0, f32),
              ("mha_d64_s333_float32", 2, 4, 4, 333, 64, True, 0, f32),
              ("reduced_d16_s40_float32", 2, 4, 2, 40, 16, True, 0, f32)]
    # the A8 families' shapes: recurrentgemma-2b's banded prefill (10:1,
    # head dim 256, window 2,048) at each of its buckets, llava's 2,880
    # image + 512 text tokens (32:8), whisper-tiny's non-causal encoder
    # (1,500 frames, 6 heads of 64), its causal decoder self-attention over
    # a 4-token prompt, and its cross-attention (queries of a prompt and of
    # a decode step, and a full decoder context of 448, against the 1,500
    # encoder positions), each at the batches the main path runs (1 and
    # 4); fp32 at one shape each
    cases = [(*c, c[4]) for c in cases]
    cases += [(f"rgemma_window2048_s{s}_bfloat16", 1, 10, 1, s, 256, True,
               2048, bf, s) for s in (1152, 2304, 4608)]
    cases += [(f"whisper_dec_b{b}_s4_bfloat16", b, 6, 6, 4, 64, True, 0, bf,
               4) for b in (1, 4)]
    cases += [("rgemma_window2048_s2304_float32", 1, 10, 1, 2304, 256, True,
               2048, f32, 2304),
              ("llava_s3392_bfloat16", 1, 32, 8, 3392, 128, True, 0, bf,
               3392),
              ("whisper_enc_s1500_bfloat16", 1, 6, 6, 1500, 64, False, 0, bf,
               1500),
              ("whisper_enc_b4_s1500_bfloat16", 4, 6, 6, 1500, 64, False, 0,
               bf, 1500),
              ("whisper_enc_s1500_float32", 1, 6, 6, 1500, 64, False, 0, f32,
               1500)]
    cases += [(f"whisper_cross_b{b}_q{s}_k1500_{str(dt)[6:]}", b, 6, 6, s,
               64, False, 0, dt, 1500)
              for b, s, dt in ((1, 1, bf), (4, 1, bf), (1, 4, bf), (4, 4, bf),
                               (1, 448, bf), (1, 4, f32))]
    return cases


B3_ROUTE = {torch.bfloat16: "sm90", torch.float32: "fma"}


def attn_inputs(b, hq, hkv, s, d, dtype, device, seed=0, sk=None):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, d), generator=g).to(device=device,
                                                         dtype=dtype)
               for h, n in ((hq, s), (hkv, sk or s), (hkv, sk or s)))
    return q, k, v


def ssd_cases() -> list:
    """(name, BC, H, Q, N, P, decay): mamba2-130m's prefill at 512, 1,024
    and 2,048 tokens with slow decay (the first three, which are timed),
    its 512-token shape with steep, no and overflowing decay, 2,048 tokens
    with 23 heads (a last head group of 3 where the plan takes 4 a block),
    the reduced config's chunk, and ragged Q, N and P."""
    return [(f"mamba2_bc{bc}_slow", bc, 24, 256, 128, 64, "slow")
            for bc in (2, 4, 8)] \
        + [("mamba2_bc2_steep", 2, 24, 256, 128, 64, "steep"),
           ("mamba2_bc2_nodecay", 2, 24, 256, 128, 64, "none"),
           ("mamba2_bc2_cliff", 2, 24, 256, 128, 64, "cliff"),
           ("mamba2_bc8_h23_slow", 8, 23, 256, 128, 64, "slow"),
           ("reduced_q8_slow", 3, 8, 8, 16, 16, "slow"),
           ("ragged_q100_n20_p40_slow", 1, 3, 100, 20, 40, "slow")]


def ssd_inputs(bcn, h, q, n, p, device, decay="slow", seed=0):
    rng = np.random.default_rng(seed)
    scale = n ** -0.25                 # c.b ~ N(0, 1)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    cc = t(rng.normal(0, scale, size=(bcn, q, n)))
    bc = t(rng.normal(0, scale, size=(bcn, q, n)))
    # cumulative decay logs: non-increasing (dt * A with A < 0)
    steps = SSD_DECAY[decay]
    acum = t(np.zeros((bcn, h, q)) if steps is None else
             -np.cumsum(rng.uniform(*steps, size=(bcn, h, q)), axis=-1))
    xd = t(rng.normal(size=(bcn, h, q, p)))
    return cc, bc, acum, xd


def mm_cases() -> list:
    """(name, M, K, N, tail, operand dtype): arctic-480b's router at
    prefill and decode with fp32 and bf16 operands, kimi-k2's (384
    experts), the splitk / sm90 boundary (M = 16, 63, 64), the identity
    tail at the prefill router shape with fp32 and bf16 operands, every
    tail of the reference's tests at their shapes with fp32 and bf16
    operands, and two ragged shapes."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(f"router_m{m}_{str(dt)[6:]}", m, ROUTER_K, ROUTER_N,
              "softmax", dt) for m in ROUTER_M for dt in (f32, bf)]
    cases += [(f"kimi_k2_router_m{m}_bfloat16", m, ROUTER_K, KIMI_N,
               "softmax", bf) for m in ROUTER_M]
    cases += [(f"router_m{m}_bfloat16", m, ROUTER_K, ROUTER_N, "softmax",
               bf) for m in (16, 63, 64)]
    cases += [(f"router_identity_m2048_{str(dt)[6:]}", 2048, ROUTER_K,
               ROUTER_N, "identity", dt) for dt in (f32, bf)]
    # the reference's tails at its shapes: fp32 (fma, splitk at M = 40) and
    # bf16 (sm90 at M >= 64, splitk at M = 40)
    for tail in MM_SPECS:
        for m, k, n in ((128, 128, 128), (96, 64, 80), (40, 32, 200)):
            cases.append((f"{tail}_{m}x{k}x{n}", m, k, n, tail, f32))
            cases.append((f"{tail}_{m}x{k}x{n}_bfloat16", m, k, n, tail, bf))
    for m, k, n in ((100, 130, 60), (33, 257, 129)):
        for tail in ("softmax", "attention_tail", "identity", "scale_relu"):
            for dt in (f32, bf):
                cases.append((f"ragged_{tail}_{m}x{k}x{n}_{str(dt)[6:]}",
                              m, k, n, tail, dt))
    return cases


def mm_inputs(m, k, n, dtype, device, softmax: bool, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k))
    b = rng.normal(0, 0.02 if softmax else 1.0, size=(k, n))
    return (torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                      dtype=dtype),
            torch.from_numpy(b.astype(np.float32)).to(device=device,
                                                      dtype=dtype))


def mm_plain(a, b, spec, n_valid=None, out_dtype=None):
    """B2's plain version on operands padded as the reference's
    ``matmul_padded`` pads them, sliced back."""
    from repro_torch.kernels.matmul_blocked import (MatmulSchedule,
                                                    matmul_plain,
                                                    pad_operands)

    m, n = a.shape[0], b.shape[1]
    ap, bp, s, nv = pad_operands(a, b, MatmulSchedule(), spec)
    return matmul_plain(ap, bp, schedule=s, epilogue=spec,
                        n_valid=n_valid or nv, out_dtype=out_dtype)[:m, :n]


def mm_fp64(a, b, spec, out_dtype):
    """A non-softmax tail on the fp64 product, and the error an fp32
    computation of it may carry (see PROB_TOL's comment)."""
    from repro_torch.core.epilogue import NEG_INF

    a64, b64 = a.double(), b.double()
    x = a64 @ b64
    err = a.shape[1] * U32 * (a64.abs() @ b64.abs())
    if spec.scale is not None:
        x = x * spec.scale
        err = err * abs(spec.scale) + U32 * x.abs()
    if spec.mask == "causal":
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        cols = torch.arange(x.shape[1], device=x.device)[None, :]
        # NEG_INF as fp32 stores it: masked entries must match exactly
        x = torch.where(rows >= cols, x, float(np.float32(NEG_INF)))
        err = torch.where(rows >= cols, err, 0.0)
    if spec.relu:
        x = x.clamp_min(0.0)
    if out_dtype == torch.bfloat16:
        err = err + 2.0 ** -8 * x.abs()
    return x, err


def check_b2(name, got, a, b, spec, device, n_valid=None,
             route=None) -> float:
    """B2's output against its plain version; any tail but a softmax also
    against the fp64 bound.  Returns the largest error against plain."""
    want = mm_plain(a, b, spec, n_valid=n_valid, out_dtype=got.dtype)
    torch.cuda.synchronize(device)
    if not torch.isfinite(got).all():
        raise RuntimeError(f"B2 {name}: non-finite kernel output")
    err = float((got.float() - want.float()).abs().max())
    row = {"phase": "lm_kernel_vs_plain", "kernel": "matmul_blocked",
           "case": name, "route": route, "out_dtype": str(got.dtype)[6:],
           "max_abs_err": err}
    if spec.softmax:
        torch.testing.assert_close(got.float(), want.float(), **PROB_TOL)
        row.update(PROB_TOL)
    else:
        x, bound = mm_fp64(a, b, spec, got.dtype)
        excess = float(((got.double() - x).abs() - bound).max())
        row.update(fp64_excess=excess, fp64_bound="K*2^-24*(|a|@|b|)")
        if excess > 0:
            raise RuntimeError(f"B2 {name}: beyond the fp64 bound by "
                               f"{excess:.3g}")
        ref = want.float()
        live = ref.abs() < 1e29
        if not torch.equal(got.float()[~live], ref[~live]):
            raise RuntimeError(f"B2 {name}: masked entries differ")
        step = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
        ref = ref[live]
        over = float(((got.float()[live] - ref).abs() - step * ref.abs())
                     .max() / ref.abs().max()) if ref.numel() else 0.0
        row.update(plain_rel_err=over, plain_rel_tol=PLAIN_REL)
        if over > PLAIN_REL:
            raise RuntimeError(f"B2 {name}: differs from plain by {over:.3g}"
                               f" of the largest output (tolerance "
                               f"{PLAIN_REL})")
    emit(row)
    return err


def b2_launch(a, b, **kw):
    """One B2 launch and the route it took, by ``launches_by_route``."""
    from repro_torch.kernels.matmul_blocked import matmul_blocked

    before = dict(matmul_blocked.launches_by_route)
    out = matmul_blocked(a, b, **kw)
    routes = [r for r, n in matmul_blocked.launches_by_route.items()
              if n != before[r]]
    return out, routes


def phase_lm_b2(device) -> dict:
    """B2 against its plain version on every case of ``mm_cases``, each
    on the route ``_route`` names for it and bit-identical over two
    launches, then ``attention_probs`` at S = 512, D = 128, and a
    padded-operand case with ``n_valid``; returns the largest abs error of
    each route."""
    from repro_torch.core.epilogue import EpilogueSpec
    from repro_torch.kernels.matmul_blocked import (MatmulSchedule, _route,
                                                    pad_operands)
    from repro_torch.kernels.ops import attention_probs

    worst = {"splitk": 0.0, "sm90": 0.0, "fma": 0.0}
    for name, m, k, n, tail, dt in mm_cases():
        spec = EpilogueSpec(**MM_SPECS[tail])
        a, b = mm_inputs(m, k, n, dt, device, spec.softmax)
        # the router reads its probabilities in fp32, and the identity
        # tail at the router's shape is held in fp32 against the fp64
        # bound; other tails store in the operands' type
        out_dtype = torch.float32 if spec.softmax \
            or name.startswith("router") else dt
        got, routes = b2_launch(a, b, epilogue=spec, out_dtype=out_dtype)
        again, _ = b2_launch(a, b, epilogue=spec, out_dtype=out_dtype)
        route = _route(m, k, n, dt)
        if routes != [route]:
            raise RuntimeError(f"B2 {name}: took route {routes}, expected "
                               f"{route}")
        torch.cuda.synchronize(device)
        if not torch.equal(got, again):
            raise RuntimeError(f"B2 {name}: two launches differ ({route})")
        worst[route] = max(worst[route],
                           check_b2(name, got, a, b, spec, device,
                                    route=route))
    for causal in (True, False):
        q, k = attn_inputs(1, 1, 1, 512, 128, torch.float32, device)[:2]
        q, k = q[0, 0], k[0, 0]
        spec = EpilogueSpec(scale=128 ** -0.5,
                            mask="causal" if causal else "none", softmax=True)
        got = attention_probs(q, k, causal=causal)
        worst["fma"] = max(worst["fma"], check_b2(
            f"attention_probs_s512_d128_{'causal' if causal else 'full'}",
            got, q, k.t().contiguous(), spec, device, route="fma"))
    # operands padded as the reference pads them, with n_valid: equal to
    # the unpadded result, the padded columns at probability 0
    spec = EpilogueSpec(scale=0.5, softmax=True)
    a, b = mm_inputs(70, 200, 50, torch.float32, device, True, seed=1)
    ap, bp, _, nv = pad_operands(a, b, MatmulSchedule(), spec)
    got, _ = b2_launch(ap, bp, epilogue=spec, n_valid=nv)
    flat, _ = b2_launch(a, b, epilogue=spec)
    worst["fma"] = max(worst["fma"], check_b2(
        "padded_70x200x50_n_valid", got, ap, bp, spec, device, n_valid=nv,
        route="fma"))
    torch.testing.assert_close(got[:70, :50], flat, **PROB_TOL)
    if not torch.all(got[:, 50:] == 0):
        raise RuntimeError("B2: padded columns got probability mass")
    return worst


def phase_lm_b3(device, cases=None) -> float:
    """B3 against its plain version on every ``attn_cases`` case (or
    ``cases``), each line naming the route the launch took; returns the
    largest abs error."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    worst = 0.0
    for name, b, hq, hkv, s, d, causal, window, dt, sk in \
            cases or attn_cases():
        q, k, v = attn_inputs(b, hq, hkv, s, d, dt, device, sk=sk)
        before = dict(flash_attention.launches_by_route)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize(device)
        routes = [r for r, n in flash_attention.launches_by_route.items()
                  if n != before[r]]
        if not torch.isfinite(got).all():
            raise RuntimeError(f"B3 {name}: non-finite kernel output")
        diff = (got.float() - want.float()).abs()
        tol = ATTN_TOL[dt]
        share = float((diff / (tol["atol"] + tol["rtol"]
                               * want.float().abs())).max())
        err = float(diff.max())
        emit({"phase": "lm_kernel_vs_plain", "kernel": "flash_attention",
              "case": name, "sk": sk, "route": routes, "max_abs_err": err,
              "gate_share": share, **tol})
        if routes != [B3_ROUTE[dt]]:
            raise RuntimeError(f"B3 {name}: took route {routes}, expected "
                               f"{B3_ROUTE[dt]}")
        torch.testing.assert_close(got.float(), want.float(), **tol)
        worst = max(worst, err)
    return worst


def phase_lm_b4(device) -> float:
    """B4 against its plain version on every ``ssd_cases`` case, each line
    naming the plan's heads a block and the share of the tolerance used;
    two launches must be bit-identical.  Returns the largest abs error."""
    from repro_torch.kernels.ssd_chunk import (launch_plan, ssd_intra,
                                               ssd_intra_plain)

    worst = 0.0
    for name, bcn, h, q, n, p, decay in ssd_cases():
        args = ssd_inputs(bcn, h, q, n, p, device, decay)
        got = ssd_intra(*args)
        again = ssd_intra(*args)
        want = ssd_intra_plain(*args)
        torch.cuda.synchronize(device)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"B4 {name}: non-finite kernel output")
        diff = (got - want).abs()
        share = float((diff / (SSD_TOL["atol"]
                               + SSD_TOL["rtol"] * want.abs())).max())
        err = float(diff.max())
        emit({"phase": "lm_kernel_vs_plain", "kernel": "ssd_intra",
              "case": name, "heads": launch_plan(bcn, h, q, n, p)["heads"],
              "max_abs_err": err, "gate_share": share,
              "max_abs_y": float(want.abs().max()), **SSD_TOL})
        torch.testing.assert_close(got, want, **SSD_TOL)
        if not torch.equal(got, again):
            raise RuntimeError(f"B4 {name}: two launches differ")
        worst = max(worst, err)
    return worst


def phase_lm_kernels(device) -> dict:
    """B2, B3 and B4 against their plain versions; returns the largest abs
    error of each (B2's by route)."""
    return {"matmul_blocked": phase_lm_b2(device),
            "flash_attention": phase_lm_b3(device),
            "ssd_intra": phase_lm_b4(device)}


# ---------------------------------------------------------------------------
# 5. lm_main: the LM serving path
# ---------------------------------------------------------------------------

def _kernel_fns() -> dict:
    from repro_torch.kernels.conv2d_nchwc import conv2d_nchwc
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul_blocked import matmul_blocked
    from repro_torch.kernels.ssd_chunk import ssd_intra

    return {"conv2d_nchwc": conv2d_nchwc, "matmul_blocked": matmul_blocked,
            "flash_attention": flash_attention, "ssd_intra": ssd_intra}


def reset_counts() -> None:
    for fn in _kernel_fns().values():
        fn.launches = 0
        by_route = getattr(fn, "launches_by_route", {})
        for route in by_route:
            by_route[route] = 0


def b3_routes() -> dict:
    return dict(_kernel_fns()["flash_attention"].launches_by_route)


def b2_routes() -> dict:
    return dict(_kernel_fns()["matmul_blocked"].launches_by_route)


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_fns().items()}


@contextlib.contextmanager
def moe_recording():
    """Record each MoE layer call of the port while the block runs, in
    order: its router probabilities (T, E), capacity and aux (lb_loss,
    dropped_frac).  ``layers.moe_ffn`` and the router's ``dense_softmax``
    are wrapped, not replaced: every call still runs, and launches, as
    before."""
    from repro_torch.models.lm import layers as L

    calls = []
    real_ffn, real_softmax = L.moe_ffn, L.dense_softmax

    def softmax(x, w, **kw):
        probs = real_softmax(x, w, **kw)
        calls.append({"probs": probs})
        return probs

    def ffn(x, p, cfg):
        y, aux = real_ffn(x, p, cfg)
        calls[-1].update(capacity=L.moe_capacity(x.shape[0], cfg), **aux)
        return y, aux

    L.moe_ffn, L.dense_softmax = ffn, softmax
    try:
        yield calls
    finally:
        L.moe_ffn, L.dense_softmax = real_ffn, real_softmax


def lm_kernels_of(cfg) -> dict:
    """The kernels a model's requests launch on the card, each with its
    launches per prefill and per decode step: B3 in every attention
    prefill (hybrid: its banded layers; encdec: the encoder's, the
    decoder's and its cross-attention) and in every cross-attention of an
    encdec decode step, B4 in every Mamba-2 prefill, B2 in every MoE
    router."""
    n = cfg.n_layers
    if cfg.family == "ssm":
        return {"ssd_intra": (n, 0)}
    if cfg.family == "hybrid":
        return {"flash_attention": (sum(cfg.layer_kind(i) == "attn"
                                        for i in range(n)), 0)}
    if cfg.family == "encdec":
        return {"flash_attention": (cfg.enc_layers + 2 * n, n)}
    out = {"flash_attention": (n, 0)}
    if cfg.family == "moe":
        out["matmul_blocked"] = (n, n)
    return out


LM_MODELS = ("qwen2-1.5b", "mamba2-130m")
ARCTIC = "arctic-480b"          # served at full width, depth cut to 2
ARCTIC_LAYERS = 2
# its parity copy: fp32 at full width, 1 layer and 8 of the 128 experts;
# a bucket of 128 plus 8 catch-up steps
ARCTIC_PARITY = dict(n_layers=1, n_experts=8, max_len=512, prompt=136,
                     new=8)
# (entry, wrapper, route, model, source, TPU kernel, the row of
# ``phase_lm_kernel_times[wrapper]``): B2's two routes of arctic-480b's
# main path (sm90 at its 2,048-token prefill, splitk at a batch-1 decode
# step), B3 at qwen2-1.5b's 2,048-token prefill, B4 at mamba2-130m's
LM_KERNEL_ROWS = (
    ("matmul_blocked_sm90", "matmul_blocked", "sm90", ARCTIC,
     "src/repro_torch/csrc/matmul_blocked_sm90.cu",
     "src/repro/kernels/matmul_blocked.py:73", 0),
    ("matmul_splitk", "matmul_blocked", "splitk", ARCTIC,
     "src/repro_torch/csrc/matmul_splitk.cu",
     "src/repro/kernels/matmul_blocked.py:73", 1),
    ("flash_attention", "flash_attention", None, "qwen2-1.5b",
     "src/repro_torch/csrc/flash_attention_sm90.cu",
     "src/repro/kernels/flash_attention.py:84", 2),
    ("ssd_intra", "ssd_intra", None, "mamba2-130m",
     "src/repro_torch/csrc/ssd_chunk_sm90.cu",
     "src/repro/kernels/ssd_chunk.py:46", 2))
LM_REQUESTS = ((2048, 1), (1024, 64), (700, 64), (100, 32))
LM_BIG = (4, 1024, 512, 32)     # batch, max_len, prompt, new tokens
# The A8 families at full width, bf16.  recurrentgemma-2b (hybrid) through
# the session: buckets {1,152, 2,304, 4,608} against its window of 2,048,
# so one prefill lies below the window and two roll the ring (by 256 and
# 512); the second request decodes 31 steps on the full ring.  Its parity
# copy: 3 layers (rec, rec, attn), a 2,304 bucket past the window and 9
# decode steps on the ring.
HYBRID = "recurrentgemma-2b"
HYBRID_MAX_LEN = 4608
HYBRID_REQUESTS = ((1200, 16), (2304, 32), (4608, 1))
HYBRID_PARITY = dict(n_layers=3, max_len=4608, prompt=2306, new=8)
# llava-next-mistral-7b (vlm; 2,880 image tokens from a stub frontend) and
# whisper-tiny (encdec; 1,500 frames) through the model's prefill and
# decode_step, as the reference's tests drive them: (max_len, text prompt,
# new tokens, batches).  Parity copies at 2 layers, llava's with 256
# image tokens and whisper's with 2 encoder layers.
FRONTEND = {"llava-next-mistral-7b": (4096, 512, 32, (1,)),
            "whisper-tiny": (448, 4, 60, (1, 4))}
FRONTEND_PARITY = {
    "llava-next-mistral-7b": dict(n_layers=2, n_img_tokens=256, max_len=512,
                                  prompt=64, new=8),
    "whisper-tiny": dict(n_layers=2, enc_layers=2, max_len=448, prompt=4,
                         new=8)}


def arctic_config():
    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS[ARCTIC], n_layers=ARCTIC_LAYERS)


def phase_lm_main(device, model, max_len: int = 2048,
                  requests=LM_REQUESTS, big=LM_BIG, seed: int = 0) -> dict:
    """The user's LM path: ``compile(model, (1, max_len))`` answers
    ``requests`` (prompt length, new tokens), then (unless ``big`` is
    None) a batch-``big[0]`` session over the same weights answers one
    request.  Every count is set
    to 0 just before and read just after; on the card each of the model's
    kernels (``lm_kernels_of``) must launch its count per prefill and per
    decode step, and no other kernel.  A MoE model reports the dropped
    share of each prefill, and its decode steps must drop nothing."""
    from repro_torch.engine import compile
    from repro_torch.models.lm.model import prefill

    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed + 1)
    t0 = time.perf_counter()
    session = compile(model, (1, max_len), seed=seed, device=device)
    compile_s = time.perf_counter() - t0
    cfg = session.cfg
    kernels = lm_kernels_of(cfg)
    work = [(session, (1, n), new) for n, new in requests]
    big_session = None
    if big is not None:
        bsz, big_len, big_prompt, big_new = big
        big_session = compile(cfg, (bsz, big_len), params=session._params,
                              device=device)
        work.append((big_session, (bsz, big_prompt), big_new))
    prompts = [rng.integers(0, cfg.vocab, size=shape) for _, shape, _ in work]

    outs, per_request, t_gen, traced = [], [], [], []
    fns = _kernel_fns()
    with moe_recording() as calls:
        reset_counts()
        for (sess, shape, new), toks in zip(work, prompts):
            before = {k: fns[k].launches for k in kernels}
            first = len(calls)
            t1 = time.perf_counter()
            outs.append(sess.generate(toks, new))
            t_gen.append((time.perf_counter() - t1) * 1e3)
            per_request.append({k: fns[k].launches - before[k]
                                for k in kernels})
            traced.append(calls[first:])
        counts = read_counts()
        routes = b3_routes()
        mm_routes = b2_routes()

    n_prefills = sum(1 for (sess, shape, _) in work
                     if sess.bucket_for(shape[1]) is not None)
    want = []
    for sess, shape, new in work:
        bucket = sess.bucket_for(shape[1])
        steps = shape[1] - (bucket or 0) + new - 1
        want.append({k: (bool(bucket) * pp + steps * pd) if on_card else 0
                     for k, (pp, pd) in kernels.items()})
    if per_request != want:
        raise RuntimeError(f"{model}: launches per request {per_request}, "
                           f"expected {want}")
    others = {k: v for k, v in counts.items() if k not in kernels and v}
    if others:
        raise RuntimeError(f"{model}: unexpected kernel launches {others}")
    # bf16 attention takes B3's tensor-core route, every launch
    if routes != {"sm90": counts["flash_attention"], "fma": 0}:
        raise RuntimeError(f"{model}: B3 launches by route {routes}, "
                           f"expected all {counts['flash_attention']} on "
                           "sm90")
    # a bf16 MoE router takes B2's tensor-core route in every prefill and
    # its split-K route at every decode step
    if "matmul_blocked" in kernels:
        pp, pd = kernels["matmul_blocked"]
        want_mm = {"splitk": 0, "sm90": 0, "fma": 0}
        if on_card:
            for sess, shape, new in work:
                bucket = sess.bucket_for(shape[1])
                want_mm["sm90"] += bool(bucket) * pp
                want_mm["splitk"] += (shape[1] - (bucket or 0) + new - 1) * pd
        if mm_routes != want_mm:
            raise RuntimeError(f"{model}: B2 launches by route {mm_routes}, "
                               f"expected {want_mm}")
    for (sess, shape, new), y in zip(work, outs):
        if y.shape != (shape[0], new) or y.dtype != np.int32 \
                or y.min() < 0 or y.max() >= cfg.vocab:
            raise RuntimeError(f"{model}: bad tokens {y.shape} {y.dtype}")
    moe = []
    for (sess, shape, _), calls in zip(work, traced):
        # a request's first n_layers router calls are its prefill's
        bucket = sess.bucket_for(shape[1])
        pre = calls[:cfg.n_layers] if bucket else []
        if pre:
            moe.append({"bucket": bucket, "tokens": shape[0] * bucket,
                        "capacity": pre[0]["capacity"],
                        "dropped_frac": [float(c["dropped_frac"])
                                         for c in pre]})
        dropped = [float(c["dropped_frac"]) for c in calls[len(pre):]]
        if any(dropped):
            raise RuntimeError(f"{model}: a decode step dropped tokens "
                               f"({max(dropped)})")
    # the last logits of a bucket prefill are finite and of vocab width
    # (after the counts were read)
    _, logits = prefill(session._params, cfg,
                        torch.from_numpy(prompts[0]).to(device),
                        max_len=max_len)
    if logits.shape != (1, cfg.vocab) or not torch.isfinite(logits).all():
        raise RuntimeError(f"{model}: bad prefill logits {logits.shape}")
    out = {"phase": "lm_main", "model": session.model_name,
           "n_layers": cfg.n_layers, "kernels": sorted(kernels),
           "requests": [[list(shape), new] for _, shape, new in work],
           "buckets": [sess.seq_buckets for sess in
                       dict.fromkeys(w[0] for w in work)],
           "prefills": n_prefills,
           "launches": sum(counts[k] for k in kernels),
           "launches_by_kernel": {k: counts[k] for k in kernels},
           "b3_launches_by_route": routes,
           "b2_launches_by_route": mm_routes,
           "launches_per_request": per_request, "compile_s": compile_s,
           "generate_ms": t_gen}
    if moe:
        out["moe_prefills"] = moe
    if cfg.family == "hybrid":
        # each bucket's ring: a prefill at least a window long rolls it
        w = min(cfg.local_window, max_len)
        out.update(window=w, ring_rolls={str(b): b % w for b in
                                         session.seq_buckets if b >= w})
    emit(out)
    return {"session": session, "big_session": big_session, **out}


# ---------------------------------------------------------------------------
# 6. lm_parity: card vs CPU at full width
# ---------------------------------------------------------------------------

def _recording(logits_seen: list, feed=None):
    """A ``pick`` hook for ``LMSession.generate`` that keeps each step's
    logits (on the host, fp32) and returns the argmax, or with ``feed``
    (tokens from another run) that step's fed tokens."""
    def pick(step, logits):
        logits_seen.append(logits.float().cpu().numpy())
        if feed is None:
            return logits.argmax(dim=-1)
        return torch.from_numpy(feed[:, step])
    return pick


def routing_near_ties(trace: list, n_layers: int, top_k: int,
                      tol=PROB_TOL) -> list:
    """Positions at which some layer's router puts its k-th and (k+1)-th
    probabilities within the kernel tolerance of each other, from the
    ``moe_recording`` of one batch-1 generate: its first forward covers
    positions 0..T-1, each later one the next position.  There the card
    may pick the other expert, which is a different output and not a
    kernel fault."""
    ties, pos0 = set(), 0
    for f in range(0, len(trace), n_layers):
        calls = trace[f:f + n_layers]
        for c in calls:
            p = torch.sort(c["probs"].float().cpu(), dim=-1,
                           descending=True).values
            pk, pk1 = p[:, top_k - 1], p[:, top_k]
            close = pk - pk1 <= tol["atol"] + tol["rtol"] * pk
            ties.update(pos0 + int(i) for i in torch.nonzero(close).flatten())
        pos0 += calls[0]["probs"].shape[0]
    return sorted(ties)


def phase_lm_parity(device, model, n_layers: int = 2, max_len: int = 1024,
                    prompt: int = 600, new: int = 8, seed: int = 0,
                    ref_device="cpu", tol: float = LM_LOGIT_TOL,
                    **overrides) -> dict:
    """``model`` at full width, ``n_layers`` layers, fp32 (and any other
    field of its config in ``overrides``): a session on ``device`` and one
    on ``ref_device`` over the same weights (drawn on the CPU, then moved)
    run a prompt that takes a bucket and a catch-up.  Each step's logits
    are read through ``generate``'s ``pick`` hook.  Teacher-forced with the
    reference's tokens, every step's logits must agree to ``tol`` of the
    largest logit; ``generate``'s greedy tokens must be equal at every step
    whose top-2 margin on the reference exceeds that tolerance, up to the
    first near-tie that changes a token.  A vlm or encdec model runs the
    whole prompt through the model's ``prefill`` with its stub frontend's
    inputs (``frontend_inputs``) and decodes with ``decode_step``
    (``model_generate``), on both sides.  For a MoE model the routing
    margin rule also holds: steps at or after the first position whose
    router has a near-tie on the reference side (``routing_near_ties``)
    are reported and left out of both comparisons.  Because that tie may
    lie inside the prompt, a MoE model's logits are also compared over the
    whole teacher-forced sequence (``forward`` on both sides, with its own
    routing trace) at every position before its first near-tie; a tie at
    position 0 leaves nothing to compare and fails the phase."""
    from repro_torch.configs import ARCHS
    from repro_torch.engine import compile_lm
    from repro_torch.models.lm.model import forward, init_params, params_to

    base = ARCHS[model] if isinstance(model, str) else model
    cfg = dataclasses.replace(base, n_layers=n_layers, dtype="float32",
                              **overrides)
    params = init_params(cfg, seed=seed, device="cpu")
    ref_p, dut_p = params_to(params, ref_device), params_to(params, device)
    ref = compile_lm(cfg, max_len=max_len, params=ref_p)
    dut = compile_lm(cfg, max_len=max_len, params=dut_p)
    toks = np.random.default_rng(seed + 2).integers(0, cfg.vocab,
                                                    size=(1, prompt))
    extra = frontend_inputs(cfg, 1, seed + 3)

    def gen(sess, pick=None):
        if not extra:
            return sess.generate(toks, new, pick=pick)
        return model_generate(sess._params, cfg, toks, new, max_len, extra,
                              pick=pick)[0]

    want_logits, got_logits = [], []
    routes0, mm_routes0 = b3_routes(), b2_routes()
    with moe_recording() as calls:
        want_tokens = gen(ref, pick=_recording(want_logits))
    moe = cfg.family == "moe"
    ties = routing_near_ties(calls, cfg.n_layers, cfg.top_k) if moe else []
    # step i's logits are those of position prompt - 1 + i
    steps = [i for i in range(new) if not ties or prompt - 1 + i < ties[0]]
    gen(dut, pick=_recording(got_logits, feed=want_tokens))
    pairs = [(want_logits[i], got_logits[i]) for i in steps]
    if moe:
        seq = np.concatenate([toks, want_tokens[:, :-1]], axis=1)
        with moe_recording() as f_calls:
            want_f = forward(ref_p, cfg, torch.from_numpy(seq).to(ref_device))
        got_f = forward(dut_p, cfg, torch.from_numpy(seq).to(device))
        f_ties = routing_near_ties(f_calls, cfg.n_layers, cfg.top_k)
        cut = f_ties[0] if f_ties else seq.shape[1]
        if cut == 0:
            raise RuntimeError(f"{model}: a routing near-tie at position 0 "
                               "leaves no logits to compare")
        pairs.append((want_f[:, :cut].float().cpu().numpy(),
                      got_f[:, :cut].float().cpu().numpy()))
    errs = []
    for want, got in pairs:
        if not np.isfinite(got).all():
            raise RuntimeError(f"{model}: non-finite logits")
        scale = float(np.abs(want).max())
        errs.append(float(np.abs(got - want).max()) / scale)
    if errs and max(errs) > tol:
        raise RuntimeError(f"{model}: logits differ by {max(errs):.3g} of "
                           f"the largest logit (tolerance {tol})")
    got_tokens = gen(dut)
    # fp32 attention on the card takes B3's FMA route, and only it
    routes = {r: n - routes0[r] for r, n in b3_routes().items()}
    on_card = torch.device(device).type == "cuda"
    if on_card and "flash_attention" in lm_kernels_of(cfg) \
            and (routes["sm90"] or not routes["fma"]):
        raise RuntimeError(f"{model}: fp32 B3 launches by route {routes}, "
                           "expected all on fma")
    # an fp32 router never takes B2's tensor-core route: its prefills take
    # fma, its decode steps splitk
    mm_routes = {r: n - mm_routes0[r] for r, n in b2_routes().items()}
    if on_card and "matmul_blocked" in lm_kernels_of(cfg) \
            and (mm_routes["sm90"] or not mm_routes["fma"]
                 or not mm_routes["splitk"]):
        raise RuntimeError(f"{model}: fp32 B2 launches by route "
                           f"{mm_routes}, expected fma and splitk only")
    compared = 0
    for i in steps:
        want = want_logits[i]
        top2 = np.sort(want[0])[-2:]
        margin = float(top2[1] - top2[0]) / float(np.abs(want).max())
        same = got_tokens[0, i] == want_tokens[0, i]
        if margin > tol:
            if not same:
                raise RuntimeError(f"{model}: greedy token {i} differs with "
                                   f"a top-2 margin of {margin:.3g}")
            compared += 1
        elif not same:
            break
    out = {"phase": "lm_parity", "model": base.name, "n_layers": n_layers,
           "overrides": overrides, "dtype": "float32", "prompt": prompt,
           "bucket": prompt if extra else ref.bucket_for(prompt),
           "new_tokens": new,
           "max_logit_err_rel": max(errs, default=None),
           "logit_tol_rel": tol, "steps_compared": len(steps),
           "tokens_compared": compared, "b3_launches_by_route": routes,
           "b2_launches_by_route": mm_routes}
    if moe:
        out.update(routing_near_ties=len(ties),
                   routing_near_tie_positions=ties[:16],
                   routing_tol=PROB_TOL, forward_positions_compared=cut,
                   forward_near_ties=len(f_ties))
    emit(out)
    return out


# ---------------------------------------------------------------------------
# 12. a8: the stub-frontend families through the model's entry points
# (phase_a8 runs them with the hybrid one, after arctic-480b)
# ---------------------------------------------------------------------------

def frontend_inputs(cfg, batch: int, seed: int) -> dict:
    """A stub frontend's inputs, N(0, 1) fp32 on the host from ``seed``: a
    vlm's image embeddings (B, n_img_tokens, d) or an encdec's frame
    embeddings (B, enc_positions, d); none for the other families."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        shape, key = (batch, cfg.n_img_tokens, cfg.d_model), "img_embeds"
    elif cfg.family == "encdec":
        shape, key = (batch, cfg.enc_positions, cfg.d_model), "frames"
    else:
        return {}
    return {key: torch.from_numpy(rng.standard_normal(shape,
                                                      dtype=np.float32))}


def model_generate(params, cfg, toks, new: int, max_len: int, extra: dict,
                   pick=None):
    """Greedy decode through the model's own entry points: ``prefill`` of
    the whole prompt with ``extra`` (``frontend_inputs``), then
    ``decode_step`` from the position after the prefill (a vlm's image
    tokens come first).  ``pick`` as in ``LMSession.generate``.  Returns
    the (B, new) int32 tokens and, for the prefill and each decode step,
    the launches of each kernel it made."""
    from repro_torch.models.lm.model import decode_step, prefill

    fns = _kernel_fns()
    dev = params["embed"].device
    t = torch.as_tensor(toks).to(dev)
    pos = t.shape[1] + (extra["img_embeds"].shape[1]
                        if "img_embeds" in extra else 0)
    before = read_counts()
    cache, logits = prefill(params, cfg, t, max_len=max_len,
                            **{k: v.to(dev) for k, v in extra.items()})
    calls = [{k: f.launches - before[k] for k, f in fns.items()}]
    out = []
    for i in range(new):
        nxt = logits.argmax(dim=-1) if pick is None \
            else pick(i, logits).to(dev)
        out.append(nxt.cpu().numpy().astype(np.int32))
        if i + 1 < new:
            before = read_counts()
            logits, cache = decode_step(params, cfg, nxt[:, None], cache,
                                        pos + i)
            calls.append({k: f.launches - before[k]
                          for k, f in fns.items()})
    return np.stack(out, axis=1), calls


def phase_lm_frontend(device, model, max_len: int, prompt: int, new: int,
                      batches=(1,), seed: int = 0) -> dict:
    """A vlm or encdec model at full width (random bf16 weights from
    ``seed``), driven as its users drive it: for each batch size, its stub
    frontend's inputs and a random prompt through ``model_generate``.
    Every count is set to 0 just before and read just after; on the card
    B3 must launch its count (``lm_kernels_of``) in every prefill and
    every decode step, all on sm90, and no other kernel."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.lm.model import init_params, prefill

    cfg = ARCHS[model] if isinstance(model, str) else model
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=device)
    init_s = time.perf_counter() - t0
    pp, pd = lm_kernels_of(cfg)["flash_attention"]
    runs = []
    reset_counts()
    for b in batches:
        extra = frontend_inputs(cfg, b, seed + 10 * b)
        toks = np.random.default_rng(seed + 10 * b + 1).integers(
            0, cfg.vocab, size=(b, prompt))
        t1 = time.perf_counter()
        y, calls = model_generate(params, cfg, toks, new, max_len, extra)
        ms = (time.perf_counter() - t1) * 1e3
        got = [c["flash_attention"] for c in calls]
        want = [pp * on_card] + [pd * on_card] * (new - 1)
        if got != want:
            raise RuntimeError(f"{cfg.name}: B3 launches per call {got}, "
                               f"expected {want}")
        if y.shape != (b, new) or y.min() < 0 or y.max() >= cfg.vocab:
            raise RuntimeError(f"{cfg.name}: bad tokens {y.shape}")
        runs.append({"batch": b, "prompt": prompt,
                     "prefill_tokens": prompt + (cfg.n_img_tokens
                                                 if cfg.family == "vlm"
                                                 else 0),
                     "new": new, "generate_ms": ms,
                     "b3_per_prefill": got[0],
                     "b3_per_decode_step": sorted(set(got[1:]))})
    counts, routes = read_counts(), b3_routes()
    others = {k: v for k, v in counts.items()
              if k != "flash_attention" and v}
    if others:
        raise RuntimeError(f"{cfg.name}: unexpected kernel launches {others}")
    if routes != {"sm90": counts["flash_attention"], "fma": 0}:
        raise RuntimeError(f"{cfg.name}: B3 launches by route {routes}")
    # the last logits of a prefill are finite and of vocab width (after
    # the counts were read)
    extra = frontend_inputs(cfg, 1, seed)
    _, logits = prefill(params, cfg, torch.from_numpy(toks[:1]).to(device),
                        max_len=max_len,
                        **{k: v.to(device) for k, v in extra.items()})
    if logits.shape != (1, cfg.vocab) or not torch.isfinite(logits).all():
        raise RuntimeError(f"{cfg.name}: bad prefill logits {logits.shape}")
    out = {"phase": "lm_frontend", "model": cfg.name, "family": cfg.family,
           "n_layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
           "max_len": max_len, "init_s": init_s, "runs": runs,
           "launches": counts["flash_attention"],
           "b3_launches_by_route": routes}
    emit(out)
    return {"params": params, "cfg": cfg, **out}


def phase_lm_frontend_e2e(run: dict, device, decode_steps: int = 32) -> dict:
    """``phase_lm_e2e`` for a ``phase_lm_frontend`` run, on the host clock
    around work that ends in a synchronize: at each batch size a prefill
    of the prompt and the frontend's inputs (median of 5) and a decode
    step (median of ``decode_steps``, from the position after it); the
    card's time per batch-1 prefill and the idle share of a batch-1
    decode step from profiler traces; the weights plus what the largest
    batch's generate allocates on top."""
    from repro_torch.models.lm.model import decode_step, prefill

    params, cfg = run["params"], run["cfg"]
    out = {"phase": "lm_e2e", "model": cfg.name}
    rng = np.random.default_rng(9)
    for r in run["runs"]:
        b = r["batch"]
        extra = {k: v.to(device) for k, v in
                 frontend_inputs(cfg, b, 9).items()}
        toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                             size=(b, r["prompt"]))).to(device)

        def pre():
            return prefill(params, cfg, toks, max_len=run["max_len"],
                           **extra)

        out[f"prefill_ms_batch{b}"] = statistics.median(_host_ms(pre, 5))
        cache, _ = pre()
        tok = toks[:, -1:]
        pos = iter(range(r["prefill_tokens"], run["max_len"]))

        def step():
            return decode_step(params, cfg, tok, cache, next(pos))

        ms = statistics.median(_host_ms(step, decode_steps))
        out[f"decode_ms_batch{b}"] = ms
        out[f"decode_tokens_per_s_batch{b}"] = b * 1e3 / ms
        if b == 1:
            out["prefill_profile"] = {"tokens": r["prefill_tokens"],
                                      **_device_busy(pre, 3)}
            prof = _device_busy(step, 16)
            if prof["device_ms"] != "not measured":
                prof["idle_share_unprofiled"] = 1 - prof["device_ms"] / ms
            out["decode_profile"] = prof
    big = run["runs"][-1]
    toks = np.random.default_rng(3).integers(0, cfg.vocab,
                                             size=(big["batch"], big["prompt"]))
    extra = frontend_inputs(cfg, big["batch"], 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    model_generate(params, cfg, toks, big["new"], run["max_len"], extra)
    torch.cuda.synchronize()
    extra_bytes = torch.cuda.max_memory_allocated(device) - base
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    out.update(weights_bytes=weights, generate_extra_bytes=extra_bytes,
               peak_memory_bytes=weights + extra_bytes,
               peak_memory_request=[big["batch"], big["prefill_tokens"],
                                    big["new"]])
    emit(out)
    return out


# ---------------------------------------------------------------------------
# 8. lm_times
# ---------------------------------------------------------------------------

def attn_pairs(s, sk, causal=True, window=0) -> int:
    """The (query, key) pairs that the masks keep: key j < Sk for query i
    < S, j <= i if causal, i - j < window if windowed."""
    q = np.arange(s)
    hi = np.minimum(q, sk - 1) if causal else np.full(s, sk - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(s, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def attn_bound(b, hq, hkv, s, d, dtype, causal=True, window=0,
               sk=None) -> dict:
    """Least time of one B3 launch: the two products over the pairs the
    masks keep (``attn_pairs``; S(S+1)/2 under the causal mask alone),
    4 * B * Hq * D FLOP a pair, over the peak of the input type, or q, k,
    v and o read or written once over the memory rate."""
    sk = sk or s
    flop = 4 * b * hq * d * attn_pairs(s, sk, causal, window)
    elt = 2 if dtype == torch.bfloat16 else 4
    nbytes = elt * (2 * b * hq * s * d + 2 * b * hkv * sk * d)
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    t_op, t_mem = flop / peak * 1e3, nbytes / MEM_BW * 1e3
    return {"flop": flop, "bytes": nbytes, "bound_ms": max(t_op, t_mem),
            "bound_by": "operations" if t_op >= t_mem else "bytes"}


def ssd_bound(bcn, h, q, n, p) -> dict:
    """Least time of one B4 launch, two ways.  The work: per chunk the C.B
    scores of the pairs j <= i (shared by the heads, 2N FLOP each), per
    head and pair the product with x (2P FLOP) and the decay (one exp, one
    multiply); the bytes: the fp32 inputs read and the output written
    once.  ``bound_ms`` on the tensor cores: the larger of the two
    products' 3xTF32 work (three TF32 products for each fp32 one) over the
    dense TF32 peak and the bytes over the memory rate; ``fma_bound_ms``
    the same with all the FLOP over the FMA units' peak."""
    pairs = q * (q + 1) // 2
    mma = bcn * pairs * 2 * n + bcn * h * pairs * 2 * p
    flop = mma + bcn * h * pairs * 2
    nbytes = 4 * (2 * bcn * q * n + bcn * h * q + 2 * bcn * h * q * p)
    t_op = TF32_PRODUCTS * mma / PEAK_TF32 * 1e3
    t_fma, t_mem = flop / PEAK_FP32 * 1e3, nbytes / MEM_BW * 1e3
    return {"flop": flop, "bytes": nbytes, "bound_ms": max(t_op, t_mem),
            "bound_by": "operations" if t_op >= t_mem else "bytes",
            "fma_bound_ms": max(t_fma, t_mem)}


def mm_bound(m, k, n, dtype) -> dict:
    """Least time of one B2 launch: 2MKN FLOP over the peak of the
    operands' type, or a and b read and the fp32 output written once over
    the memory rate (the tail adds O(MN) work)."""
    flop = 2 * m * k * n
    elt = 2 if dtype == torch.bfloat16 else 4
    nbytes = elt * (m * k + k * n) + 4 * m * n
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    t_op, t_mem = flop / peak * 1e3, nbytes / MEM_BW * 1e3
    return {"flop": flop, "bytes": nbytes, "bound_ms": max(t_op, t_mem),
            "bound_by": "operations" if t_op >= t_mem else "bytes"}


B2_TIMED = (  # (M, N, tail, operand dtype): the main path's bf16 rows
    [(m, ROUTER_N, "softmax", torch.bfloat16) for m in ROUTER_M]
    # the fp32 rows: the parity copies' router, and the operands the
    # router cast to before it passed bf16 as it is
    + [(m, ROUTER_N, "softmax", torch.float32) for m in ROUTER_M]
    # the splitk / sm90 boundary, kimi-k2's router, the identity tail
    + [(m, ROUTER_N, "softmax", torch.bfloat16) for m in (16, 63, 64)]
    + [(m, KIMI_N, "softmax", torch.bfloat16) for m in (2048, 1)]
    + [(2048, ROUTER_N, "identity", dt)
       for dt in (torch.bfloat16, torch.float32)])


def b2_times(device, iters: int = 20) -> list:
    """B2 per launch at the router shapes of ``B2_TIMED`` (K = 7,168):
    the kernel on its route, its plain version, the bound, and two library
    calls with TF32 off: one on fp32 copies of the operands,
    ``torch.softmax(torch.matmul(a, b), -1)`` (``torch.matmul``
    for the identity tail), and for bf16 operands the one on the operands
    as they are, ``torch.softmax(torch.mm(a, b, out_dtype=torch.float32),
    -1)``.  Each is timed with CUDA events over back-to-back calls (at
    decode shapes that is the host's enqueue) and by the card's own time
    per call from a profiler trace (``device_ms``).  b (1.8 or 3.7 MB)
    stays in L2 across the back-to-back launches."""
    from repro_torch.core.epilogue import IDENTITY, EpilogueSpec
    from repro_torch.kernels.matmul_blocked import _route, matmul_blocked

    rows = []
    for m, n, tail, dt in B2_TIMED:
        spec = EpilogueSpec(softmax=True) if tail == "softmax" else IDENTITY
        a, b = mm_inputs(m, ROUTER_K, n, dt, device, spec.softmax)
        a32, b32 = a.float(), b.float()

        def kernel():
            return matmul_blocked(a, b, epilogue=spec,
                                  out_dtype=torch.float32)

        def lib_fp32():
            y = torch.matmul(a32, b32)
            return torch.softmax(y, -1) if spec.softmax else y

        def lib_bf16():
            y = torch.mm(a, b, out_dtype=torch.float32)
            return torch.softmax(y, -1) if spec.softmax else y

        row = {"phase": "lm_times", "kernel": "matmul_blocked",
               "shape": [m, ROUTER_K, n], "dtype": str(dt)[6:],
               "tail": tail, "route": _route(m, ROUTER_K, n, dt),
               "ms": cuda_ms(kernel, iters),
               "device_ms": _device_busy(kernel, iters)["device_ms"],
               "plain_ms": cuda_ms(lambda: mm_plain(a, b, spec), iters),
               "library": "torch.softmax(torch.matmul(a.float(), "
                          "b.float()), -1)" if spec.softmax
                          else "torch.matmul(a.float(), b.float())",
               "library_ms": cuda_ms(lib_fp32, iters),
               "library_device_ms": _device_busy(lib_fp32,
                                                 iters)["device_ms"],
               **mm_bound(m, ROUTER_K, n, dt)}
        if dt == torch.bfloat16:
            row["library_bf16"] = (
                "torch.softmax(torch.mm(a, b, out_dtype=torch.float32), -1)"
                if spec.softmax else
                "torch.mm(a, b, out_dtype=torch.float32)")
            try:
                row.update(library_bf16_ms=cuda_ms(lib_bf16, iters),
                           library_bf16_device_ms=_device_busy(
                               lib_bf16, iters)["device_ms"])
            except (RuntimeError, TypeError) as e:   # an older torch
                row.update(library_bf16_ms=None, library_bf16_device_ms=None,
                           library_bf16_error=str(e)[:200])
        emit(row)
        rows.append(row)
    return rows


# (Hq, Hkv, S, D): B3's causal bf16 prefill shapes at batch 1 on the
# earlier slices' LM paths, where S = Sk: qwen2-1.5b's three buckets,
# arctic-480b's largest one and kimi-k2's (head dim 112)
B3_EARLIER = tuple((12, 2, s, 128) for s in (512, 1024, 2048)) \
    + ((56, 8, 2048, 128), (64, 8, 2048, 112))
# (model, B, Hq, Hkv, S, D, causal, window, Sk): B3's shapes on the A8
# families' main paths (the largest prefill of each, whisper's decode-step
# cross-attention at batch 1 and 4 and its prompt's)
A8_ATTN = (("recurrentgemma-2b", 1, 10, 1, 4608, 256, True, 2048, 4608),
           ("llava-next-mistral-7b", 1, 32, 8, 3392, 128, True, 0, 3392),
           ("whisper-tiny", 1, 6, 6, 1500, 64, False, 0, 1500),
           ("whisper-tiny", 1, 6, 6, 4, 64, False, 0, 1500),
           ("whisper-tiny", 1, 6, 6, 1, 64, False, 0, 1500),
           ("whisper-tiny", 4, 6, 6, 1, 64, False, 0, 1500))


def b3_row(device, b, hq, hkv, s, d, causal=True, window=0, sk=None,
           iters: int = 10, model=None) -> dict:
    """B3 at one bf16 shape: the kernel, its plain version and SDPA (a
    boolean band mask where there is a window) with CUDA events, the
    kernel and SDPA also by the card's time per call from a profiler
    trace (at short shapes the events time the host's enqueue of
    back-to-back calls), and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    sk = sk or s
    q, k, v = attn_inputs(b, hq, hkv, s, d, torch.bfloat16, device, sk=sk)
    mask = None
    if window:
        i = torch.arange(s, device=device)[:, None]
        j = torch.arange(sk, device=device)[None]
        mask = (i - j < window) & (j <= i if causal else True)

    def kernel():
        return flash_attention(q, k, v, causal=causal, window=window)

    def sdpa():
        if mask is not None:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    row = {"phase": "lm_times", "kernel": "flash_attention",
           "shape": [b, hq, hkv, s, d], "sk": sk, "causal": causal,
           "window": window, "dtype": "bfloat16",
           "ms": cuda_ms(kernel, iters),
           "plain_ms": cuda_ms(lambda: flash_attention_plain(
               q, k, v, causal=causal, window=window), iters),
           "library_ms": cuda_ms(sdpa, iters),
           "device_ms": _device_busy(kernel, iters)["device_ms"],
           "library_device_ms": _device_busy(sdpa, iters)["device_ms"],
           **attn_bound(b, hq, hkv, s, d, torch.bfloat16, causal, window,
                        sk)}
    if model:
        row["model"] = model
    emit(row)
    return row


def phase_lm_kernel_times(device, iters: int = 10) -> dict:
    """B3 at qwen2-1.5b's prefill shapes (bf16, B = 1, the three buckets),
    arctic-480b's largest one, kimi-k2's (head dim 112) and the A8
    families' (``A8_ATTN``), B4 at
    mamba2-130m's (BC = 2, 4, 8) and B2 at arctic-480b's router shapes:
    kernel, plain version, library call (B3: SDPA; B2: torch's matmul and
    softmax) and bound, each ms with CUDA events; B3's and B4's rows also
    carry the card's time per call for the kernel (and SDPA, or B4's plain
    version) from a profiler trace."""
    from repro_torch.kernels.ssd_chunk import ssd_intra, ssd_intra_plain

    rows = {"matmul_blocked": b2_times(device), "flash_attention": [],
            "ssd_intra": []}
    for hq, hkv, s, d in B3_EARLIER:
        rows["flash_attention"].append(b3_row(device, 1, hq, hkv, s, d,
                                              iters=iters))
    for model, b, hq, hkv, s, d, causal, window, sk in A8_ATTN:
        rows["flash_attention"].append(b3_row(
            device, b, hq, hkv, s, d, causal, window, sk, iters, model=model))
    for name, bcn, h, q_, n, p, decay in ssd_cases()[:3]:
        args = ssd_inputs(bcn, h, q_, n, p, device, decay)
        row = {"phase": "lm_times", "kernel": "ssd_intra",
               "shape": [bcn, h, q_, n, p], "dtype": "float32",
               "ms": cuda_ms(lambda: ssd_intra(*args), iters),
               "device_ms": _device_busy(lambda: ssd_intra(*args),
                                         iters)["device_ms"],
               "plain_ms": cuda_ms(lambda: ssd_intra_plain(*args), iters),
               "plain_device_ms": _device_busy(
                   lambda: ssd_intra_plain(*args), iters)["device_ms"],
               "library_ms": None, **ssd_bound(bcn, h, q_, n, p)}
        emit(row)
        rows["ssd_intra"].append(row)
    return rows


# Every trace opens with TRACE_PAD_S of idle host time, then TRACE_LEAD
# empty kernels that its sums leave out, and closes with TRACE_PAD_S more:
# the card's times reach a trace mapped onto the host's clock, off by up to
# 2.1 ms from trace to trace, and the profiler keeps only what falls inside
# its window; and late in a long run a trace missed the kernels of its
# first 9 to 14 launches whatever the idle time (PERF.md §6)
TRACE_PAD_S = 0.05
TRACE_LEAD = 64


def _launch_gaps(prof) -> dict:
    """What a trace says of its own launches: the kernel launches on the
    host, where those with no kernel in the trace stand in launch order
    (the first 20), how many of them come after the ``TRACE_LEAD`` first
    (``missed``), the correlation ids of those first (``lead_ids``), and
    the range of (kernel start - launch start) in ms over the launches
    that have a kernel."""
    from torch.autograd import DeviceType

    events = prof.events()
    kernels = {e.id: e for e in events if e.device_type == DeviceType.CUDA}
    launches = sorted((e for e in events if e.device_type == DeviceType.CPU
                       and "LaunchKernel" in e.name),
                      key=lambda e: e.time_range.start)
    missing = [i for i, e in enumerate(launches) if e.id not in kernels]
    offs = [kernels[e.id].time_range.start - e.time_range.start
            for e in launches if e.id in kernels]
    return {"launches": len(launches), "missing_at": missing[:20],
            "missed": sum(1 for i in missing if i >= TRACE_LEAD),
            "lead_ids": {e.id for e in launches[:TRACE_LEAD]},
            "kernel_minus_launch_ms": [min(offs) / 1e3, max(offs) / 1e3]
            if offs else None}


def _profiled(fn, iters: int, b1: int | None = None,
              labels: dict | None = None):
    """``iters`` calls of ``fn`` (after one outside the trace) under
    ``torch.profiler`` (and ``node_ranges(labels)`` unless ``labels`` is
    None), between the idle spans and after the lead kernels above.  Every launch after the
    lead must have its kernel in the trace, and with ``b1`` the trace
    must hold that many B1 launches; it is taken up to three times, then
    this raises.  Returns the profiler, the wall ms per call, the B1
    launches the trace holds and ``_launch_gaps`` with the number of takes
    (its ``lead_ids`` the sums leave out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for take in range(1, 4):
        with (contextlib.nullcontext() if labels is None
              else node_ranges(labels)), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            for _ in range(TRACE_LEAD):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
            time.sleep(TRACE_PAD_S)
        gaps = {**_launch_gaps(prof), "takes": take}
        held = sum(1 for e in prof.events() if e.device_type ==
                   DeviceType.CUDA and B1_KERNEL in e.name)
        if not gaps["missed"] and (b1 is None or held == b1):
            return prof, wall_ms, held, gaps
    gaps.pop("lead_ids")
    raise RuntimeError(f"a trace of {iters} calls held {held} of {b1} B1 "
                       f"launches, three times: {gaps}")


def _device_busy(fn, iters: int, b1: int | None = None) -> dict:
    """Wall ms per call and device ms per call (sum of the card's kernel
    times) over ``iters`` calls under ``torch.profiler`` (``_profiled``;
    ``b1``: the B1 launches the trace must hold), and the top kernels by
    device time."""
    from torch.autograd import DeviceType

    prof, wall_ms, _, gaps = _profiled(fn, iters, b1)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.id not in gaps["lead_ids"]:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / iters)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms,
            "device_ms": busy if by_name else "not measured",
            "idle_share": 1 - busy / wall_ms if by_name else "not measured",
            "top_ms": [[name[:80], ms] for name, ms in top]}


def _host_ms(fn, iters: int) -> list:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def prefill_profile(sess, device, iters: int = 3) -> dict:
    """The card's time per prefill of the session's largest bucket, from
    a ``torch.profiler`` trace, with the kernels that take it."""
    from repro_torch.models.lm.model import prefill

    b = max(sess.seq_buckets)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, sess.cfg.vocab, size=(1, b))).to(device)
    prof = _device_busy(lambda: prefill(sess._params, sess.cfg, toks,
                                        max_len=sess.max_len), iters)
    return {"tokens": b, **prof}


def phase_lm_e2e(main_run: dict, device, decode_steps: int = 32) -> dict:
    """One model's end-to-end numbers on the host clock around work that
    ends in a synchronize: prefill ms per bucket, decode ms per token at
    batch 1 and at the batch-4 session (where ``phase_lm_main`` made one),
    tokens/s, peak device memory of a generate whose prompt fills the
    largest bucket (and up to 16 new tokens, as many as fit: 1 where that
    bucket is ``max_len``) followed by 16 decode steps at the cache's last
    positions over that prefill's cache, and the idle share over a decode
    loop of the batch-1 session; and the card's time per full-bucket
    prefill from a profiler trace."""
    from repro_torch.models.lm.model import decode_step, init_cache, prefill

    out = {"phase": "lm_e2e", "model": main_run["model"]}
    sess, big = main_run["session"], main_run["big_session"]
    cfg = sess.cfg
    rng = np.random.default_rng(9)
    prefill_ms = {}
    for b in sess.seq_buckets:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, b))
                                ).to(device)
        t = _host_ms(lambda: prefill(sess._params, cfg, toks,
                                     max_len=sess.max_len), 5)
        prefill_ms[str(b)] = statistics.median(t)
    out["prefill_ms"] = prefill_ms
    out["prefill_profile"] = prefill_profile(sess, device)
    for label, s in (("batch1", sess), ("batch4", big)):
        if s is None:
            continue
        cache = init_cache(cfg, s.batch, s.max_len, device)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(s.batch, 1))
                               ).to(device)
        pos = iter(range(s.max_len // 2, s.max_len))
        t = _host_ms(lambda: decode_step(s._params, cfg, tok, cache,
                                         next(pos)), decode_steps)
        ms = statistics.median(t)
        out[f"decode_ms_{label}"] = ms
        out[f"decode_tokens_per_s_{label}"] = s.batch * 1e3 / ms
    # the model's own peak: its weights plus the most that one generate
    # (a full-bucket prefill, then decode) and decode steps at the cache's
    # last positions (which that generate does not reach when its bucket
    # is max_len; each step rewrites the slot the prefill filled) allocate
    # on top of what is already resident (other sessions' weights are not
    # counted)
    prompt = max(sess.seq_buckets)
    new = min(16, sess.max_len - prompt + 1)
    toks = rng.integers(0, cfg.vocab, size=(1, prompt))
    tail = list(range(max(0, sess.max_len - 16), sess.max_len))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    sess.generate(toks, new)
    cache, logits = prefill(sess._params, cfg,
                            torch.from_numpy(toks).to(device),
                            max_len=sess.max_len)
    for p in tail:
        tok = logits.argmax(-1, keepdim=True)
        logits, cache = decode_step(sess._params, cfg, tok, cache, p)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(device) - base
    if not torch.isfinite(logits).all():
        raise RuntimeError(f"{main_run['model']}: non-finite logits at "
                           f"position {tail[-1]}")
    del cache, logits
    weights = sum(t.numel() * t.element_size()
                  for t in _leaves(sess._params))
    out.update(weights_bytes=weights, generate_extra_bytes=extra,
               peak_memory_bytes=weights + extra,
               peak_memory_request=[prompt, new],
               peak_memory_tail_positions=[tail[0], tail[-1]])
    cache = init_cache(cfg, 1, sess.max_len, device)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, 1))).to(device)
    pos = iter(range(sess.max_len // 2, sess.max_len))
    prof = _device_busy(lambda: decode_step(sess._params, cfg, tok, cache,
                                            next(pos)), 16)
    # the profiler's host cost inflates its wall time; the idle share
    # against the unprofiled step time is the better estimate
    if prof["device_ms"] != "not measured":
        prof["idle_share_unprofiled"] = 1 - prof["device_ms"] / \
            out["decode_ms_batch1"]
    out["decode_profile"] = prof
    emit(out)
    return out


# ---------------------------------------------------------------------------
# 10. artifacts: save, then load cold in a fresh process
# ---------------------------------------------------------------------------

ARTIFACT_REQUESTS = 4        # batch-1 requests of each CNN artifact
RESPECIALIZE = 2             # a batch size the ResNet-50 artifact lacks
# (prompt length, new tokens): the full bucket, an exact bucket, a bucket
# plus 8 catch-up steps
ARTIFACT_PROMPTS = ((2048, 1), (1024, 8), (520, 8))
CHILD_TIMEOUT_S = 600


def leaf_digests(tree: dict) -> dict:
    """SHA-256 of each tensor leaf's bytes, by dotted path: two
    processes' weights compared bit for bit."""
    from repro_torch.checkpoint.store import _flatten

    return {path: hashlib.sha256(t.detach().cpu().contiguous().view(
                torch.uint8).numpy().tobytes()).hexdigest()
            for path, t in _flatten(tree)}


def session_digests(sess) -> dict:
    """``leaf_digests`` of a CNN session: every specialization's bound
    weights and, where it has them, its logical ones."""
    tree = {str(b): sess.specialize(b).params for b in sess.batch_sizes}
    if sess._params is not None:
        tree["source"] = sess._params
    return leaf_digests(tree)


def artifact_size(path: Path) -> dict:
    files = [f for f in path.rglob("*") if f.is_file()]
    return {"bytes": sum(f.stat().st_size for f in files),
            "files": len(files)}


def _outputs(y) -> list:
    return [t.cpu().numpy() for t in (y if isinstance(y, tuple) else (y,))]


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(a, b))


def run_child(art: Path, work: Path, device, job: dict) -> dict:
    """Load ``art`` in a fresh ``python3 chip_smoke.py --load-artifact``
    process on ``device`` and run
    ``job`` there (``load_artifact``); the inputs and outputs cross as .npy
    files in ``work``, the child's measurements as ``result.json``.
    ``start_s`` is the time from the spawn to a ready CUDA context (Python,
    torch, the context)."""
    (work / "job.json").write_text(json.dumps(job))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--load-artifact",
         str(art), str(work), str(device)],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the artifact's child process failed "
                           f"({proc.returncode}):\n{proc.stdout[-4000:]}"
                           f"{proc.stderr[-4000:]}")
    res = json.loads((work / "result.json").read_text())
    res["start_s"] = res.pop("t_ready") - t0
    res["child_s"] = wall
    return res


def load_artifact(argv: list) -> int:
    """The child of ``phase_artifacts``: ``--load-artifact ART WORK
    DEVICE`` loads ART cold on DEVICE, answers WORK/job.json's requests
    through the loaded session with every count set to 0 just before, and
    writes the outputs and ``result.json`` into WORK.  ``load_s`` holds
    the check that the job's kernels are built, and ``rebuild_s`` any
    build that check had to run.  A ``"serve"`` job answers its one
    request through an ``AsyncServer`` started on the loaded session
    (``serve_artifact``)."""
    art, work, device = Path(argv[0]), Path(argv[1]), torch.device(argv[2])
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.calibrate import probe_calls
    from repro_torch.core.local_search import search_calls
    from repro_torch.engine import InferenceSession, LMSession
    from repro_torch.kernels import build as kbuild

    job = json.loads((work / "job.json").read_text())
    on_card = device.type == "cuda"
    torch.zeros(1, device=device)          # the context, before the clock
    t_ready = time.time()
    t0 = time.perf_counter()
    rebuild_s = sum((kbuild.build(k)["seconds"] for k in job["kernels"]),
                    0.0) if on_card else 0.0
    lm = job["kind"] == "lm"
    sess = (LMSession if lm else InferenceSession).load(art, device=device)
    if on_card:
        torch.cuda.synchronize(device)
    load_s = time.perf_counter() - t0
    out = {"t_ready": t_ready, "load_s": load_s, "rebuild_s": rebuild_s,
           "searches_at_load": search_calls()}
    fns = _kernel_fns()
    reset_counts()
    if job["kind"] == "serve":
        out.update(serve_artifact(sess, work, job))
        (work / "result.json").write_text(json.dumps(out))
        return 0
    lowered0 = lowering_calls()
    per_request, lowered, first_s = [], [], None
    if lm:
        for i, (f, new) in enumerate(zip(job["prompts"], job["new"])):
            before = read_counts()
            t1 = time.perf_counter()
            toks = sess.generate(np.load(work / f), new)
            if i == 0:
                first_s = time.perf_counter() - t1
            after = read_counts()
            per_request.append({k: after[k] - before[k] for k in after})
            np.save(work / f"tok{i}.npy", toks)
        out.update(cfg=dataclasses.asdict(sess.cfg),
                   seq_buckets=sess.seq_buckets,
                   digests=leaf_digests(sess._params))
    else:
        xs = [np.load(work / f) for f in job["inputs"]]
        for i, x in enumerate(xs):
            before = read_counts()
            low = sum(lowering_calls().values())
            t1 = time.perf_counter()
            ys = _outputs(sess.predict(torch.from_numpy(x).to(device)))
            if i == 0:
                first_s = time.perf_counter() - t1
            after = read_counts()
            per_request.append({k: after[k] - before[k] for k in after})
            lowered.append(sum(lowering_calls().values()) - low)
            for j, y in enumerate(ys):
                np.save(work / f"y{i}_{j}.npy", y)
    counts = read_counts()
    out.update(first_s=first_s, searches=search_calls(),
               probes=probe_calls(), launches=counts, launches_per_request=per_request,
               b1_launches_by_route=dict(
                   fns["conv2d_nchwc"].launches_by_route),
               lowerings_per_request=lowered,
               lowering_calls={k: v - lowered0.get(k, 0) for k, v in
                               lowering_calls().items()
                               if v != lowered0.get(k, 0)})
    if not lm:
        # after the counts were read: each softmax's input as an output,
        # on the loaded plans and weights, then an unseen batch size
        # planned from the packed source
        for i, x in enumerate(xs):
            ys = _outputs(with_logits(sess.specialize(x.shape[0])).predict(
                torch.from_numpy(x).to(device)))
            for j, y in enumerate(ys):
                np.save(work / f"z{i}_{j}.npy", y)
        out.update(dtype=sess.dtype, use_kernel=sess.use_kernel,
                   frozen=sess.frozen, batch_sizes=sess.batch_sizes,
                   tuning=sess.tuning, transform_bw=sess.transform_bw,
                   digests=session_digests(sess))
        if job.get("respecialize"):
            x = np.load(work / job["respecialize"])
            before = search_calls()
            t1 = time.perf_counter()
            m = sess.specialize(x.shape[0])
            out["respecialize_s"] = time.perf_counter() - t1
            out["respecialize_searches"] = search_calls() - before
            for j, y in enumerate(_outputs(with_logits(m).predict(
                    torch.from_numpy(x).to(device)))):
                np.save(work / f"r_{j}.npy", y)
    (work / "result.json").write_text(json.dumps(out))
    return 0


def serve_artifact(sess, work: Path, job: dict) -> dict:
    """The serving child's job: an ``AsyncServer`` on the loaded session
    (``server_s`` to start it), its first response (``first_s``; the wall
    clock at its arrival, ``t_first``) and the launches of that
    request."""
    from repro_torch.core.local_search import search_calls
    from repro_torch.engine import AsyncServer, DynamicBatchPolicy

    b = job["bucket"]
    policy = DynamicBatchPolicy(max_batch=b, max_wait_ms=2.0, fixed_bucket=b)
    t0 = time.perf_counter()
    srv = AsyncServer(sess, policy)
    server_s = time.perf_counter() - t0
    x = np.load(work / job["inputs"][0])
    t0 = time.perf_counter()
    y = srv.predict(x, timeout=CHILD_TIMEOUT_S)
    first_s = time.perf_counter() - t0
    t_first = time.time()
    launches = read_counts()
    np.save(work / "y0_0.npy", y.cpu().numpy())
    srv.close()
    return {"server_s": server_s, "first_s": first_s, "t_first": t_first,
            "launches": launches, "searches": search_calls()}


def _expect_corrupt(bad: Path, device) -> str:
    """Loading ``bad`` must raise ``ArtifactCorruptError``; its message."""
    from repro_torch.engine import ArtifactCorruptError, InferenceSession

    try:
        InferenceSession.load(bad, device=device)
    except ArtifactCorruptError as e:
        return str(e)
    raise RuntimeError(f"an artifact with a flipped byte loaded: {bad}")


def _cnn_artifact(session, name: str, tmp: Path, xs: list, device,
                  compile_s: float, kernels: list, respecialize=None,
                  corrupt: bool = False, keep: Path | None = None) -> dict:
    """Save ``session``, load it in a child and hold the child to it: the
    outputs and logits of every request bit for bit, zero searches, the
    launches of a predict (B1 once per conv node, all sm90, on the kernel
    path; one lowering a conv node and no B1 on the lowerings), every
    weight leaf bit for bit; then, where asked, an unseen batch size
    planned from the packed source against the saving session's, and a
    copy with one flipped byte refused.  With ``keep`` the artifact is
    moved there after, for the serving phase's start-up child."""
    on_card = torch.device(device).type == "cuda"
    art, work = tmp / name, tmp / f"{name}-work"
    work.mkdir()
    t0 = time.perf_counter()
    session.save(art)
    save_s = time.perf_counter() - t0
    size = artifact_size(art)
    job = {"kind": "cnn", "kernels": kernels, "inputs": []}
    for i, x in enumerate(xs):
        job["inputs"].append(f"x{i}.npy")
        np.save(work / f"x{i}.npy", x)
    if respecialize is not None:
        job["respecialize"] = "xr.npy"
        np.save(work / "xr.npy", respecialize)
    want = [_outputs(session.predict(torch.from_numpy(x).to(device)))
            for x in xs]
    want_z = [_outputs(with_logits(session.specialize(x.shape[0])).predict(
        torch.from_numpy(x).to(device))) for x in xs]
    digests = session_digests(session)
    res = run_child(art, work, device, job)

    def got(prefix, i, n):
        return [np.load(work / f"{prefix}{i}_{j}.npy") for j in range(n)]

    same = [_same(got("y", i, len(w)), w) for i, w in enumerate(want)]
    same_z = [_same(got("z", i, len(w)), w) for i, w in enumerate(want_z)]
    if not all(same) or not all(same_z):
        raise RuntimeError(f"{name}: the loaded session's outputs differ "
                           f"from the saving session's ({same}, {same_z})")
    if res["digests"] != digests:
        bad = sorted(k for k in digests if res["digests"].get(k)
                     != digests[k])
        raise RuntimeError(f"{name}: weight leaves differ after the load: "
                           f"{bad[:5]} ({len(bad)})")
    if res["searches"] != 0 or res["searches_at_load"] != 0:
        raise RuntimeError(f"{name}: {res['searches']} schedule searches "
                           "in the loaded session's predicts")
    if res["probes"] != 0 or (res["tuning"], res["transform_bw"]) != (
            session.tuning, session.transform_bw):
        raise RuntimeError(f"{name}: {res['probes']} calibration probes, "
                           f"tuning {res['tuning']} and transform_bw "
                           f"{res['transform_bw']} after the load (saved: "
                           f"{session.tuning}, {session.transform_bw})")
    graph = session.plan_for(1).planned.graph
    n_convs = sum(1 for n in graph.topo_order() if n.op in CONV_OPS)
    b1 = n_convs if on_card and session.use_kernel else 0
    per = [r["conv2d_nchwc"] for r in res["launches_per_request"]]
    others = {k: v for k, v in res["launches"].items()
              if k != "conv2d_nchwc" and v}
    if per != [b1] * len(xs) or others:
        raise RuntimeError(f"{name}: B1 launches per predict {per}, "
                           f"expected {b1} each; other launches {others}")
    routes = {k: v for k, v in res["b1_launches_by_route"].items() if v}
    if routes != ({"sm90": sum(per)} if b1 else {}):
        raise RuntimeError(f"{name}: B1 launches by route {routes}, "
                           f"expected all {sum(per)} on sm90")
    lowerings = 0 if session.use_kernel else n_convs
    if res["lowerings_per_request"] != [lowerings] * len(xs):
        raise RuntimeError(f"{name}: lowerings per predict "
                           f"{res['lowerings_per_request']}, expected "
                           f"{lowerings} each")
    if (res["dtype"], res["use_kernel"], res["batch_sizes"]) != (
            session.dtype, session.use_kernel, session.batch_sizes):
        raise RuntimeError(f"{name}: loaded as {res['dtype']}, use_kernel "
                           f"{res['use_kernel']}, batches "
                           f"{res['batch_sizes']}")
    quantized = (art / "quantized.json").is_file()
    if quantized != (session.dtype == "int8"):
        raise RuntimeError(f"{name}: quantized.json present: {quantized}")
    line = {"phase": "artifacts", "artifact": name,
            "model": session.model_name, "dtype": session.dtype,
            "use_kernel": session.use_kernel,
            "batches": session.batch_sizes, "save_s": save_s, **size,
            "compile_s": compile_s, "start_s": res["start_s"],
            "load_s": res["load_s"], "rebuild_s": res["rebuild_s"],
            "first_predict_s": res["first_s"], "child_s": res["child_s"],
            "requests": [int(x.shape[0]) for x in xs],
            "b1_launches_per_predict": per,
            "b1_launches_by_route": res["b1_launches_by_route"],
            "lowerings_per_predict": res["lowerings_per_request"],
            "lowering_calls": res["lowering_calls"],
            "search_calls": res["searches"], "probes": res["probes"],
            "tuning": res["tuning"], "transform_bw": res["transform_bw"],
            "quantized_json": quantized,
            "outputs_bit_identical": True, "logits_bit_identical": True,
            "leaves_bit_identical": len(digests)}
    if respecialize is not None:
        b = int(respecialize.shape[0])
        ref = _outputs(with_logits(session.specialize(b)).predict(
            torch.from_numpy(respecialize).to(device)))
        session.release(b)
        new = [np.load(work / f"r_{j}.npy") for j in range(len(ref))]
        err = 0.0
        for g, w in zip(new, ref):
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL * scale)
            err = max(err, float(np.abs(g - w).max()) / scale)
        line["respecialized"] = {
            "batch": b, "seconds": res["respecialize_s"],
            "searches": res["respecialize_searches"],
            "max_logit_err_rel": err, "bit_identical": _same(new, ref),
            "logit_tol_rel": LOGIT_TOL}
    if corrupt:
        bad = tmp / f"{name}-corrupt"
        shutil.copytree(art, bad)
        victim = sorted((bad / "weights").rglob("leaf_*.npy"))[0]
        data = bytearray(victim.read_bytes())
        data[len(data) // 2] ^= 0xFF
        victim.write_bytes(bytes(data))
        msg = _expect_corrupt(bad, device)
        line["corrupt_copy_refused"] = {
            "file": victim.relative_to(bad).as_posix(), "error": msg[:160]}
        shutil.rmtree(bad)
    if keep is None:
        shutil.rmtree(art)
    else:
        shutil.move(art, keep)
    shutil.rmtree(work)
    emit(line)
    return line


def _lm_artifact(run: dict, name: str, tmp: Path, device, prompts) -> dict:
    """Save an LM session, load it in a child, and hold the child to it:
    every weight leaf bit for bit, the same tokens for every prompt, and
    on the card B4 (or the model's attention kernel) once per layer per
    prefill, with no search."""
    session = run["session"]
    on_card = torch.device(device).type == "cuda"
    cfg = session.cfg
    art, work = tmp / name, tmp / f"{name}-work"
    work.mkdir()
    t0 = time.perf_counter()
    session.save(art)
    save_s = time.perf_counter() - t0
    size = artifact_size(art)
    rng = np.random.default_rng(11)
    toks = [rng.integers(0, cfg.vocab, size=(session.batch, n))
            for n, _ in prompts]
    for i, t in enumerate(toks):
        np.save(work / f"p{i}.npy", t)
    kernels = lm_kernels_of(cfg)
    job = {"kind": "lm", "prompts": [f"p{i}.npy" for i in range(len(toks))],
           "new": [new for _, new in prompts],
           "kernels": ["ssd_chunk_sm90"] if "ssd_intra" in kernels
           else ["flash_attention_sm90"]}
    want = [session.generate(t, new) for t, (_, new) in zip(toks, prompts)]
    digests = leaf_digests(session._params)
    res = run_child(art, work, device, job)
    same = [np.array_equal(np.load(work / f"tok{i}.npy"), w)
            for i, w in enumerate(want)]
    if not all(same):
        raise RuntimeError(f"{name}: the loaded session's tokens differ "
                           f"({same})")
    if res["digests"] != digests:
        raise RuntimeError(f"{name}: weight leaves differ after the load")
    if res["cfg"] != json.loads(json.dumps(dataclasses.asdict(cfg))) \
            or res["seq_buckets"] != session.seq_buckets:
        raise RuntimeError(f"{name}: config or buckets differ after the "
                           "load")
    want_launches = [{k: (bool(session.bucket_for(n)) * pp
                          + (n - (session.bucket_for(n) or 0) + new - 1) * pd)
                      if on_card else 0 for k, (pp, pd) in kernels.items()}
                     for n, new in prompts]
    got = [{k: r[k] for k in kernels} for r in res["launches_per_request"]]
    others = {k: v for k, v in res["launches"].items()
              if k not in kernels and v}
    if got != want_launches or others or res["searches"]:
        raise RuntimeError(f"{name}: launches per request {got}, expected "
                           f"{want_launches}; others {others}; searches "
                           f"{res['searches']}")
    line = {"phase": "artifacts", "artifact": name,
            "model": session.model_name, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "save_s": save_s, **size,
            "compile_s": run["compile_s"], "start_s": res["start_s"],
            "load_s": res["load_s"], "rebuild_s": res["rebuild_s"],
            "first_generate_s": res["first_s"], "child_s": res["child_s"],
            "requests": [list(p) for p in prompts],
            "launches_per_request": got, "search_calls": res["searches"],
            "tokens_equal": True, "leaves_bit_identical": len(digests)}
    shutil.rmtree(art)
    shutil.rmtree(work)
    emit(line)
    return line


def phase_artifacts(device, main_run: dict, lm_run: dict,
                    tuned_run: dict | None = None,
                    requests: int = ARTIFACT_REQUESTS,
                    big_batch: int = BIG_BATCH,
                    respecialize: int = RESPECIALIZE,
                    prompts=ARTIFACT_PROMPTS,
                    keep: Path | None = None) -> list:
    """A6 on the card: ``main_run``'s session (its batch-1 and
    ``big_batch`` specializations, the source packed), an int8 session on
    the lowerings (batch 1), ``lm_run``'s session and ``tuned_run``'s
    measured session (``phase_tuning``, batch 1), each saved and loaded
    cold in a fresh process (``_cnn_artifact``, ``_lm_artifact``: no
    search, no calibration probe, the saved ``transform_bw``); a copy of
    the first with one flipped byte must be refused.  All in a temporary
    directory of the checkout that the phase deletes, but for the first
    artifact, which moves to ``keep`` where given."""
    from repro_torch.engine import compile

    model, image = main_run["model"], main_run["image"]
    *xs, x_big = requests_for(image, requests, big_batch, seed=7)
    xr = np.random.default_rng(8).normal(
        size=(respecialize, 3, image, image)).astype(np.float32)
    tmp = Path(tempfile.mkdtemp(prefix=".artifacts-", dir=ROOT))
    try:
        lines = [_cnn_artifact(
            main_run["session"], model, tmp, xs + [x_big], device,
            main_run["compile_s"], ["conv2d_nchwc_sm90"], respecialize=xr,
            corrupt=True, keep=keep)]
        t0 = time.perf_counter()
        q8 = compile(model, (1, 3, image, image), seed=0, device=device,
                     dtype="int8", use_kernel=False)
        lines.append(_cnn_artifact(q8, f"{model}-int8", tmp, xs, device,
                                   time.perf_counter() - t0, []))
        del q8
        lines.append(_lm_artifact(lm_run, lm_run["model"], tmp, device,
                                  prompts))
        if tuned_run is not None:
            lines.append(_cnn_artifact(
                tuned_run["session"], f"{tuned_run['model']}-measured", tmp,
                xs, device, tuned_run["compile_s"], ["conv2d_nchwc_sm90"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


# ---------------------------------------------------------------------------
# serving (A7)
# ---------------------------------------------------------------------------

SERVE_REQUESTS = 64        # the load step's requests (1-3 rows each)
SERVE_BUCKET = 8           # every served batch runs the batch-8 plan
SERVE_CLIENTS = 4          # client threads submitting them
SERVE_ROUNDS = 5           # paired rounds of the load step
# chaos: the watchdog far above a batch-8 predict (3.2 ms of latency, PR
# 21), the stalled batch far past it
SERVE_WATCHDOG_MS = 250.0
SERVE_DELAY_MS = 600.0
TRACE_REQUESTS = 96
# mamba2-130m's buckets are 512, 1024 and 2048: every prompt prefills (B4),
# two exactly at a bucket, two with a decode catch-up of 28 and 32 tokens
STREAM_PROMPTS = (512, 540, 1024, 1056)
STREAM_NEW = 32
FLEET_MODEL = ("vgg-16", 224)
STARTUP_LIMIT_S = 30.0     # spawn to the first served response (PERF.md §2)
SERVE_TIMEOUT_S = 300


def _rows_images(rows: list, image: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(r, 3, image, image)).astype(np.float32)
            for r in rows]


def _serving_threads_done(timeout: float = 10.0) -> None:
    """Join every serving worker thread still alive (a superseded one may
    still be finishing a stalled batch), so counts read after are final."""
    import threading

    for t in threading.enumerate():
        if t.name.startswith("neocpu-serving"):
            t.join(timeout)


def _serve(srv, xs: list, device, clients: int = SERVE_CLIENTS) -> dict:
    """``xs`` submitted to the server ``srv`` by ``clients`` threads
    (request i by thread i % clients; the odd threads upload theirs to the
    card first, so the server takes host arrays and device tensors both);
    every response read.  Returns the responses (numpy), the seconds from
    the first submit to the last response, each request's latency from
    its submit to its future's resolution (ms), and the B1 launches and
    batches of the run."""
    import threading

    b1 = _kernel_fns()["conv2d_nchwc"]
    futs, lat = [None] * len(xs), [None] * len(xs)

    def client(c):
        for i in range(c, len(xs), clients):
            x = xs[i]
            if c % 2:
                x = torch.from_numpy(x).to(device)
            t = time.perf_counter()
            futs[i] = srv.submit(x)
            futs[i].add_done_callback(
                lambda _f, i=i, t=t: lat.__setitem__(
                    i, (time.perf_counter() - t) * 1e3))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    launches, batches = b1.launches, srv.stats.n_batches
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outs = [f.result(timeout=SERVE_TIMEOUT_S) for f in futs]
    seconds = time.perf_counter() - t0
    while None in lat:      # a future's callbacks run just after its waiters
        time.sleep(1e-4)
    return {"outs": [y.cpu().numpy() for y in outs], "seconds": seconds,
            "lat_ms": lat, "b1": b1.launches - launches,
            "batches": srv.stats.n_batches - batches}


def _bit_identical(name: str, got: list, want: list) -> None:
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not (g.shape == w.shape and g.tobytes() == w.tobytes())]
    if len(got) != len(want) or bad:
        raise RuntimeError(f"serving {name}: responses {bad[:8]} of "
                           f"{len(want)} differ from padded_predict at "
                           "their bucket")


def _served_clean(name: str, st) -> None:
    """Outside the chaos step nothing may fail, be shed, expire or be
    refused."""
    bad = {k: getattr(st, k) for k in (
        "n_failed", "n_shed", "n_deadline_expired", "n_rejected_full",
        "n_rejected_too_large", "n_cancelled", "n_retried",
        "n_worker_crashes") if getattr(st, k)}
    if bad:
        raise RuntimeError(f"serving {name}: {bad}")


def _b1_per_batch(name: str, run: dict, n_convs: int, on_card: bool) -> None:
    want = n_convs * run["batches"] if on_card else 0
    if run["b1"] != want:
        raise RuntimeError(f"serving {name}: {run['b1']} B1 launches for "
                           f"{run['batches']} batches, expected {want}")


def _busy(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (``_profiled``): its
    wall ms, the card's busy ms (the union of the kernels' intervals, as
    two streams may overlap), the kernels' summed ms and the idle share."""
    from torch.autograd import DeviceType

    prof, wall_ms, _, gaps = _profiled(fn, 1)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.id not in gaps["lead_ids"])
    if not spans:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    busy, kernel_us, (lo, hi) = 0.0, 0.0, spans[0]
    for a, b in spans:
        kernel_us += b - a
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy = (busy + hi - lo) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "kernel_sum_ms": kernel_us / 1e3,
            "idle_share": 1 - busy / wall_ms}


@contextlib.contextmanager
def host_split():
    """Host seconds, summed over the serving workers, of the three steps
    of each executed batch while the block runs: gathering its inputs
    onto the device (``AsyncServer._gather``), the graph walk that
    enqueues its kernels (``CompiledModel.predict``) and the wait for its
    stream (``torch.cuda.Stream.synchronize``).  The functions are
    wrapped, not replaced."""
    import threading

    from repro_torch.engine import AsyncServer, CompiledModel

    owners = {"gather": (AsyncServer, "_gather"),
              "walk": (CompiledModel, "predict"),
              "wait": (torch.cuda.Stream, "synchronize")}
    real = {k: getattr(cls, name) for k, (cls, name) in owners.items()}
    spent = dict.fromkeys(owners, 0.0)
    lock = threading.Lock()

    def timed(key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real[key](*args, **kw)
            finally:
                with lock:
                    spent[key] += time.perf_counter() - t0
        return call

    for k, (cls, name) in owners.items():
        setattr(cls, name, timed(k))
    try:
        yield spent
    finally:
        for k, (cls, name) in owners.items():
            setattr(cls, name, real[k])


def _stats_line(st) -> dict:
    js = st.to_json()
    return {k: js[k] for k in ("n_submitted", "n_completed", "n_batches",
                               "rows_executed", "rows_padded",
                               "mean_batch_rows", "p50_ms", "p90_ms",
                               "p99_ms", "worker_batches")}


def serving_load(session, device, smi: str, xs: list, refs: list,
                 n_convs: int, rounds: int = SERVE_ROUNDS) -> dict:
    """The reference's ``serving_load``: ``xs`` served four ways in each
    of ``rounds`` paired rounds — sequential ``padded_predict`` at the
    bucket, a long-lived server at 1 and at 2 workers (``_serve``, each
    warmed by one round first: a worker's stream draws its own memory
    from the caching allocator), and sequential at each request's nearest
    bucket (informational) — every served response bit-identical to
    ``refs`` and B1 once per conv node per executed batch, every round.
    Then one more round a server under ``host_split`` (a batch's host ms
    by step) and, on the card, one under the profiler."""
    from repro_torch.engine import (AsyncServer, DynamicBatchPolicy,
                                    padded_predict)

    on_card = torch.device(device).type == "cuda"
    policy = DynamicBatchPolicy(max_batch=SERVE_BUCKET, max_wait_ms=2.0,
                                fixed_bucket=SERVE_BUCKET)

    def sequential(bucket):
        t0 = time.perf_counter()
        for x in xs:
            padded_predict(session, x, bucket=bucket)
            if on_card:
                torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    def served(w):
        run = _serve(servers[w], xs, device)
        _bit_identical(f"load workers={w}", run["outs"], refs)
        _b1_per_batch(f"load workers={w}", run, n_convs, on_card)
        return run

    servers = {w: AsyncServer(session, policy, workers=w,
                              max_queue=len(xs)) for w in (1, 2)}
    samples = {"sequential": [], "workers_1": [], "workers_2": [],
               "sequential_nearest": []}
    runs = {1: [], 2: []}
    try:
        for w in (1, 2):
            served(w)                       # warm-up round
        for _ in range(rounds):
            samples["sequential"].append(sequential(SERVE_BUCKET))
            for w in (1, 2):
                runs[w].append(served(w))
                samples[f"workers_{w}"].append(runs[w][-1]["seconds"])
            samples["sequential_nearest"].append(sequential(None))
        split = {}
        for w in (1, 2):
            with host_split() as spent:
                run = served(w)
            split[f"workers_{w}"] = {
                "seconds": run["seconds"], "batches": run["batches"],
                **{k: v * 1e3 / run["batches"] for k, v in spent.items()}}
        trace = ({f"workers_{w}": _busy(lambda w=w: _serve(servers[w], xs,
                                                           device))
                  for w in (1, 2)} if on_card else None)
    finally:
        for srv in servers.values():
            srv.close()
        _serving_threads_done()
    for w, srv in servers.items():
        _served_clean(f"load workers={w}", srv.stats)
    n, rows = len(xs), sum(int(x.shape[0]) for x in xs)
    med = {k: statistics.median(v) for k, v in samples.items()}
    out = {"phase": "serving", "step": "load", "card": smi,
           "requests": n, "rows": rows, "bucket": SERVE_BUCKET,
           "clients": SERVE_CLIENTS, "rounds": rounds,
           "median_s": med, "samples_s": samples,
           "requests_per_s": {k: n / v for k, v in med.items()},
           "rows_per_s": {k: rows / v for k, v in med.items()},
           "speedup_vs_sequential": {
               f"workers_{w}": med["sequential"] / med[f"workers_{w}"]
               for w in (1, 2)},
           "bit_identical": True,
           "b1_launches": {f"workers_{w}": sum(r["b1"] for r in runs[w])
                           for w in (1, 2)},
           "host_ms_per_batch": split}
    for w in (1, 2):
        lat = [x for r in runs[w] for x in r["lat_ms"]]
        out[f"workers_{w}"] = {
            "latency_ms": {"p50": float(np.percentile(lat, 50)),
                           "p99": float(np.percentile(lat, 99))},
            "batches_per_round": [r["batches"] for r in runs[w]],
            "server": _stats_line(servers[w].stats)}
    if trace is not None:
        out["trace"] = trace
    emit(out)
    return out


def serving_chaos(session, device, smi: str, xs: list, refs: list,
                  n_convs: int, watchdog_ms: float = SERVE_WATCHDOG_MS,
                  delay_ms: float = SERVE_DELAY_MS) -> dict:
    """The reference's ``serving_chaos``: two workers, a retry budget of 3
    and the watchdog at ``watchdog_ms``; the worker of batch 1 is killed,
    batches 3 and 5 fail, batch 7 stalls for ``delay_ms``, past the
    watchdog.  Every request completes bit-identical to ``refs``."""
    from repro_torch.engine import (AsyncServer, DelayBatch,
                                    DynamicBatchPolicy, FailBatch,
                                    FaultInjector, KillWorker, RetryPolicy)

    on_card = torch.device(device).type == "cuda"
    inj = FaultInjector(KillWorker(on_batch=1), FailBatch(on_batch=3),
                        FailBatch(on_batch=5),
                        DelayBatch(on_batch=7, delay_ms=delay_ms))
    srv = AsyncServer(session, DynamicBatchPolicy(
        max_batch=SERVE_BUCKET, max_wait_ms=2.0, fixed_bucket=SERVE_BUCKET),
        workers=2, max_queue=len(xs),
        retry=RetryPolicy(budget=3, backoff_ms=1.0),
        watchdog_ms=watchdog_ms, max_restarts=3, faults=inj)
    b1 = _kernel_fns()["conv2d_nchwc"]
    launches = b1.launches
    try:
        run = _serve(srv, xs, device)
    finally:
        srv.close()
        _serving_threads_done()     # the stalled batch's thread included
    # the stalled batch runs on after its requeued copy answered
    run.update(batches=srv.stats.n_batches, b1=b1.launches - launches)
    _bit_identical("chaos", run["outs"], refs)
    st = srv.stats
    fired = sorted(inj.fired_kinds())
    if (fired != ["DelayBatch", "FailBatch", "FailBatch", "KillWorker"]
            or st.n_completed != len(xs) or st.n_failed
            or st.n_worker_crashes != 1 or st.n_hung_requeued < 1
            or st.n_worker_restarts < 2 or st.n_retried < 4):
        raise RuntimeError(f"serving chaos: fired {fired}, {st.to_json()}")
    _b1_per_batch("chaos", run, n_convs, on_card)
    counters = srv.health()["counters"]
    out = {"phase": "serving", "step": "chaos", "card": smi,
           "requests": len(xs), "workers": 2, "retry_budget": 3,
           "watchdog_ms": watchdog_ms, "delay_ms": delay_ms,
           "fired": inj.fired, "seconds": run["seconds"],
           "counters": counters, "health": {
               k: v for k, v in srv.health().items() if k != "telemetry"},
           "b1_launches": run["b1"], "bit_identical": True,
           **_stats_line(st)}
    emit(out)
    return out


def serving_trace(session, device, smi: str, n_convs: int,
                  n: int = TRACE_REQUESTS, seed: int = 0) -> dict:
    """The reference's ``serving_trace``: ``synth_trace("bursty")`` of
    ``n`` requests up to 8 rows, the three priority classes in turn,
    replayed in real time by one client into two workers packing
    earliest-deadline-first; nothing lost, every response bit-identical
    at the bucket."""
    from repro_torch.engine import (PRIORITY_CLASSES, AsyncServer,
                                    DynamicBatchPolicy, padded_predict,
                                    synth_trace)

    on_card = torch.device(device).type == "cuda"
    trace = synth_trace("bursty", n=n, mean_rate=200.0, max_rows=8,
                        priorities=PRIORITY_CLASSES, seed=seed)
    image = session.input_spec[next(iter(session.input_spec))][-1]
    xs = _rows_images([r.rows for r in trace], image, seed + 21)
    refs = [padded_predict(session, x, bucket=SERVE_BUCKET).cpu().numpy()
            for x in xs]
    b1 = _kernel_fns()["conv2d_nchwc"]
    srv = AsyncServer(session, DynamicBatchPolicy(
        max_batch=SERVE_BUCKET, max_wait_ms=2.0, fixed_bucket=SERVE_BUCKET,
        order="edf"), workers=2, max_queue=n)
    launches = b1.launches
    futs, lag = [], []
    t0 = time.perf_counter()
    for r, x in zip(trace, xs):
        wait = t0 + r.t - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        lag.append(time.perf_counter() - t0 - r.t)
        futs.append(srv.submit(x, priority=r.priority,
                               deadline_ms=r.deadline_ms))
    outs = [f.result(timeout=SERVE_TIMEOUT_S).cpu().numpy() for f in futs]
    seconds = time.perf_counter() - t0
    srv.close()
    _serving_threads_done()
    _bit_identical("trace", outs, refs)
    st = srv.stats
    _served_clean("trace", st)
    run = {"batches": st.n_batches, "b1": b1.launches - launches}
    _b1_per_batch("trace", run, n_convs, on_card)
    out = {"phase": "serving", "step": "trace", "card": smi,
           "kind": "bursty", "requests": n,
           "rows": sum(r.rows for r in trace), "trace_s": trace[-1].t,
           "seconds": seconds, "submit_lag_ms_max": max(lag) * 1e3,
           "requests_per_s": n / seconds,
           "by_class_ms": {k: {q: (v * 1e3 if isinstance(v, float) else v)
                               for q, v in s.to_json().items()
                               if q in ("count", "p50", "p99")}
                           for k, s in sorted(st.latency_by_class.items())},
           "n_shed": st.n_shed, "n_deadline_expired": st.n_deadline_expired,
           "b1_launches": run["b1"], "bit_identical": True,
           **_stats_line(st)}
    emit(out)
    return out


def serving_stream(lm, device, smi: str, prompts=STREAM_PROMPTS,
                   new: int = STREAM_NEW, seed: int = 5) -> dict:
    """The reference's ``lm_serving``: each prompt streamed through
    ``submit_stream`` (one at a time, so the first token's time holds no
    queueing); the tokens of every step equal ``generate``'s, and B4
    launches once per layer per prefill."""
    from repro_torch.engine import AsyncServer, DynamicBatchPolicy

    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed)
    toks = [rng.integers(0, lm.cfg.vocab, size=(lm.batch, n))
            for n in prompts]
    want = [lm.generate(t, new) for t in toks]
    b4 = _kernel_fns()["ssd_intra"]
    per_prefill = lm_kernels_of(lm.cfg).get("ssd_intra", (0, 0))[0]
    srv = AsyncServer(lm, DynamicBatchPolicy(max_batch=lm.batch,
                                             max_wait_ms=0.0))
    streams = []
    for n, t, w in zip(prompts, toks, want):
        launches = b4.launches
        t0 = time.perf_counter()
        stream = srv.submit_stream(t, new)
        arrivals, steps = [], []
        for step in stream:
            arrivals.append(time.perf_counter())
            steps.append(np.asarray(step))
        got = np.stack(steps, axis=1)
        if not np.array_equal(got, w):
            raise RuntimeError(f"serving stream: the streamed tokens of the "
                               f"{n}-token prompt differ from generate's")
        prefilled = lm.bucket_for(n) is not None
        expect = per_prefill * prefilled if on_card else 0
        if b4.launches - launches != expect:
            raise RuntimeError(f"serving stream: {b4.launches - launches} B4 "
                               f"launches for the {n}-token prompt, "
                               f"expected {expect}")
        streams.append({
            "prompt": n, "bucket": lm.bucket_for(n), "new": new,
            "ttft_ms": (arrivals[0] - t0) * 1e3,
            "tpot_ms": (arrivals[-1] - arrivals[0]) * 1e3 / (new - 1),
            "b4_launches": b4.launches - launches})
    srv.close()
    _served_clean("stream", srv.stats)
    out = {"phase": "serving", "step": "stream", "card": smi,
           "model": lm.model_name, "streams": streams,
           "tokens_equal": True, "b4_launches_per_prefill": per_prefill
           if on_card else 0, **_stats_line(srv.stats)}
    emit(out)
    return out


def serving_fleet(session, device, smi: str, model=FLEET_MODEL,
                  seed: int = 0) -> dict:
    """Two tenants in a ``FleetServer`` — ``session`` and ``model`` compiled
    here, each at buckets {1, 8} — under a memory budget that holds three of
    the four specializations.  One request at a time (so the bucket it runs
    through, the smallest resident one that fits, is known): every
    response bit-identical to ``padded_predict`` at that bucket from before
    the fleet existed; LRU evicts, an evicted bucket that nothing resident
    covers re-specializes with no schedule search, nothing is lost.  The
    first tenant's single-row request makes its bucket 8 the least
    recently used when the second tenant arrives."""
    from repro_torch.core.local_search import search_calls
    from repro_torch.engine import (DynamicBatchPolicy, FleetServer,
                                    compile, nearest_bucket, padded_predict)

    name, image = model
    t0 = time.perf_counter()
    second = compile(name, (1, 3, image, image), seed=seed, device=device)
    second.specialize(SERVE_BUCKET)
    compile_s = time.perf_counter() - t0
    first = session.model_name or "first"
    other = name if name != first else f"{name}-2"
    tenants = {first: session, other: second}
    mem = {t: s.memory_bytes() for t, s in tenants.items()}
    sizes = [b for d in mem.values() for b in d.values()]
    budget = sum(sizes) - min(sizes) // 2
    stream = [(first, 8), (first, 1), (other, 1), (first, 8), (other, 8),
              (first, 1), (other, 1), (first, 8), (other, 8), (first, 1)]
    images = {t: s.input_spec[next(iter(s.input_spec))][-1]
              for t, s in tenants.items()}
    xs = [_rows_images([rows], images[t], seed + 31 + i)[0]
          for i, (t, rows) in enumerate(stream)]
    refs = {(i, b): padded_predict(tenants[t], x, bucket=b).cpu().numpy()
            for i, ((t, rows), x) in enumerate(zip(stream, xs))
            for b in (1, SERVE_BUCKET) if b >= rows}
    n_convs = {t: sum(1 for nd in s.plan_for(1).planned.graph.topo_order()
                      if nd.op in CONV_OPS) for t, s in tenants.items()}
    on_card = torch.device(device).type == "cuda"
    b1 = _kernel_fns()["conv2d_nchwc"]
    fleet = FleetServer(memory_budget_bytes=budget, autostart=False,
                        device=device)
    searches, launches = search_calls(), b1.launches
    ran, respecialized, want_b1 = [], 0, 0
    for i, ((t, rows), x) in enumerate(zip(stream, xs)):
        if t not in fleet.models:
            fleet.add_model(t, tenants[t], policy=DynamicBatchPolicy(
                max_batch=SERVE_BUCKET, max_wait_ms=0.0))
        fut = fleet.submit(t, x)
        bucket = nearest_bucket(rows, tenants[t].batch_sizes)
        respecialized += bucket is None
        if not fleet.step(t):
            raise RuntimeError(f"serving fleet: request {i} did not run")
        got = fut.result(timeout=SERVE_TIMEOUT_S).cpu().numpy()
        bucket = bucket or rows
        _bit_identical(f"fleet request {i}", [got], [refs[(i, bucket)]])
        ran.append([t, rows, bucket])
        want_b1 += n_convs[t] if on_card else 0
    health = fleet.health()
    fleet.close()
    if search_calls() != searches or respecialized < 1 \
            or fleet.n_evictions < 2:
        raise RuntimeError(f"serving fleet: {search_calls() - searches} "
                           f"searches, {respecialized} re-specializations, "
                           f"{fleet.n_evictions} evictions")
    if b1.launches - launches != want_b1:
        raise RuntimeError(f"serving fleet: {b1.launches - launches} B1 "
                           f"launches, expected {want_b1}")
    for t, st in fleet.stats().items():
        _served_clean(f"fleet {t}", st)
    out = {"phase": "serving", "step": "fleet", "card": smi,
           "tenants": {t: {"image": images[t],
                           "bytes_per_specialization": mem[t]}
                       for t in tenants},
           "second_compile_s": compile_s, "budget_bytes": budget,
           "requests": ran, "evictions": fleet.n_evictions,
           "respecialized": respecialized, "searches": 0,
           "resident_bytes": health["memory"]["resident_bytes"],
           "resident_buckets": {t: sorted(s.batch_sizes)
                                for t, s in tenants.items()},
           "b1_launches": b1.launches - launches, "bit_identical": True}
    emit(out)
    return out


def serving_startup(art: Path, device, smi: str, x: np.ndarray,
                    ref: np.ndarray, n_convs: int) -> dict:
    """A fresh ``python3 chip_smoke.py --load-artifact`` process loads the
    ResNet-50 artifact, starts an ``AsyncServer`` and serves ``x``: the
    seconds from the spawn to the first response (under
    ``STARTUP_LIMIT_S``) split into start, load, server start and first
    response; bit-identical to the parent, no search, and on the card B1
    launched once per conv node (``n_convs``) for it."""
    work = Path(tempfile.mkdtemp(prefix=".serving-", dir=ROOT))
    try:
        np.save(work / "x0.npy", x)
        job = {"kind": "serve", "kernels": ["conv2d_nchwc_sm90"],
               "inputs": ["x0.npy"], "bucket": SERVE_BUCKET}
        t0 = time.time()
        res = run_child(art, work, device, job)
        spawn_to_first = res["t_first"] - t0
        got = np.load(work / "y0_0.npy")
        _bit_identical("startup", [got], [ref])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if res["searches"] or spawn_to_first > STARTUP_LIMIT_S:
        raise RuntimeError(f"serving startup: {res['searches']} searches, "
                           f"{spawn_to_first:.2f} s from spawn to the first "
                           f"response (limit {STARTUP_LIMIT_S} s)")
    b1 = res["launches"]["conv2d_nchwc"]
    want = n_convs if torch.device(device).type == "cuda" else 0
    if b1 != want:
        raise RuntimeError(f"serving startup: {b1} B1 launches for the "
                           f"first response, expected {want}")
    out = {"phase": "serving", "step": "startup", "card": smi,
           "spawn_to_first_response_s": spawn_to_first,
           "limit_s": STARTUP_LIMIT_S, "start_s": res["start_s"],
           "rebuild_s": res["rebuild_s"], "load_s": res["load_s"],
           "server_start_s": res["server_s"],
           "first_response_s": res["first_s"], "child_s": res["child_s"],
           "searches": 0, "bit_identical": True,
           "b1_launches_first_response": b1}
    emit(out)
    return out


def phase_serving(device, smi: str, main_run: dict, lm_run: dict,
                  art: Path, requests: int = SERVE_REQUESTS,
                  rounds: int = SERVE_ROUNDS, trace_n: int = TRACE_REQUESTS,
                  prompts=STREAM_PROMPTS, new: int = STREAM_NEW,
                  fleet_model=FLEET_MODEL,
                  chaos_ms=(SERVE_WATCHDOG_MS, SERVE_DELAY_MS)) -> dict:
    """A7 on the card: ``main_run``'s ResNet-50 session (batch 1 and 8) and
    ``lm_run``'s mamba2-130m session served — ``load``, ``chaos``,
    ``trace``, ``stream``, ``fleet`` and, from ``art`` (phase 10's saved
    ResNet-50 artifact), ``startup`` — one line each, then the phase's
    seconds (``total``).  Every served
    response is bit-identical to ``padded_predict`` at its bucket, and the
    launches of the served batches are counted (B1 53 a batch, B4 24 a
    streamed prefill)."""
    from repro_torch.engine import padded_predict, synth_trace

    t0 = time.perf_counter()
    session, image = main_run["session"], main_run["image"]
    n_convs = sum(1 for nd in session.plan_for(1).planned.graph.topo_order()
                  if nd.op in CONV_OPS)
    rows = [r.rows for r in synth_trace("uniform", n=requests, max_rows=3,
                                        seed=0)]
    xs = _rows_images(rows, image, 13)
    refs = [padded_predict(session, x, bucket=SERVE_BUCKET).cpu().numpy()
            for x in xs]
    lines = {"load": serving_load(session, device, smi, xs, refs, n_convs,
                                  rounds),
             "chaos": serving_chaos(session, device, smi, xs, refs,
                                    n_convs, *chaos_ms),
             "trace": serving_trace(session, device, smi, n_convs, trace_n),
             "stream": serving_stream(lm_run["session"], device, smi,
                                      prompts, new),
             "startup": serving_startup(art, device, smi, xs[0], refs[0],
                                        n_convs),
             "fleet": serving_fleet(session, device, smi, fleet_model)}
    lines["b1_launches"] = {k: lines[k]["b1_launches"]
                            for k in ("load", "chaos", "trace", "fleet")}
    lines["b4_stream_launches"] = [s["b4_launches"]
                                   for s in lines["stream"]["streams"]]
    emit({"phase": "serving", "step": "total", "card": smi,
          "seconds": time.perf_counter() - t0})
    return lines


def _leaves(tree):
    """The tensors of a parameter tree of dicts and lists."""
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, list):
        yield tree
        return
    for v in tree:
        yield from _leaves(v)


# ---------------------------------------------------------------------------

def _release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_a8(device, memory: list) -> dict:
    """The A8 families at full width, bf16, one at a time, each released
    before the next: recurrentgemma-2b through the session
    (``phase_lm_main``, ``phase_lm_e2e``), llava-next-mistral-7b and
    whisper-tiny through the model's entry points
    (``phase_lm_frontend``, ``phase_lm_frontend_e2e``); then each
    family's fp32 copy at a cut depth against the CPU."""
    main, e2e = [], []
    run = phase_lm_main(device, HYBRID, max_len=HYBRID_MAX_LEN,
                        requests=HYBRID_REQUESTS, big=None)
    memory.append(memory_line(f"lm_main {HYBRID}", device))
    e2e.append(phase_lm_e2e(run, device))
    run.pop("session")
    run.pop("big_session")
    main.append(run)
    _release()
    for m, (max_len, prompt, new, batches) in FRONTEND.items():
        run = phase_lm_frontend(device, m, max_len, prompt, new, batches)
        memory.append(memory_line(f"lm_frontend {m}", device))
        e2e.append(phase_lm_frontend_e2e(run, device))
        run.pop("params")
        run.pop("cfg")
        main.append(run)
        _release()
    parity = [phase_lm_parity(device, HYBRID, **HYBRID_PARITY)]
    parity += [phase_lm_parity(device, m, **kw)
               for m, kw in FRONTEND_PARITY.items()]
    memory.append(memory_line("a8 parity", device))
    return {"main": main, "e2e": e2e, "parity": parity}


def memory_line(after: str, device) -> dict:
    """The card's peak allocated bytes since the last line, then a reset."""
    torch.cuda.synchronize(device)
    out = {"phase": "memory", "after": after,
           "elapsed_s": time.perf_counter() - START,
           "max_allocated_bytes": torch.cuda.max_memory_allocated(device),
           "allocated_bytes": torch.cuda.memory_allocated(device)}
    emit(out)
    torch.cuda.reset_peak_memory_stats(device)
    return out


def latency_only(device, smi: str) -> int:
    """ResNet-50's batch-1 and batch-8 predict latency (median ms) and the
    device time and idle share of a batch-1 predict, one JSON line."""
    from repro_torch.engine import compile

    session = compile(MODEL, (1, 3, IMAGE, IMAGE), seed=0, device=device)
    lat = {b: phase_latency(session, device, IMAGE, b, it)["median_ms"]
           for b, it in ((1, 20), (BIG_BATCH, 10))}
    prof = phase_profile(session, device, IMAGE)
    emit({"phase": "latency_only", "card": smi, "tree": str(ROOT),
          "median_ms_batch1": lat[1], f"median_ms_batch{BIG_BATCH}":
          lat[BIG_BATCH], "device_ms_per_predict":
          prof["device_ms_per_predict"], "idle_share": prof["idle_share"]})
    return 0


def prefill_only(device, smi: str, model: str = "mamba2-130m") -> int:
    """One LM's prefill at full width and depth (bf16, random weights):
    host ms per bucket (median of 5) and the card's time per 2,048-token
    prefill from a profiler trace, one JSON line.  Each kernel builds at
    its first call, so it runs in a checkout of another commit too."""
    from repro_torch.engine import compile
    from repro_torch.models.lm.model import prefill

    sess = compile(model, (1, 2048), seed=0, device=device)
    rng = np.random.default_rng(9)
    host = {}
    for b in sess.seq_buckets:
        toks = torch.from_numpy(rng.integers(0, sess.cfg.vocab, size=(1, b))
                                ).to(device)
        host[str(b)] = statistics.median(_host_ms(
            lambda: prefill(sess._params, sess.cfg, toks,
                            max_len=sess.max_len), 5))
    prof = prefill_profile(sess, device)
    emit({"phase": "prefill_only", "card": smi, "tree": str(ROOT),
          "model": model, "prefill_ms": host,
          "device_ms_per_prefill": prof["device_ms"],
          "top_ms": prof["top_ms"][:4]})
    return 0


def serving_only(device, smi: str) -> int:
    """The serving phase alone: ResNet-50 at 224 (batch 1 and 8) and
    mamba2-130m compiled, warmed and the former saved, then
    ``phase_serving``.  B1, B4 and cuBLAS warm up in the compile and the
    warm-up predicts, before any server starts."""
    from repro_torch.engine import compile, padded_predict

    t0 = time.perf_counter()
    session = compile(MODEL, (1, 3, IMAGE, IMAGE), seed=0, device=device)
    session.specialize(BIG_BATCH)
    for b in (1, BIG_BATCH):
        padded_predict(session, np.zeros((1, 3, IMAGE, IMAGE), np.float32),
                       bucket=b)
    main_run = {"session": session, "model": MODEL, "image": IMAGE,
                "compile_s": time.perf_counter() - t0}
    lm = compile("mamba2-130m", (1, 2048), seed=0, device=device)
    lm.prewarm()
    kept = Path(tempfile.mkdtemp(prefix=".artifacts-", dir=ROOT))
    try:
        session.save(kept / MODEL)
        phase_serving(device, smi, main_run, {"session": lm}, kept / MODEL)
    finally:
        shutil.rmtree(kept, ignore_errors=True)
    memory_line("serving", device)
    return 0


def a8_only(device, smi: str) -> int:
    """The A8 families alone: B3 at their shapes against its plain version
    and timed (``A8_ATTN``), then ``phase_a8``; each kernel builds at its
    first call."""
    worst = phase_lm_b3(device, [c for c in attn_cases() if c[0].startswith(
        ("rgemma", "llava", "whisper"))])
    rows = [b3_row(device, b, hq, hkv, s, d, causal, window, sk, model=m)
            for m, b, hq, hkv, s, d, causal, window, sk in A8_ATTN]
    phase_a8(device, [])
    emit({"phase": "a8_only", "card": smi, "b3_max_abs_err": worst,
          "b3_device_ms": [r["device_ms"] for r in rows]})
    return 0


def b3_times(device, smi: str, tree: Path, iters: int = 20) -> int:
    """B3 at ``B3_EARLIER`` with the kernel of the checkout at ``tree``
    (its ``src`` first on the path, its kernels built at the first call),
    one JSON line, so that two checkouts compare in one call on one card:
    ``chip_smoke.py --b3-times OTHER`` for each, in the order A, B, B, A.
    """
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import flash_attention as mod

    rows = [b3_row(device, 1, hq, hkv, s, d, iters=iters)
            for hq, hkv, s, d in B3_EARLIER]
    emit({"phase": "b3_times", "card": smi, "tree": str(tree),
          "module": mod.__file__,
          "device_ms": {f"{hq}:{hkv} S{s} D{d}": r["device_ms"]
                        for (hq, hkv, s, d), r in zip(B3_EARLIER, rows)},
          "ms": [r["ms"] for r in rows],
          "library_device_ms": [r["library_device_ms"] for r in rows]})
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--load-artifact"]:
        return load_artifact(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if sys.argv[1:] == ["--latency-only"]:
        return latency_only(device, smi)
    if sys.argv[1:] == ["--prefill-only"]:
        return prefill_only(device, smi)
    if sys.argv[1:] == ["--tuning-only"]:
        phase_tuning(device, smi)
        return 0
    if sys.argv[1:] == ["--serving-only"]:
        return serving_only(device, smi)
    if sys.argv[1:] == ["--a8-only"]:
        return a8_only(device, smi)
    if sys.argv[1:2] == ["--b3-times"] and len(sys.argv) <= 3:
        return b3_times(device, smi, Path(sys.argv[2]).resolve()
                        if len(sys.argv) == 3 else ROOT)

    build = phase_build()
    convs = plan_convs(MODEL, 1, IMAGE)
    if sum(c["count"] for c in convs) == 0:
        raise RuntimeError("the plan has no conv_block")
    memory = []
    worst = phase_kernels(device, convs + plan_convs(MODEL, BIG_BATCH, IMAGE)
                          + extra_cases())
    zoo_convs = {m: plan_convs(m, 1, image) for m, image in ZOO}
    zoo_worst = phase_kernels(device, [c for cs in zoo_convs.values()
                                       for c in cs])
    memory.append(memory_line("kernels", device))
    main_run = phase_main(device, IMAGE, big_batch=BIG_BATCH, model=MODEL)
    memory.append(memory_line("main", device))
    variants = phase_variants(device, smi)
    memory.append(memory_line("variants", device))
    lm_worst = phase_lm_kernels(device)
    memory.append(memory_line("lm_kernels", device))
    lm_runs = {}
    for m in LM_MODELS:
        lm_runs[m] = phase_lm_main(device, m)
        memory.append(memory_line(f"lm_main {m}", device))
    parity = [phase_lm_parity(device, m) for m in LM_MODELS]
    parity.append(phase_lm_parity(device, ARCTIC, **ARCTIC_PARITY))
    memory.append(memory_line("lm_parity", device))
    rows = phase_times(device, convs)
    latency = [phase_latency(main_run["session"], device, IMAGE, b, it)
               for b, it in ((1, 20), (BIG_BATCH, 10))]
    profile = phase_profile(main_run["session"], device, IMAGE)
    lm_rows = phase_lm_kernel_times(device)
    lm_e2e = [phase_lm_e2e(lm_runs[m], device) for m in LM_MODELS]
    memory.append(memory_line("times", device))
    zoo = []
    for m, image in ZOO:
        run = phase_main(device, image, requests=ZOO_REQUESTS,
                         big_batch=BIG_BATCH, model=m)
        t = phase_zoo_times(run.pop("session"), image, zoo_convs[m], device)
        zoo.append({"phase": "zoo", "model": m, "image": image, "card": smi,
                    "conv_nodes": run["conv_nodes"],
                    "launches": run["launches"],
                    "max_logit_err_vs_cpu_rel":
                    run["max_logit_err_vs_cpu_rel"],
                    "big_batch_vs_cpu": run["big_batch_vs_cpu"], **t})
        emit({k: v for k, v in zoo[-1].items() if k != "b1_alone_ms_events"})
        del run, t
        gc.collect()
        torch.cuda.empty_cache()
        memory.append(memory_line(f"zoo {m}", device))
    tuning = phase_tuning(device, smi)
    memory.append(memory_line("tuning", device))
    kept = Path(tempfile.mkdtemp(prefix=".artifacts-", dir=ROOT))
    try:
        artifacts = phase_artifacts(device, main_run, lm_runs["mamba2-130m"],
                                    tuning, keep=kept / MODEL)
        memory.append(memory_line("artifacts", device))
        serving = phase_serving(device, smi, main_run,
                                lm_runs["mamba2-130m"], kept / MODEL)
    finally:
        shutil.rmtree(kept, ignore_errors=True)
    memory.append(memory_line("serving", device))
    # release every earlier session before arctic-480b's 55 GB of weights
    for run in [main_run, tuning, *lm_runs.values()]:
        run.pop("session")
        run.pop("big_session", None)
    gc.collect()
    torch.cuda.empty_cache()
    lm_runs[ARCTIC] = phase_lm_main(device, arctic_config())
    memory.append(memory_line(f"lm_main {ARCTIC}", device))
    lm_e2e.append(phase_lm_e2e(lm_runs[ARCTIC], device))
    memory.append(memory_line(f"lm_e2e {ARCTIC}", device))
    lm_runs[ARCTIC].pop("session")
    lm_runs[ARCTIC].pop("big_session")
    _release()
    a8 = phase_a8(device, memory)
    lm_e2e += a8["e2e"]

    def total(key, fallback):
        """Sum per batch-1 predict of each conv's ``key`` (a device time)
        times its count; ``fallback`` (events) where the profiler saw no
        device time."""
        return sum((r[key] if isinstance(r[key], float) else r[fallback])
                   * r["count"] for r in rows)

    t_op = TF32_PRODUCTS * sum(r["flop"] * r["count"] for r in rows) \
        / PEAK_TF32 * 1e3
    t_mem = sum(r["bytes"] * r["count"] for r in rows) / MEM_BW * 1e3
    # B1: the sum per batch-1 predict over the 53 convs, by the card's time
    kernels = [{"name": "conv2d_nchwc_sm90", "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": "src/repro/kernels/conv2d_nchwc.py:177",
                "launches": main_run["launches"],
                "max_abs_err": max(worst, zoo_worst),
                "ms": total("device_ms", "ms"),
                "plain_ms": sum(r["plain_ms"] * r["count"] for r in rows),
                "bound_ms": max(t_op, t_mem),
                "bound_by": "operations" if t_op >= t_mem else "bytes",
                "library_ms": total("library_device_ms", "library_ms"),
                "variant": "sm90: 3xTF32 implicit GEMM on wgmma",
                "ms_events": sum(r["ms"] * r["count"] for r in rows),
                "host_ms": sum(r["host_ms"] * r["count"] for r in rows),
                "fma_bound_ms": sum(r["fma_bound_ms"] * r["count"]
                                    for r in rows),
                "zoo_launches": {z["model"]: z["launches"] for z in zoo},
                "artifact_launches_per_predict":
                artifacts[0]["b1_launches_per_predict"],
                "serving_launches": serving["b1_launches"],
                "tuning_launches_per_predict": {
                    f"{t['model']} {t.get('mode', t['phase'])}":
                    t["b1_per_predict"] for t in tuning["lines"]
                    if "b1_per_predict" in t}}]
    # B2, B3 and B4: per prefill of the largest bucket (2,048 tokens at
    # batch 1), or for B2's splitk route per batch-1 decode step, i.e. one
    # launch per layer at that shape.  The kernels' times are the card's
    # own (from a profiler trace; CUDA events where it saw none), as is
    # B3's library call (SDPA); B2's library call is the one on its bf16
    # operands.
    for name, fn, route, model, source, replaces, row in LM_KERNEL_ROWS:
        run = lm_runs[model]
        n = run["n_layers"]
        r = lm_rows[fn][row]
        ms, lib = r["ms"], r["library_ms"]
        dev = r["device_ms"]
        ms = dev if isinstance(dev, float) else ms
        if route is not None:
            lib_dev = r.get("library_bf16_device_ms")
            lib = lib_dev if isinstance(lib_dev, float) else None
        elif isinstance(r.get("library_device_ms"), float):
            lib = r["library_device_ms"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": run["b2_launches_by_route"][route] if route
            else run["launches_by_kernel"][fn],
            "max_abs_err": lm_worst[fn][route] if route else lm_worst[fn],
            "ms": n * ms, "plain_ms": n * r["plain_ms"],
            "bound_ms": n * r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None if lib is None else n * lib})
        if name == "flash_attention":
            # the main path's B3 is the bf16 route; fp32 takes the FMA one.
            # Its launches on each LM path, and its times at the A8
            # families' shapes (the card's time a launch)
            kernels[-1].update(variant="sm90: wgmma + TMA, bf16",
                               ms_events=n * r["ms"],
                               library_ms_events=n * r["library_ms"])
            kernels[-1]["launches_by_path"] = {
                **{m: r["launches_by_kernel"]["flash_attention"]
                   for m, r in lm_runs.items()
                   if "flash_attention" in r["launches_by_kernel"]},
                **{r["model"]: r["launches"] for r in a8["main"]}}
            kernels[-1]["a8_shapes"] = [
                {k: x.get(k) for k in ("model", "shape", "sk", "causal",
                                       "window", "device_ms", "ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_device_ms")}
                for x in lm_rows["flash_attention"] if "model" in x]
        if name == "ssd_intra":
            kernels[-1].update(
                variant="sm90: 3xTF32 wgmma, C.B^T scores shared across "
                        "heads",
                ms_events=n * r["ms"], fma_bound_ms=n * r["fma_bound_ms"],
                artifact_launches_per_request=[
                    r["ssd_intra"] for r in artifacts[2]
                    ["launches_per_request"]],
                serving_stream_launches=serving["b4_stream_launches"])
    lm_main = [{k: v for k, v in r.items()
                if k not in ("session", "big_session")}
               for r in lm_runs.values()]
    result = {"card": smi, "build": build, "convs": rows,
              "main": {k: v for k, v in main_run.items() if k != "session"},
              "latency": latency, "profile": profile,
              "lm_main": lm_main, "lm_parity": parity, "a8": a8,
              "variants": variants,
              "lm_kernel_times": lm_rows, "lm_e2e": lm_e2e, "zoo": zoo,
              "tuning": tuning["lines"], "artifacts": artifacts,
              "serving": {k: serving[k] for k in (
                  "load", "chaos", "trace", "stream", "startup", "fleet")},
              "memory": memory, "kernels": kernels}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
