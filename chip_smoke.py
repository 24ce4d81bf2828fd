#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each a function of a device and a size:

1. build    — compile ``src/repro_torch/csrc/conv2d_nchwc.cu`` with nvcc for
              sm_90a and print ptxas's registers, shared memory and spills;
2. kernels  — the conv kernel against its plain PyTorch version on the card,
              on every distinct conv of ResNet-50's plan at batch 1 (its
              planned blocks and epilogues), a DenseNet-style concat-offset
              store and a ceil-mode avg-pool with asymmetric conv pads;
3. main     — ``compile("resnet-50", (1, 3, 224, 224))`` on the card answers
              8 batch-1 requests and one batch-8 request; every predict must
              launch the kernel once per conv_block, and the batch-1 output
              must match a CPU session of the same seed and plan;
4. times    — per conv: the kernel, its plain version, cuDNN's conv2d and
              the roofline bound, with CUDA events; end-to-end predict
              latency at batch 1 and 8 on the host clock; device time by
              kernel over batch-1 predicts from a ``torch.profiler`` trace.

It prints one JSON line per item, the card's ``nvidia-smi`` name and power
limit, the kernels' summary line, and as its last line
``{"ok": true, "device": {...}}``.  A failed phase raises and the script
exits non-zero; without a card, or outside a checkout of the repository, it
exits non-zero before printing any result.  Full results also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODEL, IMAGE, BIG_BATCH = "resnet-50", 224, 8
KERNEL_SOURCE = "src/repro_torch/csrc/conv2d_nchwc.cu"
PEAK_FP32 = 67e12          # H100 SXM fp32 FLOP/s outside the tensor cores
MEM_BW = 3.35e12           # H100 SXM device-memory bytes/s
# kernel vs plain on one card: fp32 sums of up to 4,608 terms in another
# order, on outputs of order 1
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

def phase_build() -> dict:
    from repro_torch.kernels import conv2d_nchwc as k

    info = k.build()
    ptxas = info["ptxas"]
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", ptxas)]
    smem = [int(m) for m in re.findall(r"(\d+) bytes smem", ptxas)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", ptxas)]
    out = {"phase": "build", "source": KERNEL_SOURCE,
           "seconds": info["seconds"], "registers": max(regs, default=None),
           "smem_bytes": max(smem, default=0),
           "spill_store_bytes": max(spills, default=0),
           "ptxas": [ln.strip() for ln in ptxas.splitlines() if ln.strip()]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# 2. kernels: each distinct conv of the plan, kernel vs plain
# ---------------------------------------------------------------------------

def plan_convs(model: str, batch: int, image: int) -> list:
    """Distinct (workload, ic_bn, oc_bn) of the port's plan, with their
    multiplicity in one predict."""
    from repro_torch.core.pipeline import Pipeline, make_workload
    from repro_torch.models.cnn import build

    graph, shapes = build(model, batch=batch, image=image)
    planned = Pipeline.preset("fusion").run(graph, shapes).planned
    convs: dict = {}
    for node in planned.graph.topo_order():
        if node.op != "conv_block":
            continue
        s = planned.schedules[node.name]
        wl = make_workload(node, planned.graph.nodes[node.inputs[0]].shape)
        key = (wl, s.ic_bn, s.oc_bn)
        convs.setdefault(key, {"wl": wl, "ic_bn": s.ic_bn, "oc_bn": s.oc_bn,
                               "count": 0})["count"] += 1
    return list(convs.values())


def make_case(wl, ic_bn: int, oc_bn: int, device, seed: int = 0) -> dict:
    """Random operands of one conv_block launch, blocked as the plan has
    them.  The concat buffer is random so the copy-through is checked."""
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
    shift = t(rng.normal(0, 0.1, size=(cout,)))
    case = {
        "spec": spec, "stride": wl.stride, "pad": (wl.pad, wl.pw),
        "x_nchw": x, "w_kcrs": w, "shift_vec": shift,
        "x": pad_blocked(to_nchwc(x, ic_bn), (wl.pad, wl.pw)),
        "w": kernel_to_kcrs_ck(w, ic_bn, oc_bn),
        "scale": None,
        "shift": shift.reshape(-1, oc_bn).contiguous(),
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
    return c.get("name", name)


def phase_kernels(device, convs: list) -> float:
    """Kernel vs plain on every case; returns the largest abs error."""
    worst = 0.0
    for c in convs:
        case = make_case(c["wl"], c["ic_bn"], c["oc_bn"], device)
        got = run_case(case, plain=False)
        want = run_case(case, plain=True)
        torch.cuda.synchronize(device)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{wl_name(c)}: non-finite kernel output")
        err = float((got - want).abs().max())
        emit({"phase": "kernel_vs_plain", "case": wl_name(c),
              "max_abs_err": err, **KERNEL_TOL})
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# 3. main path
# ---------------------------------------------------------------------------

def phase_main(device, image: int = 224, requests: int = 8,
               big_batch: int = 8, model: str = "resnet-50",
               seed: int = 0) -> dict:
    """The user's path: compile, then answer ``requests`` batch-1 requests
    and one ``big_batch`` request.  Every predict on a CUDA device must
    launch the conv kernel once per conv_block.  The batch-1 outputs must
    match a CPU session of the same seed, whose plan must be the same."""
    from repro_torch.engine import CompiledModel, compile
    from repro_torch.engine.session import _plan_to_json
    from repro_torch.kernels.conv2d_nchwc import conv2d_nchwc

    rng = np.random.default_rng(seed + 1)
    xs = [rng.normal(size=(1, 3, image, image)).astype(np.float32)
          for _ in range(requests)]
    x_big = rng.normal(size=(big_batch, 3, image, image)).astype(np.float32)
    on_card = torch.device(device).type == "cuda"

    conv2d_nchwc.launches = 0
    t0 = time.perf_counter()
    session = compile(model, (1, 3, image, image), seed=seed, device=device)
    compile_s = time.perf_counter() - t0
    n_blocks = sum(1 for n in session.plan_for(1).planned.graph.topo_order()
                   if n.op == "conv_block")
    outs, per_predict = [], []
    for x in xs + [x_big]:
        before = conv2d_nchwc.launches
        y = session.predict(torch.from_numpy(x).to(device))
        if on_card:
            torch.cuda.synchronize(device)
        per_predict.append(conv2d_nchwc.launches - before)
        outs.append(y.cpu().numpy())
    launches = conv2d_nchwc.launches

    want_launches = n_blocks if on_card else 0
    if any(n != want_launches for n in per_predict):
        raise RuntimeError(f"kernel launches per predict {per_predict}, "
                           f"expected {want_launches} each")
    for x, y in zip(xs + [x_big], outs):
        if y.shape != (x.shape[0], 1000) or not np.isfinite(y).all():
            raise RuntimeError(f"bad output: shape {y.shape}, "
                               f"finite {np.isfinite(y).all()}")
        np.testing.assert_allclose(y.sum(axis=1), 1.0, rtol=1e-5, atol=1e-5)

    ref = compile(model, (1, 3, image, image), seed=seed, device="cpu")
    plans = [_plan_to_json(s.plan_for(1)) for s in (session, ref)]
    for p in plans:
        p.pop("report")
    if plans[0] != plans[1]:
        raise RuntimeError("the card's plan differs from the CPU session's")

    def with_logits(m):
        """The same plan and bound weights, with the classifier's logits
        as a second output."""
        plan = copy.deepcopy(m.plan)
        plan.planned.graph.mark_output("fc")
        return CompiledModel(plan=plan, params=m.params)

    card, cpu = with_logits(session.specialize(1)), \
        with_logits(ref.specialize(1))
    errs, logit_errs = [], []
    for x, y in zip(xs, outs):
        want, want_logits = (t.numpy() for t in cpu.predict(
            torch.from_numpy(x)))
        logits = card.predict(torch.from_numpy(x).to(device))[1].cpu().numpy()
        np.testing.assert_allclose(y, want, **E2E_TOL)
        scale = float(np.abs(want_logits).max())
        np.testing.assert_allclose(logits, want_logits, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL * scale)
        if y.argmax() != want.argmax():
            raise RuntimeError("top-1 class differs from the CPU session")
        errs.append(float(np.abs(y - want).max()))
        logit_errs.append(float(np.abs(logits - want_logits).max()) / scale)
    out = {"phase": "main", "model": model, "image": image,
           "requests": [1] * requests + [big_batch],
           "conv_blocks": n_blocks, "launches": launches,
           "launches_per_predict": per_predict, "compile_s": compile_s,
           "max_abs_err_vs_cpu": max(errs),
           "max_logit_err_vs_cpu_rel": max(logit_errs), **E2E_TOL,
           "logit_tol_rel": LOGIT_TOL}
    emit(out)
    return {"session": session, **out}


# ---------------------------------------------------------------------------
# 4. times
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


def roofline(case, out: torch.Tensor, wl) -> dict:
    """The least time of one launch: the larger of its FLOP over the fp32
    peak and its bytes (each operand read once, the output written once)
    over the memory rate."""
    flop = wl.flops
    nbytes = 4 * (out.numel() + sum(
        case[k].numel() for k in ("x", "w", "scale", "shift", "residual",
                                  "out_buf") if case[k] is not None))
    t_op, t_mem = flop / PEAK_FP32 * 1e3, nbytes / MEM_BW * 1e3
    return {"flop": flop, "bytes": nbytes, "bound_ms": max(t_op, t_mem),
            "bound_by": "operations" if t_op >= t_mem else "bytes"}


def phase_times(device, convs: list, iters: int = 20) -> list:
    import torch.nn.functional as F

    rows = []
    for c in convs:
        case = make_case(c["wl"], c["ic_bn"], c["oc_bn"], device)
        out = run_case(case, plain=False)

        def lib():
            return F.conv2d(case["x_nchw"], case["w_kcrs"], case["shift_vec"],
                            stride=case["stride"], padding=case["pad"])

        row = {"phase": "times", "case": wl_name(c), "count": c["count"],
               "ms": cuda_ms(lambda: run_case(case, plain=False), iters),
               "plain_ms": cuda_ms(lambda: run_case(case, plain=True), iters),
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
    """Device time by kernel name over batch-1 predicts, from a
    ``torch.profiler`` trace: what share of a predict each kernel takes and
    how long the card idles.  The profiler's own host cost inflates the
    wall time here, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 3, image, image)).astype(np.float32)).to(device)
    session.predict(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            session.predict(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / iters)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"phase": "profile", "batch": 1, "iters": iters,
           "wall_ms_per_predict": wall_ms,
           "device_ms_per_predict": busy if by_name else "not measured",
           "idle_share": 1 - busy / wall_ms if by_name else "not measured",
           "top_ms_per_predict": [[name[:80], ms] for name, ms in top]}
    emit(out)
    return out


# ---------------------------------------------------------------------------

def main() -> int:
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

    build = phase_build()
    convs = plan_convs(MODEL, 1, IMAGE)
    if sum(c["count"] for c in convs) == 0:
        raise RuntimeError("the plan has no conv_block")
    worst = phase_kernels(device, convs + extra_cases())
    main_run = phase_main(device, IMAGE, big_batch=BIG_BATCH, model=MODEL)
    rows = phase_times(device, convs)
    latency = [phase_latency(main_run["session"], device, IMAGE, b, it)
               for b, it in ((1, 20), (BIG_BATCH, 10))]
    profile = phase_profile(main_run["session"], device, IMAGE)

    def total(key):
        return sum(r[key] * r["count"] for r in rows)

    t_op = sum(r["flop"] * r["count"] for r in rows) / PEAK_FP32 * 1e3
    t_mem = sum(r["bytes"] * r["count"] for r in rows) / MEM_BW * 1e3
    kernel = {"name": "conv2d_nchwc", "route": "cuda",
              "source": KERNEL_SOURCE,
              "replaces": "src/repro/kernels/conv2d_nchwc.py:177",
              "launches": main_run["launches"], "max_abs_err": worst,
              "ms": total("ms"), "plain_ms": total("plain_ms"),
              "bound_ms": total("bound_ms"),
              "bound_by": "operations" if t_op >= t_mem else "bytes",
              "library_ms": total("library_ms")}
    result = {"card": smi, "build": build, "convs": rows,
              "main": {k: v for k, v in main_run.items() if k != "session"},
              "latency": latency, "profile": profile, "kernels": [kernel]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    print(smi, flush=True)
    emit({"kernels": [kernel]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
