"""One run of one cell: set-up, the measured window, the traced span
(``--trace 1``), then the check against the plain reference.

Set-up (``setup_s``, from the process's start to the window's): the
device's context, the weights and inputs drawn on the device from the
seed, ``compile`` of the cell's buckets (the planner runs: no plan is
cached), B1's build check, and a short warm run of the cell's own loop,
so that nothing builds or compiles inside the window.  After the window
the peak device memory is read, the program's state is freed, and the
reference runs on the same parameters and inputs.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional

import torch

from perfbench import reference as references
from perfbench.harness import compare, loops, spec
from perfbench.harness.costs import Costs
from perfbench.harness.profiling import HostSpans, retaken, warm_profiler
from perfbench.harness.weights import draw_images, draw_params, generator
from perfbench.traffic.generator import arrivals

TRACE_S = 2.0                 # the traced span after the window
TRACE_MARGIN_S = 20.0         # traffic offered past a span, for its
                              # takes; never all sent
SETTLE_S = 1.0                # traffic before a served span opens
WARM_S = 0.5                  # the warm run of the cell's loop


@dataclasses.dataclass
class Run:
    cell: spec.Cell
    window: loops.Window
    trace: Optional[dict]
    costs: Costs


def _pool(cell: spec.Cell, g, device) -> List[torch.Tensor]:
    """The inputs: ``pool`` entries of ``batch`` images, on the host
    (pinned where the device is a card)."""
    t = cell.traffic
    image = cell.config["image"]
    batch = t.get("batch", 1)
    x = draw_images(t["pool"] * batch, image, g, device)
    host = x.cpu()
    if device.type == "cuda":
        host = host.pin_memory()
    return list(host.split(batch))


def _session(cell: spec.Cell, params, device):
    from repro_torch.engine.session import compile

    cfg = cell.config
    buckets = sorted(cell.workload.get("buckets",
                                       [cell.traffic.get("batch", 1)]))
    session = compile(cfg["zoo"], (buckets[-1], 3, cfg["image"],
                                   cfg["image"]),
                      params=params, device=str(device))
    for b in buckets:
        session.specialize(b)
    return session, buckets


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _drive(cell, session, buckets, pool, device, seed, seconds, spans,
           trace: bool):
    """The window (and the traced span) of the cell's loop."""
    t = cell.traffic
    loop = t["loop"]
    if loop in ("offline", "closed"):
        def go(s, lead=0):
            if loop == "offline":
                return loops.offline(session, pool, s, device,
                                     t["in_flight"], spans, lead)
            return loops.closed(session, pool, s, device, spans, lead)

        go(WARM_S)
        _sync(device)
        yield "window"
        window = go(seconds)
        traced = None
        if trace:
            warm_profiler()
            tw = retaken(lambda lead: go(TRACE_S, lead))
            traced = tw.trace
            traced["batches"] = tw.batches
        yield window, traced
        return
    if loop != "open":
        raise ValueError(f"unknown loop {loop!r}")
    from repro_torch.engine.serving import AsyncServer, DynamicBatchPolicy

    w = cell.workload
    rate = float(w["rate"])

    def due(s, k):
        return [d for d, _rows in arrivals(t, rate, s, seed + k)]

    server = AsyncServer(session, DynamicBatchPolicy(**w["policy"]),
                         max_queue=int(rate * (seconds + TRACE_MARGIN_S)),
                         workers=w.get("workers", 1))
    try:
        loops.open_loop(server, pool, due(WARM_S, 1), WARM_S, buckets, spans)
        _sync(device)
        yield "window"
        window = loops.open_loop(server, pool, due(seconds, 0), seconds,
                                 buckets, spans)
        traced = None
        if trace:
            # the profiler's first start with the server idle (under a
            # worker's launches it recorded no kernel), then traffic
            # again, and the span once it has settled
            _sync(device)
            warm_profiler()
            traced = loops.open_loop(
                server, pool, due(SETTLE_S + TRACE_MARGIN_S, 2), SETTLE_S,
                buckets, spans, TRACE_S).trace
        yield window, traced
    finally:
        server.close(drain=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: Optional[float] = None,
             overrides: Optional[Dict[str, dict]] = None,
             entry: Optional[dict] = None) -> dict:
    """The result of one run (the keys the driver reads, then ``checks``),
    with ``notes`` for the line before it (``spec.resolve`` takes
    ``overrides`` and ``entry``)."""
    t_start = time.time() if t_process is None else t_process
    marks = {"start": time.time()}
    cell = spec.resolve(name, overrides=overrides, entry=entry)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        marks["context"] = time.time()
    cfg = cell.config
    ref = references.load(cfg["reference"])
    args = dict(cfg.get("reference_args", {}))
    specs = ref.param_specs(image=cfg["image"], classes=cfg["classes"],
                            **args)
    g = generator(seed, dev)
    params = draw_params(specs, cfg["weights"], g, dev)
    pool = _pool(cell, g, dev)
    _sync(dev)
    marks["draws"] = time.time()
    session, buckets = _session(cell, params, dev)
    marks["compile"] = time.time()
    spans = HostSpans()
    steps = _drive(cell, session, buckets, pool, dev, seed, seconds, spans,
                   trace)
    next(steps)                                   # set-up and warm run done
    marks["warm"] = time.time()
    setup_s = marks["warm"] - t_start
    window, traced = next(steps)
    steps.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del steps, session
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = compare.reference_outputs(ref, params, pool, args, dev)
    gap = compare.logprob_gap(window.outputs, want)
    limit = float(cell.workload["limits"]["logprob_gap"])
    checks = {"logprob_gap": {"value": gap, "limit": limit},
              "failed": {"value": window.failed, "limit": 0}}
    correct = (math.isfinite(gap) and gap <= limit and window.failed == 0
               and window.attempted > 0)
    ref_s = time.perf_counter() - t_ref

    run = Run(cell=cell, window=window, trace=traced,
              costs=Costs(ref, specs, cfg["image"], args))
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**window.e2e, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(correct), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": device_info(dev, peak, traced)}
    if traced:
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = checks
    split, last = {}, t_start
    for step, t in marks.items():
        split[step] = t - last
        last = t
    notes = {"cell": name, "seed": seed, "setup_s": setup_s,
             "setup_split_s": split,
             "window_s": window.seconds, "images": window.images,
             "compared_outputs": len(window.outputs),
             "reference_s": ref_s, **window.notes}
    if window.serving:
        notes["serving"] = window.serving
    if traced:
        notes["trace"] = {k: v for k, v in traced.items()
                          if k not in ("device_ops", "idle_gaps",
                                       "device_s_by_name")}
    return {"result": result, "notes": notes}


def device_info(dev: torch.device, peak: int, traced: Optional[dict]
                ) -> dict:
    if dev.type != "cuda":
        info = {"platform": dev.type, "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        info["busy_s"] = traced["busy_s"]
        info["window_s"] = traced["window_s"]
    return info
