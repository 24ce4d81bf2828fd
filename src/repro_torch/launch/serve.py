"""Serving driver: batched prefill + decode loop, or a saved artifact behind
the async dynamic-batching server — the port of the reference's
``repro/launch/serve.py``.

With ``--arch`` it greedy-decodes a batch of synthetic prompts with the
reduced config of one of the ten ``ARCHS`` (as the reference does), its
weights drawn from seed 0 on ``--device``: the model's ``prefill`` and
``decode_step`` run eagerly (the reference ``jit``s them), so on the card
every prefill attention launches B3, every Mamba-2 intra-chunk block B4 and
every MoE router B2.

``--artifact <dir>`` instead serves from a saved artifact with zero
schedule search and zero weight transformation — the fast-cold-start
path.  The manifest routes the workload family: CNN ``InferenceSession``
artifacts go load -> predict through the dynamic-batching driver, LM
artifacts (manifest ``lm`` section, built with
``engine.compile(<LM config>, ...).save(dir)``) go load -> prewarm ->
``submit_stream`` with seq-bucketed prefill and streamed greedy decode.
Artifacts of either package load.

Everything runs on ``--device`` (default ``cuda``); with no card there it
raises rather than fall back to the CPU, which ``--device cpu`` asks for
(the kernels' plain versions).  ``--workers N`` runs N driver workers over
one queue (each on its own CUDA stream), and ``--pin-workers`` gives each
worker its own CPU affinity set.  ``--devices D`` is checked against the
visible cards (``launch.cpu.check_devices``) and reaches the session: a CNN
artifact is loaded re-targeted to D devices (batch-sharded over
``cuda:0`` to ``cuda:D-1``, or D shards in turn on the CPU), and without
it at the count it was saved at.  The allocator env preset
(``launch.cpu.apply_serving_env``: tcmalloc LD_PRELOAD detection, alloc-
report hygiene — warn, never fail) is applied on every serve.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --artifact artifact/ \
        --requests 50 --workers 2 --pin-workers
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen2-1.5b --batch 2 --prompt-len 8 --gen 4
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced as make_reduced
from repro_torch.launch.cpu import apply_serving_env, check_devices
from repro_torch.models.lm import model

__all__ = ["arch_inputs", "greedy_generate", "main", "serve_artifact",
           "serve_lm_artifact"]


def _sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pace(t_arrival: float, t0: float) -> None:
    """Sleep until ``t_arrival`` seconds after ``t0`` (a
    ``time.perf_counter`` reading), if that is still ahead.  The clock is
    read once: read again for the sleep's length, it may already have
    passed the arrival, and ``time.sleep`` refuses a negative length."""
    left = t_arrival - (time.perf_counter() - t0)
    if left > 0:
        time.sleep(left)


def serve_artifact(path: str, n_requests: int, *, max_batch: int = 8,
                   max_wait_ms: float = 2.0, max_queue: int = 64,
                   deadline_ms: float = None, workers: int = 1,
                   pin=None, shed: str = "newest",
                   retry_budget: int = 2, backoff_ms: float = 10.0,
                   watchdog_ms: float = None, show_health: bool = False,
                   dtype: str = None, trace: str = "uniform",
                   priority_default: str = "standard",
                   buckets: str = None, stats_interval: float = None,
                   device="cuda", devices: Optional[int] = None):
    """Cold-start CNN serving through the async dynamic-batching driver:
    load the compiled session artifact onto ``device``, pump a stream of
    single-image requests through a bounded queue (client-side
    backpressure on ``QueueFullError``), and drain gracefully on shutdown.
    The driver packs requests into the artifact's specialized batch sizes,
    so the whole run stays at zero schedule searches; ``workers > 1``
    executes batches concurrently, each worker on its own CUDA stream.
    Returns the last request's output.

    Fault-tolerance knobs map straight onto ``AsyncServer``: ``shed``
    picks the overload policy, ``retry_budget``/``backoff_ms`` configure
    crash-recovery retries, ``watchdog_ms`` arms the hung-batch watchdog
    (set it well above a worst-case batch — buckets are pre-warmed here,
    so the kernels' first build cannot trip it).

    Traffic-aware knobs: ``trace`` replays a synthetic arrival shape
    (``engine.traffic.synth_trace`` kinds — "uniform" keeps the legacy
    back-to-back single-image stream), ``priority_default`` classes
    unlabeled requests, ``buckets="auto"`` re-saves the artifact after
    the run with the bucket set solved from the *measured* arrival
    histogram, and ``stats_interval`` prints live telemetry snapshots
    from a daemon thread while the stream is in flight.

    ``devices`` re-targets the artifact to that many devices (its source
    packed), its saved buckets planned again at load; None keeps the
    count it was saved at."""
    apply_serving_env()
    check_devices(devices or 1, device)
    from repro_torch.core.local_search import search_calls
    from repro_torch.engine import (AsyncServer, DynamicBatchPolicy,
                                    InferenceSession, QueueFullError,
                                    RetryPolicy, expected_padded_waste,
                                    synth_trace)

    if n_requests < 1:
        raise ValueError(f"--requests must be >= 1, got {n_requests}")
    t0 = time.perf_counter()
    sess = InferenceSession.load(path, device=device, devices=devices)
    if not sess.batch_sizes:
        # re-targeted to another device count: the saved buckets (each
        # rounded up to a multiple of it) are planned again from the
        # packed source as part of the load; serving then searches nothing
        saved = json.loads((Path(path) / "manifest.json").read_text())
        for b in sorted({-(-int(b) // sess.devices) * sess.devices
                         for b in saved["specializations"]}):
            sess.specialize(b)
    t_load = time.perf_counter() - t0
    n_searches = search_calls()
    if dtype is not None and sess.dtype != dtype:
        raise ValueError(
            f"--dtype {dtype} requested but artifact {path} was compiled "
            f"at {sess.dtype} precision; rebuild it with "
            f"engine.compile(..., dtype={dtype!r}).save(...)")
    (name,) = sess.input_spec
    shape = (1,) + sess.input_spec[name][1:]
    rng = np.random.default_rng(0)

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.float32)).to(sess.device)

    if trace == "uniform":
        reqs = [None] * n_requests           # legacy back-to-back stream
        xs = [on_device(rng.normal(size=shape)) for _ in range(n_requests)]
    else:
        # replay a synthetic arrival process: sized requests, paced
        # submits, mixed priority classes (sizes clamped to what the
        # artifact can pack so frozen sessions never see a typed reject)
        max_rows = min(max_batch, max(sess.batch_sizes))
        reqs = synth_trace(trace, n=n_requests, seed=0, mean_rate=100.0,
                           max_rows=max_rows,
                           priorities=("interactive", "standard", "batch"))
        xs = [on_device(rng.normal(size=(r.rows,) + shape[1:]))
              for r in reqs]
    for b in sess.batch_sizes:       # server startup: warm every bucket
        sess.specialize(b).predict(torch.zeros((b,) + shape[1:],
                                               device=sess.device))
        _sync(sess.device)

    policy = DynamicBatchPolicy(max_batch=max_batch,
                                max_wait_ms=max_wait_ms,
                                order="fifo" if trace == "uniform"
                                else "edf")
    server = AsyncServer(sess, policy, max_queue=max_queue,
                         workers=workers, pin=pin, shed=shed,
                         retry=RetryPolicy(budget=retry_budget,
                                           backoff_ms=backoff_ms),
                         watchdog_ms=watchdog_ms,
                         priority_default=priority_default)
    stop_stats = None
    if stats_interval is not None:
        import threading

        stop_stats = threading.Event()

        def _report():
            while not stop_stats.wait(stats_interval):
                s = server.stats
                print(f"[stats] queued={len(server)} "
                      f"completed={s.n_completed} batches={s.n_batches} "
                      f"p50={s.percentile_ms(50):.1f} "
                      f"p99={s.percentile_ms(99):.1f} ms")

        threading.Thread(target=_report, daemon=True,
                         name="serve-stats").start()
    t_serve0 = time.perf_counter()
    futures = []
    n_retries = 0
    try:
        for req, x in zip(reqs, xs):
            if req is not None:
                _pace(req.t, t_serve0)
            while True:
                try:
                    futures.append(server.submit(
                        x, deadline_ms=deadline_ms,
                        priority=req.priority if req is not None
                        else None))
                    break
                except QueueFullError:
                    # backpressure: wait for the newest outstanding result
                    # (FIFO — once it lands the queue has drained) instead
                    # of growing the queue without bound
                    n_retries += 1
                    futures[-1].result()
        out = None
        for f in futures:
            out = f.result()
        if show_health:
            import json as _json
            print("health:", _json.dumps(server.health(), indent=2))
    finally:
        if stop_stats is not None:
            stop_stats.set()
        server.close(drain=True)                  # graceful shutdown
    t_serve = time.perf_counter() - t_serve0
    if search_calls() != n_searches:
        raise RuntimeError("artifact serving must not re-run any schedule "
                           "search")
    st = server.stats
    print(f"artifact={path} model={sess.model_name or '?'} "
          f"dtype={sess.dtype} "
          f"load={t_load * 1e3:.0f} ms (zero search, zero re-binding) "
          f"buckets={sess.batch_sizes} devices={sess.devices} "
          f"device={sess.device} "
          f"workers={workers}")
    print(f"served {st.n_completed}/{n_requests} requests in "
          f"{st.n_batches} batches "
          f"(mean {st.rows_executed / max(st.n_batches, 1):.1f} rows, "
          f"{st.rows_padded} padded rows, {n_retries} backpressure waits): "
          f"{n_requests / t_serve:.1f} req/s  "
          f"p50={st.percentile_ms(50):.1f} "
          f"p90={st.percentile_ms(90):.1f} "
          f"p99={st.percentile_ms(99):.1f} ms")
    if trace != "uniform":
        per_class = {cls: round(q.percentile(99) * 1e3, 1)
                     for cls, q in sorted(st.latency_by_class.items())}
        print(f"trace={trace} per-class p99 (ms): {per_class}")
    if buckets == "auto":
        # close the measured-traffic loop: re-save the artifact with the
        # bucket set solved from what this run actually observed
        from repro_torch.engine import solve_buckets

        hist = st.arrival_hist.counts()
        old = sorted(sess.batch_sizes)
        try:
            learned = solve_buckets(hist, devices=sess.devices)
            sess.save(path, buckets="auto", traffic=st.arrival_hist)
        except RuntimeError as e:
            print(f"--buckets auto skipped: {e} (save the artifact with "
                  "include_source=True to make its bucket set learnable)")
        else:
            print(f"re-saved {path} with learned buckets {learned}: "
                  f"expected padded waste "
                  f"{expected_padded_waste(hist, learned)} rows vs "
                  f"{expected_padded_waste(hist, old)} with the previous "
                  f"set {old}, on the measured histogram "
                  f"{dict(sorted(hist.items()))}")
    return out


def serve_lm_artifact(path: str, n_requests: int, *, gen: int = 8,
                      max_queue: int = 64, deadline_ms: float = None,
                      retry_budget: int = 2, backoff_ms: float = 10.0,
                      watchdog_ms: float = None, show_health: bool = False,
                      priority_default: str = "standard", device="cuda",
                      devices: Optional[int] = None):
    """Cold-start LM serving: load the seq-bucketed ``LMSession``
    artifact onto ``device``, prewarm every prefill bucket + the decode
    step, then stream ``n_requests`` greedy generations through
    ``submit_stream`` — each prompt prefills the largest bucket <= its
    length, catches up through decode, and its tokens arrive on a
    :class:`TokenStream` as the worker produces them.  The whole run is
    zero schedule searches (checked), mirroring the CNN cold-start path.
    ``devices`` is checked against the visible cards; an LM session is
    not batch-sharded and runs on the first.  Returns the count of
    completed generations."""
    apply_serving_env()
    check_devices(devices or 1, device)
    from repro_torch.core.local_search import search_calls
    from repro_torch.engine import (AsyncServer, DynamicBatchPolicy,
                                    LMSession, QueueFullError, RetryPolicy)

    if n_requests < 1:
        raise ValueError(f"--requests must be >= 1, got {n_requests}")
    n_searches = search_calls()
    t0 = time.perf_counter()
    sess = LMSession.load(path, device=device)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.prewarm()                      # build the kernels, run each bucket
    t_warm = time.perf_counter() - t0
    max_prompt = sess.max_len - gen + 1
    if max_prompt < 1:
        raise ValueError(f"--gen {gen} does not fit the artifact's "
                         f"max_len={sess.max_len}; lower it")
    rng = np.random.default_rng(0)
    lens = rng.integers(1, max_prompt + 1, size=n_requests)
    prompts = [torch.from_numpy(rng.integers(
        0, sess.cfg.vocab, size=(sess.batch, int(n)))).to(sess.device)
        for n in lens]
    # streams execute alone, so the packing knobs are moot — keep the
    # queue/deadline/retry/watchdog machinery identical to CNN serving
    server = AsyncServer(sess, DynamicBatchPolicy(max_batch=1,
                                                  max_wait_ms=1.0),
                         max_queue=max_queue,
                         retry=RetryPolicy(budget=retry_budget,
                                           backoff_ms=backoff_ms),
                         watchdog_ms=watchdog_ms,
                         priority_default=priority_default)
    t_serve0 = time.perf_counter()
    streams = []
    n_retries = 0
    n_tokens = 0
    t_first = None
    try:
        for x in prompts:
            while True:
                try:
                    streams.append(server.submit_stream(
                        x, gen, deadline_ms=deadline_ms))
                    break
                except QueueFullError:
                    n_retries += 1
                    for _ in streams[-1]:
                        pass
        for s in streams:
            for tok in s:                 # tokens arrive per decode step
                if t_first is None:
                    t_first = time.perf_counter() - t_serve0
                n_tokens += tok.shape[-1] if hasattr(tok, "shape") else 1
        if show_health:
            import json as _json
            print("health:", _json.dumps(server.health(), indent=2))
    finally:
        server.close(drain=True)
    t_serve = time.perf_counter() - t_serve0
    if search_calls() != n_searches:
        raise RuntimeError("LM artifact serving must not re-run any "
                           "schedule search")
    st = server.stats
    print(f"artifact={path} model={sess.model_name or sess.cfg.name} "
          f"family={sess.cfg.family} load={t_load * 1e3:.0f} ms "
          f"prewarm={t_warm * 1e3:.0f} ms (zero search) "
          f"seq_buckets={sess.seq_buckets} max_len={sess.max_len} "
          f"batch={sess.batch} device={sess.device}")
    print(f"streamed {st.n_completed}/{n_requests} generations "
          f"({n_tokens} decode steps, first token "
          f"{(t_first or 0) * 1e3:.0f} ms, {n_retries} backpressure "
          f"waits): {n_tokens / max(t_serve, 1e-9):.1f} tok/s  "
          f"p50={st.percentile_ms(50):.1f} "
          f"p99={st.percentile_ms(99):.1f} ms/generation")
    return st.n_completed


def _artifact_is_lm(path: str) -> bool:
    """Peek the manifest to route ``--artifact`` without deserializing
    anything: LM artifacts carry a populated ``lm`` section."""
    import json
    from pathlib import Path
    manifest = Path(path) / "manifest.json"
    if not manifest.is_file():
        return False
    try:
        return bool(json.loads(manifest.read_text()).get("lm"))
    except (OSError, ValueError):
        return False


def arch_inputs(cfg, batch: int, prompt_len: int, device):
    """The ``--arch`` path's synthetic inputs, drawn on the host from
    ``default_rng(0)`` as the reference draws them: the (batch,
    prompt_len) prompts, then a vlm's image embeddings or an encdec's
    frame embeddings (fp32), all moved to ``device``.  Returns
    ``(prompts, extra)``."""
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(batch, prompt_len))).to(device)
    extra = {}
    if cfg.family == "vlm":
        extra["img_embeds"] = rng.normal(
            size=(batch, cfg.n_img_tokens, cfg.d_model))
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            size=(batch, cfg.enc_positions, cfg.d_model))
    return prompts, {k: torch.from_numpy(v.astype(np.float32)).to(device)
                     for k, v in extra.items()}


def greedy_generate(params, cfg, prompts: torch.Tensor, gen: int, *,
                    pick: Optional[Callable[[int, torch.Tensor],
                                            torch.Tensor]] = None,
                    **extra):
    """The ``--arch`` loop: prefill ``prompts`` (B, prompt_len) integers on
    the parameters' device (a vlm's ``img_embeds`` and an encdec's
    ``frames`` in ``extra``) into a cache of ``prompt_len + gen +
    n_img_tokens`` positions, then greedy-decode ``gen - 1`` more steps.
    ``pick(step, logits)``, if given, chooses each step's (B,) tokens from
    its (B, vocab) logits in place of the argmax (to read the logits, or
    to feed back tokens of another run).  Returns ``(tokens, prefill_s,
    decode_s)``: the (B, gen) int32 tokens on the parameters' device and
    the seconds of the prefill and of the decode loop."""
    device = prompts.device
    prompt_len = prompts.shape[1]
    max_len = prompt_len + gen + cfg.n_img_tokens

    def choose(step: int, logits: torch.Tensor) -> torch.Tensor:
        tok = (torch.argmax(logits, dim=-1) if pick is None
               else pick(step, logits).to(device))
        return tok[:, None].to(torch.long)

    t0 = time.perf_counter()
    cache, logits = model.prefill(params, cfg, prompts, max_len=max_len,
                                  **extra)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = choose(0, logits)
    out_tokens = [tok]
    pos0 = prompt_len + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode_step(params, cfg, tok, cache, pos0 + i)
        tok = choose(i + 1, logits)
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return (torch.cat(out_tokens, dim=1).to(torch.int32), t_prefill,
            t_decode)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--artifact", default=None,
                    help="serve a saved artifact through the async "
                         "driver (zero search): CNN InferenceSession "
                         "artifacts get dynamic batching, LM artifacts "
                         "(manifest 'lm' section) get seq-bucketed "
                         "prefill + streamed decode; routed "
                         "automatically from the manifest")
    ap.add_argument("--requests", type=int, default=20,
                    help="request count for --artifact serving")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="driver packing limit (rows per executed batch)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="flush a partial batch after this queue age")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="bounded queue capacity (backpressure beyond it)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; queued past it fails typed")
    ap.add_argument("--devices", type=int, default=None,
                    help="devices one CNN session is batch-sharded over, "
                         "checked against the visible cards (default: the "
                         "count the artifact was saved at)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs: 'cuda' (default) launches "
                         "the hand-written kernels and raises without a "
                         "card; 'cpu' runs their plain versions")
    ap.add_argument("--workers", type=int, default=1,
                    help="driver worker threads (each on its own CUDA "
                         "stream) behind one queue")
    ap.add_argument("--pin-workers", action="store_true",
                    help="pin each worker thread to its own CPU set")
    ap.add_argument("--shed", default="newest",
                    choices=("newest", "oldest", "deadline"),
                    help="overload policy when the queue is full: reject "
                         "the newcomer, shed the oldest queued request, or "
                         "shed the queued request closest to its deadline")
    ap.add_argument("--retry-budget", type=int, default=2,
                    help="re-executions a request may get after a worker "
                         "crash or failed batch (0 disables retries)")
    ap.add_argument("--backoff-ms", type=float, default=10.0,
                    help="initial retry backoff (doubles per attempt, "
                         "capped at 1 s)")
    ap.add_argument("--watchdog-ms", type=float, default=None,
                    help="hung-batch watchdog: a worker silent this long "
                         "while holding a batch is restarted and its "
                         "batch requeued (off by default)")
    ap.add_argument("--trace", default="uniform",
                    choices=("uniform", "bursty", "diurnal", "heavytail"),
                    help="arrival shape for --artifact serving: 'uniform' "
                         "is the legacy back-to-back single-image stream; "
                         "the others replay a paced synthetic trace with "
                         "mixed request sizes and priority classes "
                         "(EDF packing)")
    ap.add_argument("--priority-default", default="standard",
                    choices=("interactive", "standard", "batch"),
                    help="priority class for requests submitted without "
                         "an explicit one")
    ap.add_argument("--buckets", default=None, choices=("auto",),
                    help="'auto' re-saves the artifact after the run with "
                         "the bucket set solved from the measured arrival "
                         "histogram (needs a source-packed artifact)")
    ap.add_argument("--stats-interval", type=float, default=None,
                    help="print live telemetry snapshots every this many "
                         "seconds while the stream is in flight")
    ap.add_argument("--health", action="store_true",
                    help="print the server health() snapshot after the run "
                         "(includes the telemetry section: arrival "
                         "histogram, queue-depth peak, per-class latency)")
    ap.add_argument("--dtype", default=None, choices=("fp32", "int8"),
                    help="require the artifact to carry this weight "
                         "precision (int8 = W8 per-channel quantized); "
                         "fails fast on a mismatch instead of silently "
                         "serving the other precision")
    args = ap.parse_args(argv)
    check_devices(args.devices or 1, args.device)

    if args.artifact and _artifact_is_lm(args.artifact):
        return serve_lm_artifact(args.artifact, args.requests,
                                 gen=args.gen,
                                 max_queue=args.max_queue,
                                 deadline_ms=args.deadline_ms,
                                 retry_budget=args.retry_budget,
                                 backoff_ms=args.backoff_ms,
                                 watchdog_ms=args.watchdog_ms,
                                 show_health=args.health,
                                 priority_default=args.priority_default,
                                 device=args.device, devices=args.devices)
    if args.artifact:
        return serve_artifact(args.artifact, args.requests,
                              max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms,
                              max_queue=args.max_queue,
                              deadline_ms=args.deadline_ms,
                              workers=args.workers,
                              pin="auto" if args.pin_workers else None,
                              shed=args.shed,
                              retry_budget=args.retry_budget,
                              backoff_ms=args.backoff_ms,
                              watchdog_ms=args.watchdog_ms,
                              show_health=args.health,
                              dtype=args.dtype,
                              trace=args.trace,
                              priority_default=args.priority_default,
                              buckets=args.buckets,
                              stats_interval=args.stats_interval,
                              device=args.device, devices=args.devices)

    cfg = make_reduced(ARCHS[args.arch])
    params = model.init_params(cfg, 0, args.device)
    prompts, extra = arch_inputs(cfg, args.batch, args.prompt_len,
                                 args.device)
    gen, t_prefill, t_decode = greedy_generate(params, cfg, prompts,
                                               args.gen, **extra)
    print(f"arch={cfg.name} batch={args.batch} device={args.device}")
    print(f"prefill ({args.prompt_len} tok): {t_prefill * 1e3:.1f} ms")
    print(f"decode  ({args.gen - 1} steps): "
          f"{t_decode / max(args.gen - 1, 1) * 1e3:.2f} ms/tok")
    print(f"generated tokens[0]: {gen[0].cpu().numpy()[:12]}")
    return gen


if __name__ == "__main__":
    main()
