"""Local search: per-workload schedule selection (NeoCPU §3.3.1).

The paper walks the candidate space per CONV workload, measures every
combination, and keeps a ranked list; results are memoized in a database
keyed by the workload (feature-map + kernel sizes) so the same convolution
appearing in different models is never searched twice.

The scoring signal is pluggable, as in the reference:

* ``roofline_runner`` (default) — the analytical model of ``core.cost``
  priced on a ``MachineModel``; deterministic and fast.
* ``measured_runner`` — the time of what the session runs, on the session's
  device (``core.calibrate.timed_seconds``): with ``use_kernel`` the conv
  kernel (B1) with the workload's fused epilogue, otherwise the schedule's
  lowering (``kernels/ops.py::conv2d_lowered``), each behind the pad of its
  blocked input.  ``guided_local_search`` prunes with the model and ranks
  the survivors with it (the paper's §3.3.1 on the target).

The database keeps the reference's JSON blob format, in a file too, so a
database written by one package loads in the other.  Entries measured on
B1 are keyed apart (``B1_KEY``): B1 ignores a schedule's lowering variant,
so its ranking says nothing of a lowering, and the reference never builds
such a key.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cost import H100, MachineModel, conv_schedule_cost
from repro_torch.core.schedule import (ConvSchedule, ConvWorkload,
                                       candidate_schedules)

Runner = Callable[[ConvWorkload, ConvSchedule], float]

# Two schedules whose measured times are within this relative tolerance
# are ties: guided search breaks them with the analytical model instead of
# the noise, so the winner does not hang on jitter.
MEASURE_NOISE_FLOOR = 0.02

# Suffix of the database key of an entry measured on B1 (``use_kernel``)
B1_KEY = "_b1"

# Process-wide spy: how many actual searches (not memo hits) have run.  A
# session loaded from a saved artifact must go load -> predict without any
# schedule search; tests and chip_smoke.py's artifacts phase assert on it.
SEARCH_COUNTERS = {"local_search": 0, "guided_local_search": 0}


def search_calls() -> int:
    """Total schedule searches executed in this process (memo hits
    excluded)."""
    return sum(SEARCH_COUNTERS.values())


def roofline_runner(wl: ConvWorkload, s: ConvSchedule,
                    machine: MachineModel = H100) -> float:
    return conv_schedule_cost(wl, s, machine).total_s


@functools.lru_cache(maxsize=1)
def _raw_operands(wl: ConvWorkload, device: str) -> tuple:
    """Random NCHW input and KCRS weight of ``wl`` on ``device``, drawn
    once for all the candidates of one workload (``guided_local_search``
    clears it when its measurements are done)."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    cin = wl.in_channels // wl.groups
    x = torch.randn((wl.batch, cin, wl.height, wl.width), generator=g,
                    device=device)
    w = torch.randn((wl.out_channels, cin, wl.kh, wl.kw), generator=g,
                    device=device)
    return x, w


def measured_runner(wl: ConvWorkload, s: ConvSchedule, repeats: int = 3,
                    device="cuda", use_kernel: bool = True) -> float:
    """Seconds per call of the conv the session runs for ``wl`` under
    ``s``, on ``device``: the input blocked as ``s`` says, the weight as
    the session binds it (int8 codes with the dequantize scale on the
    epilogue, or panel-major for the patch_gemm lowering), the fused
    epilogue's operands, then ``kernels/ops.py::conv2d_block_blocked``
    (the pad of the blocked input, then B1 or the lowering), timed by
    ``core.calibrate.timed_seconds`` (the card's own time on the card,
    the host clock over the plain versions on the CPU)."""
    import torch

    from repro_torch.core.calibrate import timed_seconds
    from repro_torch.core.layout import kernel_to_kcrs_ck, to_nchwc
    from repro_torch.core.quantize import quantize_per_channel
    from repro_torch.kernels.ops import (conv2d_block_blocked,
                                         prelay_patch_gemm_weight)

    device = str(torch.device(device))
    x, w = _raw_operands(wl, device)
    ko = wl.out_channels // s.oc_bn
    oh, ow = wl.out_hw
    scale = shift = residual = out_buf = None
    if s.dtype == "int8":
        wq, w_scale = quantize_per_channel(w.cpu().numpy(), axis=0)
        w = torch.from_numpy(wq).to(device)
        scale = torch.from_numpy(w_scale).to(device).reshape(ko, s.oc_bn)
    xb = to_nchwc(x, s.ic_bn)
    wb = kernel_to_kcrs_ck(w, s.ic_bn, s.oc_bn)
    prelaid = not use_kernel and s.resolved_variant() == "patch_gemm"
    if prelaid:
        wb = prelay_patch_gemm_weight(wb)
    if wl.fused_bn:
        shift = torch.randn((ko, s.oc_bn), device=device)
    if wl.fused_residual:
        residual = torch.randn((wl.batch, ko, oh, ow, s.oc_bn),
                               device=device)
    spec = wl.epilogue_spec()
    if spec.writes_concat:
        poh, pow_ = wl.pooled_out_hw
        out_buf = torch.zeros((wl.batch, wl.concat_total // s.oc_bn, poh,
                               pow_, s.oc_bn), device=device)
    pad = wl.pad if wl.pad_w < 0 else (wl.pad, wl.pw)
    return timed_seconds(
        lambda: conv2d_block_blocked(
            xb, wb, scale, shift, residual, out_buf, stride=wl.stride,
            pad=pad, epilogue=spec, schedule=s, use_kernel=use_kernel,
            w_prelaid=prelaid),
        repeats, device)


@dataclasses.dataclass(frozen=True)
class RankedSchedule:
    schedule: ConvSchedule
    cost_s: float


@dataclasses.dataclass
class LocalSearchResult:
    """Ascending-cost list of schedules for one workload (§3.3.1 step 4).

    ``measured`` distinguishes measured rankings from analytical ones:
    their costs live on different clocks, and only measured entries may
    satisfy a ``search_measured`` request.  ``search_budget`` records the
    (top_k, per_variant) a measured ranking was produced with, so a
    shallow entry does not satisfy a deeper request."""

    workload: ConvWorkload
    ranked: List[RankedSchedule]
    measured: bool = False
    search_budget: Tuple[int, int] = (0, 0)

    @property
    def best(self) -> ConvSchedule:
        return self.ranked[0].schedule

    def best_for_layout(self, ic_bn: int, oc_bn: int) -> Optional[RankedSchedule]:
        """Cheapest schedule constrained to a given (ic_bn, oc_bn) pair —
        the quantity the global search needs per scheme."""
        for r in self.ranked:
            if r.schedule.ic_bn == ic_bn and r.schedule.oc_bn == oc_bn:
                return r
        return None

    def layout_costs(self) -> Dict[Tuple[int, int], float]:
        """(ic_bn, oc_bn) -> best cost; the per-CONV scheme axis of §3.3.2."""
        out: Dict[Tuple[int, int], float] = {}
        for r in self.ranked:
            key = (r.schedule.ic_bn, r.schedule.oc_bn)
            if key not in out:
                out[key] = r.cost_s
        return out


def local_search(wl: ConvWorkload, runner: Runner = roofline_runner,
                 max_candidates: int = 0) -> LocalSearchResult:
    SEARCH_COUNTERS["local_search"] += 1
    cands = candidate_schedules(wl, max_candidates=max_candidates)
    scored = [RankedSchedule(s, runner(wl, s)) for s in cands]
    scored.sort(key=lambda r: (r.cost_s, r.schedule))
    return LocalSearchResult(workload=wl, ranked=scored)


def guided_local_search(wl: ConvWorkload, top_k: int = 6,
                        max_candidates: int = 0,
                        per_variant: int = 2,
                        repeats: int = 3, *,
                        machine: MachineModel = H100, device="cuda",
                        use_kernel: bool = True) -> LocalSearchResult:
    """The paper's measure-on-target methodology, made affordable: the
    roofline model (on ``machine``) prunes the space, ``measured_runner``
    on ``device`` ranks the survivors.

    The shortlist is the roofline top-``top_k`` plus the best
    ``per_variant`` candidates of every ``(lowering variant, dtype)`` pair
    of the enumeration, deduped by what the measurement runs: on the
    lowerings ``(ic_bn, oc_bn, variant, dtype)``, as in the reference; on
    B1 (``use_kernel``), which takes its tile from neither the variant nor
    the tile knobs, ``(ic_bn, oc_bn, dtype)``.

    Measured costs within ``MEASURE_NOISE_FLOOR`` of the winner are ties:
    that group is re-ranked by the analytical model on ``(total_s,
    memory_s, schedule)``, so the winner is deterministic instead of a
    jitter coin flip."""
    SEARCH_COUNTERS["guided_local_search"] += 1

    pruned = local_search(wl, functools.partial(roofline_runner,
                                                machine=machine),
                          max_candidates)
    short: List[ConvSchedule] = []
    seen = set()

    def _add(s: ConvSchedule) -> bool:
        key = ((s.ic_bn, s.oc_bn, s.dtype) if use_kernel
               else (s.ic_bn, s.oc_bn, s.resolved_variant(), s.dtype))
        if key in seen:
            return False
        seen.add(key)
        short.append(s)
        return True

    for r in pruned.ranked:
        if len(short) >= top_k:
            break
        _add(r.schedule)
    axes = sorted({(r.schedule.resolved_variant(), r.schedule.dtype)
                   for r in pruned.ranked})
    for variant, dtype in axes:
        n_have = sum(1 for s in short
                     if s.resolved_variant() == variant and s.dtype == dtype)
        for r in pruned.ranked:
            if n_have >= per_variant:
                break
            if (r.schedule.resolved_variant() == variant
                    and r.schedule.dtype == dtype and _add(r.schedule)):
                n_have += 1
    scored = [RankedSchedule(s, measured_runner(
        wl, s, repeats=repeats, device=device, use_kernel=use_kernel))
        for s in short]
    _raw_operands.cache_clear()
    floor = min(r.cost_s for r in scored) * (1.0 + MEASURE_NOISE_FLOOR)

    def _rank(r: RankedSchedule):
        if r.cost_s <= floor:   # tied with the winner: analytical tiebreak
            cost = conv_schedule_cost(wl, r.schedule, machine)
            return (0, cost.total_s, cost.memory_s, r.schedule)
        return (1, r.cost_s, 0.0, r.schedule)

    scored.sort(key=_rank)
    return LocalSearchResult(workload=wl, ranked=scored, measured=True,
                             search_budget=(top_k, per_variant))


def ties(result: LocalSearchResult) -> int:
    """How many schedules of a measured ranking the analytical tie-break
    ordered: those within ``MEASURE_NOISE_FLOOR`` of the fastest."""
    floor = min(r.cost_s for r in result.ranked) * (1.0 + MEASURE_NOISE_FLOOR)
    return sum(1 for r in result.ranked if r.cost_s <= floor)


# ---------------------------------------------------------------------------
# Workload-keyed database (§3.3.1: "maintain a database ... to prevent
# repeating search for the same convolution in different models")
# ---------------------------------------------------------------------------

def _wl_key(wl: ConvWorkload) -> str:
    key = (f"n{wl.batch}_c{wl.in_channels}_k{wl.out_channels}"
           f"_h{wl.height}_w{wl.width}_r{wl.kh}s{wl.kw}"
           f"_st{wl.stride}_p{wl.pad}_g{wl.groups}")
    if wl.pad_w >= 0:
        key += f"_pw{wl.pad_w}"
    # fused conv_blocks search a different space than the plain conv of the
    # same geometry (their cost includes the epilogue) — key them apart
    epi = "".join(c for c, on in (("b", wl.fused_bn), ("r", wl.fused_relu),
                                  ("a", wl.fused_residual)) if on)
    key += f"_e{epi}" if epi else ""
    if wl.fused_pool:   # fused pooling changes the stored tiling
        key += (f"_pool{wl.fused_pool}{wl.pool_k}"
                f"s{wl.pool_stride}p{wl.pool_pad}")
        if wl.pool_ceil:
            key += "c"
    if wl.concat_total:  # concat-offset write constrains oc_bn candidates
        key += f"_cat{wl.concat_offset}of{wl.concat_total}"
    if wl.quantize:  # int8-eligible searches rank a larger candidate space
        key += "_q8"
    return key


class ScheduleDatabase:
    """Workload-keyed memo of search results, optionally JSON-persisted
    (the reference's blob format, so either package reads the other's
    file).

    Persistence caveat: every insert rewrites the whole blob, and an
    analytical entry carries the full candidate ranking.  Path-backed
    databases are meant for measured results (short shortlists); give
    analytical searches an in-memory database (the default).

    The memo does not key on the machine or the device: give each its own
    database."""

    def __init__(self, path: Optional[Path] = None) -> None:
        self.path = Path(path) if path else None
        self._mem: Dict[str, LocalSearchResult] = {}
        if self.path and self.path.exists():
            self._load()

    def search(self, wl: ConvWorkload, runner: Runner = roofline_runner,
               max_candidates: int = 0, use_kernel: bool = False
               ) -> LocalSearchResult:
        """The memo's entry for ``wl``, searched with ``runner`` on a miss.
        With ``use_kernel`` an entry measured on B1 comes first."""
        if use_kernel and _wl_key(wl) + B1_KEY in self._mem:
            return self._mem[_wl_key(wl) + B1_KEY]
        key = _wl_key(wl)
        if key not in self._mem:
            self._mem[key] = local_search(wl, runner, max_candidates)
            if self.path:
                self._save()
        return self._mem[key]

    def search_measured(self, wl: ConvWorkload, top_k: int = 6,
                        per_variant: int = 2, repeats: int = 3, *,
                        machine: MachineModel = H100, device="cuda",
                        use_kernel: bool = True) -> LocalSearchResult:
        """Memoized ``guided_local_search``, keyed by the engine it measured
        (B1 under ``B1_KEY``, the lowerings under the reference's key).  An
        existing entry does not satisfy the request if it is analytical or
        was measured with a shallower budget."""
        key = _wl_key(wl) + (B1_KEY if use_kernel else "")
        have = self._mem.get(key)
        if (have is None or not have.measured
                or have.search_budget[0] < top_k
                or have.search_budget[1] < per_variant):
            self._mem[key] = guided_local_search(
                wl, top_k=top_k, per_variant=per_variant, repeats=repeats,
                machine=machine, device=device, use_kernel=use_kernel)
            if self.path:
                self._save()
        return self._mem[key]

    def put(self, wl: ConvWorkload, result: LocalSearchResult) -> None:
        """Install an externally produced ranking (e.g. a measured result
        filtered to one variant) under the workload's key."""
        self._mem[_wl_key(wl)] = result
        if self.path:
            self._save()

    def merge(self, other: "ScheduleDatabase") -> int:
        """Fold another database's entries into this one.  Conflict
        semantics are **best-measured-wins**: on a shared workload key the
        incoming entry replaces the existing one only when it is measured
        AND the existing entry is either analytical or measured slower
        (strictly worse best ``cost_s``).  An analytical incoming entry
        never displaces anything, and ties keep the incumbent — so merging
        the same database twice is idempotent.  Returns the number of
        entries added or replaced.  (Already-bound plans are untouched:
        the database only shapes future specializations.)"""
        changed = 0
        for key, result in other._mem.items():
            have = self._mem.get(key)
            if have is None:
                self._mem[key] = result
                changed += 1
                continue
            if not result.measured:
                continue
            if (not have.measured
                    or result.ranked[0].cost_s < have.ranked[0].cost_s):
                self._mem[key] = result
                changed += 1
        if changed and self.path:
            self._save()
        return changed

    # -- persistence ---------------------------------------------------------
    def to_blob(self, measured_only: bool = False) -> Dict:
        """JSON-serializable form of the entries (the reference's format):
        the unit the path-backed file and the session artifact persist.

        ``measured_only`` keeps just the wall-clock-ranked entries: the
        artifact path uses it, because an analytical entry carries the
        full candidate ranking and is re-derivable."""
        blob = {}
        for key, res in self._mem.items():
            if measured_only and not res.measured:
                continue
            blob[key] = {
                "workload": dataclasses.asdict(res.workload),
                "measured": res.measured,
                "search_budget": list(res.search_budget),
                "ranked": [
                    {"schedule": dataclasses.asdict(r.schedule),
                     "cost_s": r.cost_s} for r in res.ranked],
            }
        return blob

    def load_blob(self, blob: Dict) -> None:
        """Install entries from ``to_blob`` output (unknown fields dropped —
        see ``_known_fields``)."""
        for key, rec in blob.items():
            wl = ConvWorkload(**self._known_fields(ConvWorkload,
                                                   rec["workload"]))
            ranked = [RankedSchedule(
                ConvSchedule(**self._known_fields(ConvSchedule,
                                                  r["schedule"])),
                r["cost_s"]) for r in rec["ranked"]]
            self._mem[key] = LocalSearchResult(
                workload=wl, ranked=ranked,
                measured=rec.get("measured", False),
                search_budget=tuple(rec.get("search_budget", (0, 0))))

    def _save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.to_blob()))

    @staticmethod
    def _known_fields(cls, d: Dict) -> Dict:
        """Forward-compat: a database written by a newer version may carry
        workload/schedule keys this version doesn't know — drop them instead
        of crashing the load (their *known* fields still key correctly)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in d.items() if k in names}

    def _load(self) -> None:
        self.load_blob(json.loads(self.path.read_text()))

    def __len__(self) -> int:
        return len(self._mem)
