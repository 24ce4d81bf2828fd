"""Local search: per-workload schedule selection (NeoCPU §3.3.1).

The paper walks the candidate space per CONV workload, measures every
combination, and keeps a ranked list; results are memoized in a database
keyed by the workload (feature-map + kernel sizes) so the same convolution
appearing in different models is never searched twice.

The port ranks with ``roofline_runner``, the analytical model of
``core.cost`` priced on a ``MachineModel``.  The measured search on the card
(the reference's ``measured_runner``, ``guided_local_search`` and
``ScheduleDatabase.search_measured``) waits for ROADMAP A5.  The database
keeps the reference's JSON blob format, in a file too, so a database
written by one package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cost import H100, MachineModel, conv_schedule_cost
from repro_torch.core.schedule import (ConvSchedule, ConvWorkload,
                                       candidate_schedules)

Runner = Callable[[ConvWorkload, ConvSchedule], float]

# Process-wide spy: how many actual searches (not memo hits) have run.  A
# session loaded from a saved artifact must go load -> predict without any
# schedule search; tests and chip_smoke.py's artifacts phase assert on it.
SEARCH_COUNTERS = {"local_search": 0}


def search_calls() -> int:
    """Total schedule searches executed in this process (memo hits
    excluded)."""
    return sum(SEARCH_COUNTERS.values())


def roofline_runner(wl: ConvWorkload, s: ConvSchedule,
                    machine: MachineModel = H100) -> float:
    return conv_schedule_cost(wl, s, machine).total_s


@dataclasses.dataclass(frozen=True)
class RankedSchedule:
    schedule: ConvSchedule
    cost_s: float


@dataclasses.dataclass
class LocalSearchResult:
    """Ascending-cost list of schedules for one workload (§3.3.1 step 4).

    ``measured`` and ``search_budget`` mark wall-clock rankings in the
    reference's database format; the port's own rankings are analytical."""

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


def local_search(wl: ConvWorkload, runner: Runner = roofline_runner
                 ) -> LocalSearchResult:
    SEARCH_COUNTERS["local_search"] += 1
    cands = candidate_schedules(wl)
    scored = [RankedSchedule(s, runner(wl, s)) for s in cands]
    scored.sort(key=lambda r: (r.cost_s, r.schedule))
    return LocalSearchResult(workload=wl, ranked=scored)


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

    The memo does not key on the machine: give each ``MachineModel`` its
    own database."""

    def __init__(self, path: Optional[Path] = None) -> None:
        self.path = Path(path) if path else None
        self._mem: Dict[str, LocalSearchResult] = {}
        if self.path and self.path.exists():
            self._load()

    def search(self, wl: ConvWorkload, runner: Runner = roofline_runner
               ) -> LocalSearchResult:
        key = _wl_key(wl)
        if key not in self._mem:
            self._mem[key] = local_search(wl, runner)
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
