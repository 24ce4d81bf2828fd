"""Composable compiler pipeline: NeoCPU's end-to-end flow as first-class
passes.

The paper's thesis is that the whole inference pipeline — graph rewrites,
per-workload schedule search, global layout planning, transform elimination
— should be jointly owned by one system (§3).  Here that system is a
``Pipeline``: an ordered list of ``Pass`` objects run over one
``PipelineState``, producing a ``Plan`` plus a typed ``PipelineReport``
(per-pass timings, fusion/concat counts, solver stats).

Passes:

    FuseEpilogues     §3.1 — collapse conv->bn->relu(->add)(->pool) chains
                      into ``conv_block`` nodes (core.fusion phase 1)
    FuseConcatWrites  §3.1 — rewrite DenseNet concats into shared-buffer
                      channel-offset writes (core.fusion phase 2)
    LocalTune         §3.3.1 — per-workload schedule search into the
                      ScheduleDatabase (roofline, cached, or measured)
    GlobalLayoutPlan  §3.3.2 — assign (ic_bn, oc_bn) schemes: the DP/PBQP
                      scheme search, the paper's uniform-x ablation, or the
                      unblocked NCHW baseline
    TransformElim     §3.2 — rewrite the graph with layout transforms only
                      at category boundaries

``Pipeline.preset(mode)`` reproduces the Table-3 ``MODES`` ladder exactly;
``core.planner.plan(mode=...)`` is a thin deprecated shim over it.  The
passes are the JAX reference's, priced on a ``core.cost.MachineModel``
(``MachineModel.h100()`` by default): fed the reference's machine figures,
the port emits the reference's plan.

    "nchw"           row 1 — no blocking (baseline = 1x)
    "layout"         row 2 — blocked CONVs, transforms around each CONV
    "transform-elim" row 3 — one uniform block x, transforms eliminated
    "global-search"  row 4 — per-CONV schemes from the global search
    "fusion"         row 5 — §3.1 fusion passes first, then row 4 planning;
                     fused blocks are layout-tolerant as a unit and their
                     residual inputs couple conv output layouts
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import global_search
from repro_torch.core.cost import (H100, MachineModel, conv_schedule_cost,
                                   epilogue_cost_s, transform_cost_s)
from repro_torch.core.fusion import (FusionReport, fuse_concat_writes,
                               fuse_epilogues)
from repro_torch.core.graph import Graph, MULTI_INPUT_SAME_LAYOUT, Node
from repro_torch.core.layout import LayoutCategory, candidate_blocks, nchwc
from repro_torch.core.local_search import (LocalSearchResult,
                                           ScheduleDatabase, roofline_runner)
from repro_torch.core.schedule import ConvSchedule, ConvWorkload
from repro_torch.core.transform_elim import PlannedGraph, eliminate_transforms

MODES = ("nchw", "layout", "transform-elim", "global-search", "fusion")

TUNINGS = ("roofline", "cached", "measured")


def make_workload(node: Node, in_shape: Tuple[int, ...],
                  quantize: bool = False) -> ConvWorkload:
    a = node.attrs
    n, c, h, w = in_shape
    fused = node.op == "conv_block"
    concat = fused and bool(a.get("concat_into"))
    # conv_block inputs: [data, residual?, concat_buf?] — the buffer is
    # always last when present, so a residual exists only past that slot
    n_data = 1 + (1 if concat else 0)
    return ConvWorkload(
        # int8 eligibility rides the workload so the local search enumerates
        # (and the database keys) the quantized axis; only conv_block nodes
        # qualify — the dequant scale travels on the fused epilogue's scale
        # operand, which a plain conv2d node doesn't carry
        quantize=quantize and fused,
        batch=n, in_channels=c, out_channels=a["out_channels"],
        height=h, width=w, kh=a["kh"], kw=a["kw"],
        stride=a.get("stride", 1), pad=a.get("pad", 0),
        groups=a.get("groups", 1), pad_w=a.get("pad_w", -1),
        # fused conv_block: the epilogue is part of the schedule's cost
        # (conv_schedule_cost charges it), so the local search ranks
        # schedules with their epilogue included
        fused_bn=fused and a.get("bn_from") is not None,
        fused_relu=fused and bool(a.get("relu")),
        fused_residual=fused and len(node.inputs) > n_data,
        fused_pool=a.get("pool_kind", "") if fused else "",
        pool_k=a.get("pool_k", 0) if fused else 0,
        pool_stride=a.get("pool_stride", 0) if fused else 0,
        pool_pad=a.get("pool_pad", 0) if fused else 0,
        pool_ceil=bool(a.get("pool_ceil", False)) if fused else False,
        concat_offset=a.get("concat_offset", 0) if concat else 0,
        concat_total=a.get("concat_total", 0) if concat else 0)


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PassReport:
    """One pass's contribution to the pipeline run."""

    name: str
    seconds: float
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PipelineReport:
    """Typed record of one ``Pipeline.run``: what each pass did and cost."""

    pipeline: str                       # preset name or "custom"
    passes: List[PassReport]
    total_seconds: float
    n_fused_blocks: int = 0
    n_pool_fused: int = 0
    n_concat_fused: int = 0
    solver: Optional[Dict[str, Any]] = None   # method, nodes, edges
    transform_bw: Optional[float] = None      # bytes/s the edges were priced at

    def to_json(self) -> Dict[str, Any]:
        return {
            "pipeline": self.pipeline,
            "total_seconds": round(self.total_seconds, 6),
            "passes": [{"name": p.name, "seconds": round(p.seconds, 6),
                        **p.stats} for p in self.passes],
            "n_fused_blocks": self.n_fused_blocks,
            "n_pool_fused": self.n_pool_fused,
            "n_concat_fused": self.n_concat_fused,
            "solver": self.solver,
            "transform_bw": self.transform_bw,
        }


@dataclasses.dataclass
class Plan:
    planned: PlannedGraph
    mode: str
    solution: Optional[global_search.SchemeSolution]
    predicted_conv_s: float
    predicted_transform_s: float
    predicted_epilogue_s: float = 0.0
    fusion: Optional[FusionReport] = None
    report: Optional[PipelineReport] = None

    @property
    def predicted_total_s(self) -> float:
        return (self.predicted_conv_s + self.predicted_transform_s
                + self.predicted_epilogue_s)


# ---------------------------------------------------------------------------
# Conv-DAG extraction: which CONVs constrain each other's layouts
# ---------------------------------------------------------------------------

def conv_dependencies(graph: Graph):
    """Returns (edges, couplings):
    edges      — list of (conv_u, conv_v, tensor_shape): u's output layout
                 flows into v through oblivious/tolerant ops only;
    couplings  — list of (conv_u, conv_w, tensor_shape): u and w feed the
                 same multi-input node, so their *output* layouts must agree.
    """
    # ancestors[t] = set of conv names whose blocked layout reaches tensor t
    ancestors: Dict[str, frozenset] = {}
    edges: List[Tuple[str, str, Tuple[int, ...]]] = []
    couplings: List[Tuple[str, str, Tuple[int, ...]]] = []
    for node in graph.topo_order():
        if node.op == "input":
            ancestors[node.name] = frozenset()
        elif node.op in ("conv2d", "conv_block"):
            feeder = graph.nodes[node.inputs[0]]
            for a in ancestors[feeder.name]:
                edges.append((a, node.name, feeder.shape))
            # fused residual and concat buffer: both extra inputs are
            # consumed in this conv's *output* layout, so each producing
            # conv's oc_bn must match ours — couplings, not normal ic/oc
            # edges (§3.3.2 Elementwise_Add rule; the concat buffer couples
            # sibling writers and the alloc seed the same way)
            for extra in node.inputs[1:]:
                src = graph.nodes[extra]
                for a in ancestors[src.name]:
                    if a != node.name:
                        couplings.append((a, node.name, src.shape))
            ancestors[node.name] = frozenset([node.name])
        elif node.op in MULTI_INPUT_SAME_LAYOUT:
            sets = [ancestors[i] for i in node.inputs]
            merged = frozenset().union(*sets)
            # pairwise coupling across distinct branches
            for i in range(len(sets)):
                for j in range(i + 1, len(sets)):
                    for a in sets[i]:
                        for b in sets[j]:
                            if a != b:
                                couplings.append((a, b, node.shape))
            ancestors[node.name] = merged
        elif node.category is LayoutCategory.DEPENDENT:
            ancestors[node.name] = frozenset()   # layout resets to NCHW
        else:
            ancestors[node.name] = ancestors[node.inputs[0]] if node.inputs \
                else frozenset()
    return edges, couplings


# ---------------------------------------------------------------------------
# Scheme problem assembly
# ---------------------------------------------------------------------------

def _scheme_problem(graph: Graph, locals_: Dict[str, LocalSearchResult],
                    max_pairs: int, transform_bw: Optional[float] = None,
                    machine: MachineModel = H100,
                    ) -> Tuple[global_search.SchemeProblem,
                               Dict[str, List[Tuple[int, int]]]]:
    convs = [n.name for n in graph.conv_nodes()]
    pairs: Dict[str, List[Tuple[int, int]]] = {}
    node_costs: Dict[str, np.ndarray] = {}
    for name in convs:
        lc = locals_[name].layout_costs()
        top = sorted(lc.items(), key=lambda kv: kv[1])[:max_pairs]
        pairs[name] = [p for p, _ in top]
        node_costs[name] = np.array([c for _, c in top])

    edge_costs: Dict[Tuple[str, str], np.ndarray] = {}
    edges, couplings = conv_dependencies(graph)
    pos = {n.name: i for i, n in enumerate(graph.topo_order())}
    # transform costs scale to the clock the node costs came from: the
    # machine's memory roofline by default, or a measured copy bandwidth
    # (underweighting a relayout lets the solver pick mismatched neighbor
    # blockings)
    bw_scale = 1.0 if transform_bw is None else machine.mem_bw / transform_bw

    def _accum(u, v, mat):
        key = (u, v)
        if key in edge_costs:
            edge_costs[key] = np.minimum(edge_costs[key], mat)  # same edge
        else:
            edge_costs[key] = mat

    for u, v, shape in edges:
        m = np.zeros((len(pairs[u]), len(pairs[v])))
        for j, (_, oc_u) in enumerate(pairs[u]):
            for k, (ic_v, _) in enumerate(pairs[v]):
                if oc_u != ic_v:
                    m[j, k] = bw_scale * transform_cost_s(
                        shape, nchwc(oc_u), nchwc(ic_v), machine=machine)
        _accum(u, v, m)
    for u, w, shape in couplings:
        a, b = (u, w) if pos[u] < pos[w] else (w, u)
        m = np.zeros((len(pairs[a]), len(pairs[b])))
        for j, (_, oc_a) in enumerate(pairs[a]):
            for k, (_, oc_b) in enumerate(pairs[b]):
                if oc_a != oc_b:
                    m[j, k] = bw_scale * transform_cost_s(
                        shape, nchwc(oc_a), nchwc(oc_b), machine=machine)
        _accum(a, b, m)

    topo = [n for n in (x.name for x in graph.topo_order()) if n in set(convs)]
    prob = global_search.SchemeProblem(node_costs=node_costs,
                                       edge_costs=edge_costs, topo=topo)
    return prob, pairs


# ---------------------------------------------------------------------------
# Uniform-x schedule assignment (modes "layout" and "transform-elim")
# ---------------------------------------------------------------------------

def _uniform_schedules(graph: Graph, locals_: Dict[str, LocalSearchResult],
                       block: int) -> Dict[str, ConvSchedule]:
    """ic_bn = oc_bn = the largest factor of the channel count ≤ block —
    §3.2's constant-x scheme (x=16 in the paper, 128-lane preferred here)."""
    out: Dict[str, ConvSchedule] = {}
    for node in graph.conv_nodes():
        wl = locals_[node.name].workload
        cin = wl.in_channels // wl.groups
        ic = max(f for f in candidate_blocks(cin) if f <= block)
        ocs = [f for f in candidate_blocks(wl.out_channels) if f <= block]
        if wl.concat_total:
            # the blocked concat-offset store must land on block boundaries
            ocs = [f for f in ocs if wl.concat_offset % f == 0
                   and wl.concat_total % f == 0] or [1]
        oc = max(ocs)
        best = locals_[node.name].best_for_layout(ic, oc)
        if best is not None:
            out[node.name] = best.schedule
        else:  # pair pruned from candidates: synthesize a legal schedule
            ref = locals_[node.name].best
            out[node.name] = ConvSchedule(ic, oc, ref.ow_bn, ref.oh_bn,
                                          ref.unroll_ker, ref.variant,
                                          dtype=ref.dtype)
    return out


def _predicted_epilogue_s(graph: Graph,
                          machine: MachineModel = H100) -> float:
    """Shallow-epilogue traffic of the planned graph's *standalone* BN /
    ReLU / add / pooling / concat nodes (full read+write passes each).
    Fused conv_block epilogues are not charged here — their
    (residual-read-only) traffic is part of ``conv_schedule_cost`` via the
    workload's fused flags, so the local search already ranked schedules
    with the epilogue included."""
    total = 0.0
    for node in graph.topo_order():
        if node.shape is None or len(node.shape) != 4:
            continue
        if node.op == "batch_norm":
            total += epilogue_cost_s(node.shape, bn=True, machine=machine)
        elif node.op == "relu":
            total += epilogue_cost_s(node.shape, relu=True, machine=machine)
        elif node.op == "add":
            total += epilogue_cost_s(node.shape, residual=True,
                                     machine=machine)
        elif node.op in ("max_pool", "avg_pool"):
            # charged on the *input* tensor (the read side dominates)
            src = graph.nodes[node.inputs[0]].shape
            if src is not None and len(src) == 4:
                total += epilogue_cost_s(
                    src, pool_stride=node.attrs.get("stride",
                                                    node.attrs["k"]),
                    machine=machine)
        elif node.op == "concat":
            total += epilogue_cost_s(node.shape, concat=True,
                                     machine=machine)
        elif node.op == "concat_alloc":
            # only the pass-through operands are still copied into the buffer
            for i in node.inputs:
                src = graph.nodes[i].shape
                if src is not None and len(src) == 4:
                    total += epilogue_cost_s(src, concat=True,
                                             machine=machine)
    return total


# ---------------------------------------------------------------------------
# Pipeline state + passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineState:
    """Mutable context one pipeline run threads through its passes."""

    graph: Graph
    input_shapes: Dict[str, Tuple[int, ...]]
    db: ScheduleDatabase
    machine: MachineModel = H100
    tuning: str = "roofline"            # "roofline" | "cached" | "measured"
    quantize: bool = False              # enumerate int8 schedules per conv
    transform_bw: Optional[float] = None
    search_budget: Tuple[int, int, int] = (6, 2, 3)  # top_k, per_variant, reps
    # what measured tuning times: where, and on which engine (B1, or the
    # schedules' lowerings)
    device: Any = "cuda"
    use_kernel: bool = True
    locals_: Dict[str, LocalSearchResult] = dataclasses.field(
        default_factory=dict)
    schedules: Dict[str, ConvSchedule] = dataclasses.field(
        default_factory=dict)
    solution: Optional[global_search.SchemeSolution] = None
    fusion: Optional[FusionReport] = None
    planned: Optional[PlannedGraph] = None
    predicted_conv_s: float = 0.0
    solver_stats: Optional[Dict[str, Any]] = None


class Pass:
    """One pipeline stage.  Subclasses mutate the state and return a stats
    dict for the ``PipelineReport``."""

    name = "pass"

    def __call__(self, state: PipelineState) -> Dict[str, Any]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class FuseEpilogues(Pass):
    """§3.1 phase 1: conv -> [bn] -> [add] -> [relu] -> [pool] chains become
    ``conv_block`` nodes (BN folded into the conv at bind time)."""

    name = "fuse-epilogues"

    def __call__(self, state: PipelineState) -> Dict[str, Any]:
        state.graph, report = fuse_epilogues(state.graph)
        state.graph.infer_shapes(state.input_shapes)
        state.fusion = report
        return {"n_blocks": report.n_blocks,
                "n_absorbed": report.n_absorbed,
                "n_pool_fused": report.n_pool_fused}


class FuseConcatWrites(Pass):
    """§3.1 phase 2: DenseNet-style concats become a ``concat_alloc`` buffer
    seed plus channel-offset writer conv_blocks."""

    name = "fuse-concat-writes"

    def __call__(self, state: PipelineState) -> Dict[str, Any]:
        state.graph, n_concat = fuse_concat_writes(state.graph)
        state.graph.infer_shapes(state.input_shapes)
        if state.fusion is None:
            state.fusion = FusionReport(n_blocks=0, n_absorbed=0, chains={})
        state.fusion.n_concat_fused = n_concat
        return {"n_concat_fused": n_concat}


class LocalTune(Pass):
    """§3.3.1: per-workload schedule search, memoized in the
    ``ScheduleDatabase``.  The state's ``tuning`` picks the signal:
    ``"roofline"``/``"cached"`` rank with the analytical model on the
    state's machine (``cached`` differs only in intent — the database is
    expected to arrive pre-populated, e.g. from a saved artifact, so
    nothing new is searched); ``"measured"`` runs the guided
    roofline-pruned search, timed on the state's device and engine.  A B1
    state reads an entry measured on B1 before the reference's key."""

    name = "local-tune"

    def __call__(self, state: PipelineState) -> Dict[str, Any]:
        n_before = len(state.db)
        runner = functools.partial(roofline_runner, machine=state.machine)
        for node in state.graph.conv_nodes():
            wl = make_workload(node, state.graph.nodes[node.inputs[0]].shape,
                               quantize=state.quantize)
            if state.tuning == "measured":
                top_k, per_variant, repeats = state.search_budget
                res = state.db.search_measured(
                    wl, top_k=top_k, per_variant=per_variant,
                    repeats=repeats, machine=state.machine,
                    device=state.device, use_kernel=state.use_kernel)
            else:
                res = state.db.search(wl, runner=runner,
                                      use_kernel=state.use_kernel)
            state.locals_[node.name] = res
        return {"n_convs": len(state.locals_),
                "n_new_workloads": len(state.db) - n_before,
                "n_measured": sum(1 for r in state.locals_.values()
                                  if r.measured)}


class GlobalLayoutPlan(Pass):
    """§3.3.2: assign one (ic_bn, oc_bn) scheme per CONV.

    strategy "scheme"  — the DP/PBQP global search over per-CONV candidates
             "uniform" — the paper's constant-x ablation (rows 2-3)
             "none"    — unblocked NCHW baseline (row 1)

    Under measured or cached tuning, when the local results are measured
    and no ``transform_bw`` was given, the relayout bandwidth of the
    state's device is calibrated with a one-shot probe
    (``core.calibrate``), so edge and node costs live on one clock; the
    figure is process-cached and recorded in the report and the artifact.
    """

    name = "global-layout"

    def __init__(self, strategy: str = "scheme", uniform_block: int = 128,
                 max_pairs: int = 8, dp_state_budget: int = 200_000) -> None:
        if strategy not in ("scheme", "uniform", "none"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.uniform_block = uniform_block
        self.max_pairs = max_pairs
        self.dp_state_budget = dp_state_budget

    def __call__(self, state: PipelineState) -> Dict[str, Any]:
        stats: Dict[str, Any] = {"strategy": self.strategy}
        # gated on tuning intent, as in the reference: a roofline-tuned run
        # keeps the memory-roofline clock whatever the database holds
        if (state.tuning in ("measured", "cached")
                and state.transform_bw is None
                and any(r.measured for r in state.locals_.values())):
            from repro_torch.core import calibrate
            state.transform_bw = calibrate.measure_host_copy_bw(
                device=state.device)
            stats["transform_bw_auto"] = round(state.transform_bw)
        if self.strategy == "none":
            state.schedules = {}
            # unblocked direct conv: whole-channel "blocks", no output-width
            # register blocking — an (1 x C x K) micro-GEMM with unaligned
            # tiles, the same structural penalty the paper's row-1 baseline
            # pays on AVX-512
            conv_s = 0.0
            for loc in state.locals_.values():
                wl = loc.workload
                naive = ConvSchedule(wl.in_channels // wl.groups,
                                     wl.out_channels, 1, 1, False)
                conv_s += conv_schedule_cost(wl, naive,
                                             state.machine).total_s
            state.predicted_conv_s = conv_s
            return stats
        if self.strategy == "uniform":
            state.schedules = _uniform_schedules(state.graph, state.locals_,
                                                 self.uniform_block)
            stats["uniform_block"] = self.uniform_block
        else:
            prob, pairs = _scheme_problem(state.graph, state.locals_,
                                          self.max_pairs, state.transform_bw,
                                          state.machine)
            state.solution = global_search.solve(
                prob, dp_state_budget=self.dp_state_budget)
            state.schedules = {}
            for name, idx in state.solution.assignment.items():
                ic, oc = pairs[name][idx]
                best = state.locals_[name].best_for_layout(ic, oc)
                assert best is not None
                state.schedules[name] = best.schedule
            stats.update(solver=state.solution.method,
                         n_nodes=len(prob.node_costs),
                         n_edges=len(prob.edge_costs),
                         objective_s=float(state.solution.objective))
            state.solver_stats = {k: stats[k] for k in
                                  ("solver", "n_nodes", "n_edges",
                                   "objective_s")}
        conv_s = 0.0
        for name, sched in state.schedules.items():
            r = state.locals_[name].best_for_layout(sched.ic_bn, sched.oc_bn)
            conv_s += r.cost_s if r else state.locals_[name].ranked[-1].cost_s
        state.predicted_conv_s = conv_s
        return stats


class TransformElim(Pass):
    """§3.2: rewrite the graph under the assigned schedules, inserting
    layout transforms only at category boundaries (``around_each_conv``
    reproduces Table 3 row 2: transform in and out of every CONV)."""

    name = "transform-elim"

    def __init__(self, around_each_conv: bool = False) -> None:
        self.around_each_conv = around_each_conv

    def __call__(self, state: PipelineState) -> Dict[str, Any]:
        state.planned = eliminate_transforms(
            state.graph, state.schedules,
            around_each_conv=self.around_each_conv)
        return {"n_transforms": state.planned.n_transforms,
                "transform_bytes": state.planned.transform_bytes_total}


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

class Pipeline:
    """An ordered list of passes; ``run`` produces a ``Plan`` with an
    attached ``PipelineReport``."""

    def __init__(self, passes: Sequence[Pass], name: str = "custom") -> None:
        self.passes = list(passes)
        self.name = name

    def __repr__(self) -> str:
        return (f"Pipeline({self.name!r}: "
                f"{' -> '.join(p.name for p in self.passes)})")

    @classmethod
    def preset(cls, mode: str, uniform_block: int = 128, max_pairs: int = 8,
               dp_state_budget: int = 200_000) -> "Pipeline":
        """The Table-3 ladder as pipelines, rung by rung as in the
        reference."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        passes: List[Pass] = []
        if mode == "fusion":
            # §3.1: fuse epilogues first so each fused block is
            # layout-tolerant as a unit, then plan layouts as in
            # "global-search"
            passes += [FuseEpilogues(), FuseConcatWrites()]
        passes.append(LocalTune())
        if mode == "nchw":
            passes.append(GlobalLayoutPlan("none"))
        elif mode in ("layout", "transform-elim"):
            passes.append(GlobalLayoutPlan("uniform",
                                           uniform_block=uniform_block))
        else:
            passes.append(GlobalLayoutPlan(
                "scheme", max_pairs=max_pairs,
                dp_state_budget=dp_state_budget))
        passes.append(TransformElim(around_each_conv=(mode == "layout")))
        return cls(passes, name=mode)

    def run(self, graph: Graph, input_shapes: Dict[str, Tuple[int, ...]], *,
            db: Optional[ScheduleDatabase] = None,
            tuning: str = "roofline",
            quantize: bool = False,
            transform_bw: Optional[float] = None,
            machine: MachineModel = H100,
            search_budget: Tuple[int, int, int] = (6, 2, 3),
            device="cuda", use_kernel: bool = True) -> Plan:
        # transform_bw: bytes/s the executing device moves a layout
        # transform at.  None keeps the machine's memory roofline
        # (consistent with roofline node costs) unless the local results
        # are measured, in which case GlobalLayoutPlan calibrates it on
        # ``device``.  ``device`` and ``use_kernel`` say what measured
        # tuning times: the session's device and engine.
        if tuning not in TUNINGS:
            raise ValueError(f"tuning {tuning!r} not in {TUNINGS}")
        graph.infer_shapes(input_shapes)
        # NOT `db or ...`: an *empty* caller database is still the caller's
        # memo — `or` would silently swap in a throwaway one and the shared
        # database would never accumulate entries
        state = PipelineState(graph=graph, input_shapes=dict(input_shapes),
                              db=db if db is not None else ScheduleDatabase(),
                              machine=machine, tuning=tuning,
                              quantize=quantize, transform_bw=transform_bw,
                              search_budget=tuple(search_budget),
                              device=device, use_kernel=use_kernel)
        t_start = time.perf_counter()
        pass_reports: List[PassReport] = []
        for p in self.passes:
            t0 = time.perf_counter()
            stats = p(state) or {}
            pass_reports.append(
                PassReport(p.name, time.perf_counter() - t0, stats))
        if state.planned is None:    # custom pipeline without TransformElim
            state.planned = eliminate_transforms(state.graph, state.schedules)
        # report transforms on the same clock the solver priced them with
        # (the standalone-node epilogue term below stays on the roofline
        # clock; in fusion mode there are essentially no standalone epilogue
        # nodes left)
        tr_s = (state.planned.transform_bytes_total
                / (state.transform_bw or machine.mem_bw))
        epi_s = _predicted_epilogue_s(state.planned.graph, machine)
        fr = state.fusion
        report = PipelineReport(
            pipeline=self.name, passes=pass_reports,
            total_seconds=time.perf_counter() - t_start,
            n_fused_blocks=fr.n_blocks if fr else 0,
            n_pool_fused=fr.n_pool_fused if fr else 0,
            n_concat_fused=fr.n_concat_fused if fr else 0,
            solver=state.solver_stats,
            transform_bw=state.transform_bw)
        return Plan(planned=state.planned, mode=self.name,
                    solution=state.solution,
                    predicted_conv_s=state.predicted_conv_s,
                    predicted_transform_s=tr_s,
                    predicted_epilogue_s=epi_s, fusion=state.fusion,
                    report=report)
