"""Inference sessions: compile once, predict per batch size.

``compile(model, input_spec, ...)`` owns the NeoCPU lifecycle the paper
argues belongs to one system (§3): it runs a pass ``Pipeline`` over the
graph, keeps the schedule database, binds parameters once, and specializes
the executable per batch size on demand.

    session = compile("resnet-50", (1, 3, 224, 224))          # on "cuda"
    y = session.predict(x)

``use_kernel`` (default True) runs every blocked conv on the hand-written
conv kernel; ``use_kernel=False`` runs each on its schedule's lowering, the
reference's ``use_pallas=False`` path, which ``dtype="int8"`` sessions need.

The plan and graph JSON codecs are the JAX reference's
(``repro/engine/session.py``), so a plan made by either package executes
in the other.  Saving and loading artifacts waits for ROADMAP A6.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.cost import H100, MachineModel
from repro_torch.core.graph import Graph
from repro_torch.core.layout import Layout, LayoutKind
from repro_torch.core.local_search import ScheduleDatabase
from repro_torch.core.pipeline import Pipeline, Plan
from repro_torch.core.schedule import ConvSchedule
from repro_torch.core.transform_elim import PlannedGraph
from repro_torch.engine.executor import CompiledModel, compile_model
from repro_torch.nn.init import Params, init_params

SESSION_DTYPES = ("fp32", "int8")

if TYPE_CHECKING:
    from repro_torch.engine.lm_session import LMSession
    from repro_torch.models.lm.config import LMConfig


# ---------------------------------------------------------------------------
# Plan / graph (de)serialization — the reference's JSON format
# ---------------------------------------------------------------------------

def _enc_attr(v: Any) -> Any:
    if isinstance(v, Layout):
        return {"__layout__": v.kind.value, "block": v.block}
    if isinstance(v, tuple):
        return {"__tuple__": [_enc_attr(x) for x in v]}
    return v


def _dec_attr(v: Any) -> Any:
    if isinstance(v, dict) and "__layout__" in v:
        kind = LayoutKind(v["__layout__"])
        return Layout(kind, v["block"]) if kind is LayoutKind.NCHWc \
            else Layout(kind)
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_dec_attr(x) for x in v["__tuple__"])
    return v


def _graph_to_json(g: Graph) -> Dict[str, Any]:
    return {"nodes": [{"name": n.name, "op": n.op, "inputs": list(n.inputs),
                       "attrs": {k: _enc_attr(v) for k, v in n.attrs.items()},
                       "shape": list(n.shape) if n.shape else None}
                      for n in g.topo_order()],
            "outputs": list(g.outputs)}


def _graph_from_json(js: Dict[str, Any]) -> Graph:
    g = Graph()
    for rec in js["nodes"]:           # serialized in topo order
        g.add(rec["name"], rec["op"], rec["inputs"],
              **{k: _dec_attr(v) for k, v in rec["attrs"].items()})
        if rec["shape"] is not None:
            g.nodes[rec["name"]].shape = tuple(rec["shape"])
    for o in js["outputs"]:
        g.mark_output(o)
    return g


def _plan_to_json(plan: Plan) -> Dict[str, Any]:
    p = plan.planned
    return {
        "mode": plan.mode,
        "graph": _graph_to_json(p.graph),
        "layouts": {name: _enc_attr(lay) for name, lay in p.layouts.items()},
        "schedules": {name: dataclasses.asdict(s)
                      for name, s in p.schedules.items()},
        "n_transforms": p.n_transforms,
        "transform_bytes_total": p.transform_bytes_total,
        "predicted": {"conv_s": plan.predicted_conv_s,
                      "transform_s": plan.predicted_transform_s,
                      "epilogue_s": plan.predicted_epilogue_s},
        "report": plan.report.to_json() if plan.report else None,
    }


def _plan_from_json(js: Dict[str, Any]) -> Plan:
    planned = PlannedGraph(
        graph=_graph_from_json(js["graph"]),
        layouts={name: _dec_attr(v) for name, v in js["layouts"].items()},
        schedules={name: ConvSchedule(**s)
                   for name, s in js["schedules"].items()},
        n_transforms=js["n_transforms"],
        transform_bytes_total=js["transform_bytes_total"])
    pred = js["predicted"]
    # solution/fusion/report are plan-time provenance, not needed to execute
    return Plan(planned=planned, mode=js["mode"], solution=None,
                predicted_conv_s=pred["conv_s"],
                predicted_transform_s=pred["transform_s"],
                predicted_epilogue_s=pred["epilogue_s"])


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

class InferenceSession:
    """One compiled model: plans + bound weights, specialized per batch
    size.  Create with :func:`compile`.

    ``specialize`` is thread-safe: concurrent requests for the same new
    batch size compile it exactly once."""

    def __init__(self, *, graph: Graph,
                 base_shapes: Dict[str, Tuple[int, ...]],
                 params: Params, pipeline: Pipeline,
                 db: Optional[ScheduleDatabase] = None,
                 tuning: str = "roofline",
                 machine: MachineModel = H100,
                 dispatch: str = "whole",
                 dtype: str = "fp32",
                 use_kernel: bool = True) -> None:
        if dtype not in SESSION_DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {SESSION_DTYPES}")
        if dtype == "int8" and use_kernel:
            raise ValueError(
                "dtype='int8' needs use_kernel=False: the conv kernel has "
                "no int8 instantiation, and int8 schedules run on the "
                "lowerings")
        self._graph = graph
        self._base_shapes = {k: tuple(v) for k, v in base_shapes.items()}
        self._params = params
        self.pipeline = pipeline
        self.db = db if db is not None else ScheduleDatabase()
        self.tuning = tuning
        self.machine = machine
        self.dispatch = dispatch
        # "int8": specializations enumerate quantized schedules; the search
        # decides per conv, so the bound plan may be mixed-precision
        self.dtype = dtype
        self.use_kernel = use_kernel
        self._specialized: Dict[int, CompiledModel] = {}
        # serializes planning/binding: two threads racing on the same new
        # batch size must not double-compile
        self._lock = threading.RLock()

    @property
    def input_spec(self) -> Dict[str, Tuple[int, ...]]:
        return dict(self._base_shapes)

    @property
    def batch_sizes(self):
        return sorted(self._specialized)

    def plan_for(self, batch: int) -> Plan:
        return self.specialize(batch).plan

    def _shapes_for(self, batch: int) -> Dict[str, Tuple[int, ...]]:
        return {k: (batch,) + v[1:] for k, v in self._base_shapes.items()}

    def specialize(self, batch: int) -> CompiledModel:
        """The executable for one batch size, planning+binding on first
        use.  Double-checked under the session lock, so concurrent callers
        of an unseen batch size plan+compile it exactly once."""
        m = self._specialized.get(batch)     # lock-free fast path
        if m is not None:
            return m
        with self._lock:
            m = self._specialized.get(batch)
            if m is not None:                # another thread won the race
                return m
            plan = self.pipeline.run(
                self._graph, self._shapes_for(batch), db=self.db,
                tuning=self.tuning, quantize=(self.dtype == "int8"),
                machine=self.machine)
            m = compile_model(plan, self._params, dispatch=self.dispatch,
                              use_kernel=self.use_kernel)
            self._specialized[batch] = m
            return m

    def __call__(self, inputs: Dict[str, torch.Tensor]):
        batch = int(next(iter(inputs.values())).shape[0])
        return self.specialize(batch)(inputs)

    def predict(self, x: torch.Tensor):
        """Single-input convenience (the common CNN case); dispatches to
        the batch-size specialization of ``x``.  Returns the graph's
        output, or the tuple of its outputs where it has several (SSD's
        ``loc_cat`` and ``conf_cat``)."""
        return self.specialize(int(x.shape[0])).predict(x)


# ---------------------------------------------------------------------------
# compile(): the public front door
# ---------------------------------------------------------------------------

def compile(model: Union[str, Graph, "LMConfig"],        # noqa: A001
            input_spec: Union[Dict[str, Tuple[int, ...]],
                              Tuple[int, ...], None] = None, *,
            params: Optional[Params] = None,
            tuning: str = "roofline",
            pipeline: Optional[Pipeline] = None,
            db: Optional[ScheduleDatabase] = None,
            machine: MachineModel = H100,
            seed: int = 0,
            dispatch: str = "whole",
            device="cuda",
            dtype: str = "fp32",
            use_kernel: bool = True,
            eager: bool = True) -> Union[InferenceSession, "LMSession"]:
    """Build an :class:`InferenceSession` for a model.

    model       zoo name (``"resnet-50"``) or a ``core.graph.Graph``; an
                LM architecture name (``"qwen2-1.5b"``) or ``LMConfig``
                goes to ``compile_lm`` and returns an ``LMSession``
    input_spec  ``{input_name: NCHW shape}``, or a single NCHW tuple for
                one-input models (zoo names may omit it for the builder's
                default resolution: 224, inception-v3's 299,
                ssd-resnet-50's 512); for an LM the ``(batch, max_len)``
                token shape
    params      logical parameters on ``device`` (default: ``init_params``
                drawn from ``seed``, the reference's draws)
    tuning      "roofline" — analytical schedule ranking (default);
                "cached"   — reuse what the schedule database holds,
                             analytical for misses
    pipeline    a ``core.pipeline.Pipeline``; default is the full ladder
                (``Pipeline.preset("fusion")``)
    machine     the ``MachineModel`` plans are priced on (H100 default)
    device      where parameters live and the model runs: "cuda" (default)
                launches the hand-written kernels; "cpu" runs their plain
                versions
    dtype       "fp32" (default), or "int8": the search also ranks
                per-output-channel W8-quantized schedules and picks per
                conv; weights quantize once at bind time, and the
                dequantize scale folds into the fused epilogue like a BN
                scale.  Needs ``use_kernel=False``
    use_kernel  True (default): every blocked conv on the conv kernel
                (B1), which ignores the schedule's variant, as the
                reference's Pallas path does; False: every blocked conv on
                its schedule's lowering (per_tap, tap_stack, scan,
                patch_gemm, and the int8 forms) as torch ops, the
                reference's ``use_pallas=False`` path.  The reference's
                default is the lowerings; the port's is the kernel
    eager       plan + bind the input_spec's batch size now (default); the
                session still specializes other batch sizes on demand
    """
    from repro_torch.models.cnn import build as build_zoo

    # LM dispatch: an LMConfig (or assigned-LM-architecture name) routes
    # to the LM arm — one compiler front door, two workload families.
    # input_spec is then the (batch, max_len) token shape.
    from repro_torch.models.lm import LMConfig as _LMConfig
    lm_model = None
    if isinstance(model, _LMConfig):
        lm_model = model
    elif isinstance(model, str):
        from repro_torch.configs import ARCHS as _LM_ARCHS
        if model in _LM_ARCHS:
            lm_model = model
    if lm_model is not None:
        from repro_torch.engine.lm_session import compile_lm
        spec = input_spec
        if isinstance(spec, dict):
            if len(spec) != 1:
                raise ValueError("LM models take exactly one token input; "
                                 f"got spec keys {sorted(spec)}")
            (spec,) = spec.values()
        if spec is None or len(tuple(spec)) != 2:
            raise ValueError(
                "compile(<LM model>, ...) needs input_spec as the "
                f"(batch, max_len) token shape; got {input_spec!r}")
        b, max_len = (int(v) for v in spec)
        return compile_lm(lm_model, max_len=max_len, batch=b, seed=seed,
                          params=params, device=device)

    if isinstance(model, Graph):
        if not isinstance(input_spec, dict):
            raise ValueError("compile(Graph, ...) needs input_spec as a "
                             "{input_name: shape} dict")
        graph, shapes = model, {k: tuple(v) for k, v in input_spec.items()}
    else:
        if input_spec is None:
            graph, shapes = build_zoo(model)
        else:
            if isinstance(input_spec, dict):
                if len(input_spec) != 1:
                    raise ValueError(
                        f"zoo models take exactly one input; got spec keys "
                        f"{sorted(input_spec)} — pass a Graph for "
                        "multi-input models")
                (shape,) = (tuple(v) for v in input_spec.values())
            else:
                shape = tuple(input_spec)
            if len(shape) != 4:
                raise ValueError(f"expected an NCHW shape, got {shape}")
            # the zoo builders are parameterized by (batch, image) only
            if shape[1] != 3 or shape[2] != shape[3]:
                raise ValueError(
                    f"zoo models take square RGB inputs (N, 3, S, S); got "
                    f"{shape} — build the graph yourself for other shapes")
            graph, shapes = build_zoo(model, batch=shape[0], image=shape[2])
    if params is None:
        params = init_params(graph, shapes, seed=seed, device=device)
    sess = InferenceSession(
        graph=graph, base_shapes=shapes, params=params,
        pipeline=pipeline or Pipeline.preset("fusion"), db=db,
        tuning=tuning, machine=machine, dispatch=dispatch, dtype=dtype,
        use_kernel=use_kernel)
    if eager:
        sess.specialize(next(iter(shapes.values()))[0])
    return sess
