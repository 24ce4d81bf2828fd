"""Inference sessions: compile once, predict per batch size, persist.

``compile(model, input_spec, ...)`` owns the NeoCPU lifecycle the paper
argues belongs to one system (§3): it runs a pass ``Pipeline`` over the
graph, keeps the schedule database, binds parameters once, and specializes
the executable per batch size on demand.

    session = compile("resnet-50", (1, 3, 224, 224))          # on "cuda"
    y = session.predict(x)
    session.save("artifact/")
    # ... fresh process ...
    y2 = InferenceSession.load("artifact/").predict(x)   # bit-identical

``use_kernel`` (default True) runs every blocked conv on the hand-written
conv kernel; ``use_kernel=False`` runs each on its schedule's lowering, the
reference's ``use_pallas=False`` path, which ``dtype="int8"`` sessions need.

The session is also the persistence boundary.  ``save`` writes the
reference's version-5 artifact (``repro/engine/session.py``) — the plan of
every specialization, its bound (pre-laid) weights through
``checkpoint.store.CheckpointStore``, the schedule database's measured
entries, the transform bandwidth, ``quantized.json`` for int8 sessions and,
optionally, the logical graph and raw weights under ``source/`` — with a
SHA-256 of every file.  ``load`` verifies every checksum before it reads
anything, and goes load -> predict with **zero schedule searches**
(``core.local_search.search_calls()`` is the spy) and no re-binding.  An
artifact saved by either package loads in the other: the port's
``use_kernel`` is the manifest's ``"use_pallas"``, both ways, so a
reference artifact with the reference's default ``use_pallas=False``
(panel-major ``patch_gemm`` weights) loads onto the lowerings.  The port
writes ``"interpret": true`` (what the reference's CPU needs for its Pallas
path) and ignores it on load.

Artifact layout (version 5):

    <path>/manifest.json   format, version, input spec, tuning,
                           transform_bw, schedule-db blob, the
                           "specializations" table (batch -> plan file), a
                           "checksums" table (relative path -> SHA-256 of
                           every other file), "quantized" (None, or a
                           reference to quantized.json), "lm" (None for a
                           CNN session), and an optional "source" section
                           (the logical graph) that — with <path>/source/
                           — lets a loaded session specialize unseen batch
                           sizes
    <path>/plans/          batch_<b>.json: one specialization's plan
    <path>/weights/        CheckpointStore; step_<batch>/ holds the bound
                           params of one specialization
    <path>/quantized.json  (int8 sessions only) the scheme and the per-conv
                           dtype map of every specialization
    <path>/source/         CheckpointStore (one step): the raw logical
                           params, present iff manifest["source"] is

Integrity: ``save`` builds the whole artifact in a sibling temp directory
and swaps it in, so a crash mid-save never leaves a half-written artifact
where a loadable one stood.  A checksum mismatch, a truncated blob or
unparseable JSON raises :class:`ArtifactCorruptError`; a structurally
broken or unsupported artifact :class:`ArtifactError`; both subclass
``ValueError``.  Older artifacts load through the reference's migration
chain (``register_migration``: v1 -> v5); one whose checksums migrated to
``None`` loads with one :class:`UnverifiedArtifactWarning`, and a re-save
backfills them.  A future version is refused.  Sessions batch-sharded over
several devices (the manifest's ``"devices"``) wait for the multi-chip
slice (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import threading
import warnings
from pathlib import Path
from typing import (TYPE_CHECKING, Any, Callable, Dict, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.checkpoint.store import (CheckpointStore, dir_checksums,
                                          sha256_file)
from repro_torch.core.cost import MachineModel, machine_for
from repro_torch.core.graph import Graph
from repro_torch.core.layout import Layout, LayoutKind
from repro_torch.core.local_search import ScheduleDatabase
from repro_torch.core.pipeline import MODES, Pipeline, Plan
from repro_torch.core.schedule import ConvSchedule
from repro_torch.core.transform_elim import PlannedGraph
from repro_torch.engine.executor import CompiledModel, compile_model
from repro_torch.engine.telemetry import SizeHistogram
from repro_torch.nn.init import Params, init_params

ARTIFACT_FORMAT = "neocpu-inference-session"
ARTIFACT_VERSION = 5

SESSION_DTYPES = ("fp32", "int8")

if TYPE_CHECKING:
    from repro_torch.engine.lm_session import LMSession
    from repro_torch.models.lm.config import LMConfig


class ArtifactError(ValueError):
    """A saved artifact cannot be loaded: missing, structurally invalid,
    or from an unsupported version.  Subclasses ``ValueError`` so
    pre-typed callers keep working."""


class UnverifiedArtifactWarning(UserWarning):
    """A pre-v3 artifact is loading without checksum verification (its
    manifest predates the integrity table).  Re-saving the loaded session
    backfills the checksums."""


class ArtifactCorruptError(ArtifactError):
    """The artifact's bytes do not match what was saved: a checksum
    mismatch, a truncated blob, or unparseable JSON.  Corrupt weights are
    *refused*, never silently served."""


# version -> hook upgrading a manifest from exactly that version to the
# next one; load() walks the chain until ARTIFACT_VERSION is reached
_MIGRATIONS: Dict[int, Callable[[Dict[str, Any], Path], Dict[str, Any]]] = {}


def register_migration(from_version: int) -> Callable:
    """Decorator: install a manifest migration hook for ``from_version``.
    The hook receives (manifest, artifact_path), mutates/returns the
    manifest in the *next* version's shape, and must bump "version"."""
    def deco(fn: Callable[[Dict[str, Any], Path], Dict[str, Any]]):
        _MIGRATIONS[from_version] = fn
        return fn
    return deco


@register_migration(1)
def _migrate_v1_to_v2(manifest: Dict[str, Any], path: Path) -> Dict[str, Any]:
    """v1 -> v2: per-batch plans moved from "batches" to "specializations";
    v1 never packed the logical graph + raw weights, so "source" is absent
    (the loaded session stays frozen)."""
    manifest["specializations"] = manifest.pop("batches")
    manifest["source"] = None
    manifest["version"] = 2
    return manifest


@register_migration(2)
def _migrate_v2_to_v3(manifest: Dict[str, Any], path: Path) -> Dict[str, Any]:
    """v2 -> v3: per-file SHA-256 checksums and per-batch plan files.
    Pre-v3 artifacts recorded neither, so "checksums" is marked absent
    (the artifact loads unverified) and the inline plan dicts stay where
    they are (the loader accepts both)."""
    manifest["checksums"] = None
    manifest["version"] = 3
    return manifest


@register_migration(3)
def _migrate_v3_to_v4(manifest: Dict[str, Any], path: Path) -> Dict[str, Any]:
    """v3 -> v4: the optional quantized payload.  Pre-v4 artifacts are
    all fp32, so "quantized" is absent."""
    manifest["quantized"] = None
    manifest["version"] = 4
    return manifest


@register_migration(4)
def _migrate_v4_to_v5(manifest: Dict[str, Any], path: Path) -> Dict[str, Any]:
    """v4 -> v5: the optional ``lm`` section (LM sessions).  Pre-v5
    artifacts are all CNN sessions, so "lm" is absent."""
    manifest["lm"] = None
    manifest["version"] = 5
    return manifest


def read_manifest(path: Path) -> Dict[str, Any]:
    """An artifact's manifest, migrated to ``ARTIFACT_VERSION`` — or the
    typed error."""
    try:
        raw = (path / "manifest.json").read_text()
    except FileNotFoundError as e:
        raise ArtifactError(
            f"{path} is not a saved artifact: no manifest.json "
            f"({e})") from e
    try:
        manifest = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ArtifactCorruptError(
            f"{path}/manifest.json is corrupt (not valid JSON): {e}") from e
    if (not isinstance(manifest, dict)
            or manifest.get("format") != ARTIFACT_FORMAT):
        raise ArtifactError(f"{path} is not a {ARTIFACT_FORMAT} artifact")
    version = manifest.get("version")
    if not isinstance(version, int) or version > ARTIFACT_VERSION:
        raise ArtifactError(
            f"artifact version {version!r} is newer than this build "
            f"supports ({ARTIFACT_VERSION}); re-save the session with "
            "a matching version")
    while version < ARTIFACT_VERSION:
        hook = _MIGRATIONS.get(version)
        if hook is None:
            raise ArtifactError(
                f"artifact version {version} has no migration hook to "
                f"{version + 1}; re-save the session with this build")
        try:
            manifest = hook(manifest, path)
        except (KeyError, TypeError, AttributeError) as e:
            raise ArtifactError(
                f"artifact manifest is not a valid version {version}: "
                f"{e!r}") from e
        if manifest.get("version") == version:   # buggy hook guard
            raise ArtifactError(
                f"migration hook for version {version} did not "
                "advance the manifest version")
        version = manifest["version"]
    return manifest


def verify_checksums(path: Path, manifest: Dict[str, Any]) -> None:
    """The integrity gate, before anything is deserialized: every
    checksummed file must be present and match, or the typed error.  A
    manifest without checksums (pre-v3) warns once and loads
    unverified."""
    checksums = manifest.get("checksums")
    if isinstance(checksums, dict):
        for rel, want in checksums.items():
            f = path / rel
            if not f.is_file():
                raise ArtifactCorruptError(
                    f"artifact file {rel} is listed in the manifest "
                    f"checksums but missing from {path} (corrupt or "
                    "partially-copied artifact)")
            got = sha256_file(f)
            if got != want:
                raise ArtifactCorruptError(
                    f"artifact file {rel} is corrupt: sha256 {got} "
                    f"does not match the manifest's {want}")
    else:
        warnings.warn(
            f"artifact {path} predates checksums (pre-v3) and is "
            "loading UNVERIFIED: its payloads cannot be integrity-"
            "checked.  Re-save the loaded session to backfill "
            "checksums and upgrade it in place.",
            UnverifiedArtifactWarning, stacklevel=3)


def write_artifact(tmp: Path, path: Path, manifest: Dict[str, Any]) -> Path:
    """Finish a save built in ``tmp``: checksum every file into
    ``manifest``, write it, and swap ``tmp`` in at ``path``, so a crash at
    any point leaves the previous complete artifact or the new one."""
    manifest["checksums"] = dir_checksums(tmp)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if path.exists():
        old = path.parent / f".{path.name}.old-save"
        if old.exists():
            shutil.rmtree(old)
        path.rename(old)
        tmp.rename(path)
        shutil.rmtree(old)
    else:
        tmp.rename(path)
    return path


def fresh_tmp(path: Path) -> Path:
    """The sibling temp directory a save builds its artifact in."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp-save"
    if tmp.exists():
        shutil.rmtree(tmp)           # leftover of a crashed save
    tmp.mkdir()
    return tmp


def refuse_devices(devices) -> None:
    if devices not in (None, 1):
        raise ArtifactError(
            f"devices={devices}: batch-sharded sessions wait for the "
            "multi-chip slice (ROADMAP A10); the port loads devices=1 "
            "artifacts")


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


def _params_to_flat_ok(params: Params) -> Params:
    """Param leaf names ('w', 'b', 'scale', ...) never contain dots, so the
    CheckpointStore's dotted flat paths split back unambiguously."""
    for p in params.values():
        for leaf in p:
            assert "." not in leaf, f"param leaf {leaf!r} would not round-trip"
    return params


def _params_from_flat(leaves: Dict[str, torch.Tensor], device) -> Params:
    out: Params = {}
    for path, t in leaves.items():
        node, leaf = path.rsplit(".", 1)
        out.setdefault(node, {})[leaf] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

class InferenceSession:
    """One compiled model: plans + bound weights, specialized per batch
    size.  Create with :func:`compile`; persist with :meth:`save` /
    :meth:`load`.  Sessions loaded from an artifact *without* a packed
    source are *frozen*: they execute their saved specializations but
    cannot plan new batch sizes.  Artifacts saved with
    ``include_source=True`` (the default when the session has its graph)
    also pack the logical graph + raw weights, so the loaded session can
    specialize unseen batch sizes (on its ``machine``).  Under
    ``tuning="measured"`` a specialization searches on the session's
    ``device`` and engine, and the relayout bandwidth it calibrates is
    kept in ``transform_bw`` for later batch sizes and the artifact.

    ``specialize`` is thread-safe: concurrent requests for the same new
    batch size compile it exactly once."""

    def __init__(self, *, graph: Optional[Graph],
                 base_shapes: Dict[str, Tuple[int, ...]],
                 params: Optional[Params],
                 pipeline: Optional[Pipeline],
                 db: Optional[ScheduleDatabase] = None,
                 tuning: str = "roofline",
                 transform_bw: Optional[float] = None,
                 search_budget: Tuple[int, int, int] = (6, 2, 3),
                 machine: Optional[MachineModel] = None,
                 dispatch: str = "whole",
                 dtype: str = "fp32",
                 use_kernel: bool = True,
                 model_name: Optional[str] = None,
                 device="cuda") -> None:
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
        self.transform_bw = transform_bw
        # the measured search's (top_k, per_variant, repeats); carried
        # through artifacts so a reference artifact's survives a round trip
        self.search_budget = tuple(search_budget)
        self.machine = machine or machine_for(use_kernel)
        # where the weights live, the model runs and measured tuning times
        self.device = torch.device(device)
        self.dispatch = dispatch
        # "int8": specializations enumerate quantized schedules; the search
        # decides per conv, so the bound plan may be mixed-precision
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.model_name = model_name
        self._specialized: Dict[int, CompiledModel] = {}
        # request-size arrivals (fed by a serving driver, or by hand); what
        # save(buckets="auto") learns the next artifact's bucket set from
        self.traffic = SizeHistogram()
        # serializes planning/binding: two threads racing on the same new
        # batch size must not double-compile
        self._lock = threading.RLock()

    # -- introspection -------------------------------------------------------
    @property
    def input_spec(self) -> Dict[str, Tuple[int, ...]]:
        return dict(self._base_shapes)

    @property
    def batch_sizes(self):
        return sorted(self._specialized)

    @property
    def frozen(self) -> bool:
        """True for artifact-loaded sessions with no source to re-plan."""
        return self._graph is None

    def plan_for(self, batch: int) -> Plan:
        return self.specialize(batch).plan

    # -- compilation ---------------------------------------------------------
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
            if self.frozen:
                raise RuntimeError(
                    f"session loaded from an artifact has no batch-{batch} "
                    f"specialization (saved: {self.batch_sizes}) and no "
                    "source graph to re-plan; save the artifact with this "
                    "batch size or with include_source=True")
            plan = self.pipeline.run(
                self._graph, self._shapes_for(batch), db=self.db,
                tuning=self.tuning, quantize=(self.dtype == "int8"),
                transform_bw=self.transform_bw, machine=self.machine,
                search_budget=self.search_budget, device=self.device,
                use_kernel=self.use_kernel)
            if (plan.report is not None
                    and plan.report.transform_bw is not None):
                # calibrated once (measured tuning); reused by later
                # specializations and kept in the saved artifact
                self.transform_bw = plan.report.transform_bw
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

    # -- memory accounting ---------------------------------------------------
    def memory_bytes(self) -> Dict[int, int]:
        """Bytes of bound parameters held per specialization — what a
        fleet memory budget accounts and what :meth:`release` frees."""
        with self._lock:
            return {batch: sum(int(t.nbytes) for node in m.params.values()
                               for t in node.values())
                    for batch, m in self._specialized.items()}

    def release(self, batch: int) -> bool:
        """Drop the compiled specialization for ``batch``, freeing its
        bound params.  Returns True iff it existed.  A later
        ``specialize(batch)`` rebuilds it.  Frozen sessions refuse: they
        could never specialize it back."""
        with self._lock:
            if self.frozen:
                raise RuntimeError(
                    "cannot release a specialization of a frozen session "
                    "(no source graph to rebuild it from); its buckets "
                    "are pinned")
            return self._specialized.pop(batch, None) is not None

    # -- persistence ---------------------------------------------------------
    def save(self, path: Union[str, Path],
             include_source: Optional[bool] = None,
             buckets: Union[None, str, Sequence[int]] = None,
             traffic=None) -> Path:
        """Write the version-5 artifact: every current specialization's
        plan + bound weights, the schedule database's measured entries,
        and the transform bandwidth.

        ``include_source`` additionally packs the logical graph and raw
        weights so the loaded session can specialize unseen batch sizes
        (default: whenever the session has them).

        ``buckets`` selects which batch-size specializations the artifact
        carries (default ``None``: all current ones).  An explicit list
        specializes and saves exactly those sizes; ``"auto"`` solves the
        set from recorded arrivals (:func:`engine.traffic.solve_buckets`)
        — ``traffic`` may be a ``SizeHistogram`` or a ``{size: count}``
        mapping, default this session's ``traffic``.  The solved set and
        its histogram go into the manifest's ``traffic`` section."""
        if include_source is None:
            include_source = (self._graph is not None
                              and self._params is not None)
        if include_source and (self._graph is None or self._params is None):
            raise RuntimeError("include_source=True but this session has "
                               "no logical graph/raw weights (loaded from "
                               "a sourceless artifact)")
        chosen, traffic_meta = self._resolve_buckets(buckets, traffic)
        if chosen is not None:
            for b in chosen:
                self.specialize(b)       # no-op for already-bound sizes
        # under the session lock: a worker specializing a new batch size
        # mid-save must not change the dict between weights and manifest
        with self._lock:
            return self._save_locked(Path(path), include_source,
                                     only=chosen, traffic_meta=traffic_meta)

    def _resolve_buckets(self, buckets, traffic):
        """Normalize save()'s bucket selection: None (keep all), an
        explicit size list, or "auto" (solve from measured traffic)."""
        if buckets is None:
            if traffic is not None:
                raise ValueError("traffic= is only meaningful with "
                                 "buckets='auto'")
            return None, None
        from repro_torch.engine import traffic as traffic_mod

        if buckets == "auto":
            hist = traffic if traffic is not None else self.traffic
            counts = traffic_mod._coerce_counts(hist)
            if not counts:
                raise ValueError(
                    "buckets='auto' needs recorded traffic: add arrival "
                    "sizes to session.traffic, or pass traffic= a "
                    "histogram")
            solved = traffic_mod.solve_buckets(counts)
            meta = {"mode": "auto",
                    "histogram": {str(s): c
                                  for s, c in sorted(counts.items())},
                    "buckets": list(solved),
                    "expected_waste": traffic_mod.expected_padded_waste(
                        counts, solved)}
            return sorted(solved), meta
        chosen = sorted({int(b) for b in buckets})
        if not chosen or any(b < 1 for b in chosen):
            raise ValueError(f"buckets must be sizes >= 1, got {buckets}")
        if self.frozen:
            missing = [b for b in chosen if b not in self._specialized]
            if missing:
                raise RuntimeError(
                    f"frozen session cannot specialize buckets {missing} "
                    f"(has {self.batch_sizes})")
        return chosen, {"mode": "explicit", "buckets": chosen}

    def _save_locked(self, path: Path, include_source: bool,
                     only=None, traffic_meta=None) -> Path:
        if not self._specialized:
            raise RuntimeError("nothing to save: session has no "
                               "specializations (call predict/specialize)")
        # the whole artifact is built in a sibling temp dir and swapped
        # in (write_artifact): a crash at any point leaves the previous
        # complete artifact or the new one, never a mixture
        tmp = fresh_tmp(path)
        saved = {batch: m for batch, m in sorted(self._specialized.items())
                 if only is None or batch in only}
        store = CheckpointStore(tmp / "weights")
        for batch, m in saved.items():
            store.save(step=batch, tree=_params_to_flat_ok(m.params),
                       meta={"batch": batch})
        source = None
        if include_source:
            CheckpointStore(tmp / "source").save(
                step=0, tree=_params_to_flat_ok(self._params),
                meta={"kind": "logical-params"})
            source = {
                "graph": _graph_to_json(self._graph),
                # only presets reconstruct exactly; a custom pipeline's
                # loaded session re-plans with the default preset
                "pipeline": (self.pipeline.name
                             if self.pipeline
                             and self.pipeline.name in MODES else None),
                "search_budget": list(self.search_budget),
            }
        (tmp / "plans").mkdir()
        specs = {}
        for batch, m in saved.items():
            rel = f"plans/batch_{batch:05d}.json"
            (tmp / rel).write_text(json.dumps(_plan_to_json(m.plan)))
            specs[str(batch)] = {"file": rel}
        quantized = None
        if self.dtype == "int8":
            # the scheme and which convs bound int8 codes (the search
            # decides per conv), checksummed like any other file
            (tmp / "quantized.json").write_text(json.dumps({
                "dtype": self.dtype,
                "scheme": ("w8: per-output-channel symmetric int8 weights, "
                           "qmax 127, dequantize scale folded into the "
                           "epilogue scale operand"),
                "schedule_dtypes": {
                    str(batch): {name: s.dtype for name, s in
                                 m.plan.planned.schedules.items()}
                    for batch, m in saved.items()},
            }))
            quantized = {"file": "quantized.json", "dtype": self.dtype}
        manifest = {
            "format": ARTIFACT_FORMAT,
            "version": ARTIFACT_VERSION,
            "model": self.model_name,
            "tuning": self.tuning,
            "transform_bw": self.transform_bw,
            "pipeline": self.pipeline.name if self.pipeline else None,
            "input_spec": {k: list(v) for k, v in self._base_shapes.items()},
            # the reference's name for the path: use_pallas=True is the
            # kernel, False the lowerings (pre-laid patch_gemm weights)
            "use_pallas": self.use_kernel,
            # what the reference's CPU needs to run its Pallas path
            "interpret": True,
            "dispatch": self.dispatch,
            "devices": 1,
            "specializations": specs,
            "quantized": quantized,
            "source": source,
            "traffic": traffic_meta,
            "lm": None,
            # measured winners only: analytical rankings are re-derivable
            "db": self.db.to_blob(measured_only=True),
        }
        return write_artifact(tmp, path, manifest)

    @classmethod
    def load(cls, path: Union[str, Path], *, device="cuda",
             dispatch: Optional[str] = None,
             devices: Optional[int] = None) -> "InferenceSession":
        """Reconstruct a session from :meth:`save` output (of either
        package), its weights on ``device``.  No planning, no schedule
        search, no weight transformation happens.  Older versions migrate;
        future versions are refused.  If the artifact packs its source,
        the loaded session is not frozen and may specialize unseen batch
        sizes on the H100 machine model of its engine.  ``devices`` other
        than 1 waits for the multi-chip slice (ROADMAP A10)."""
        path = Path(path)
        refuse_devices(devices)
        manifest = read_manifest(path)
        if manifest.get("lm"):
            raise ArtifactError(
                f"{path} is an LM artifact (seq-bucketed prefill + decode); "
                "load it with repro_torch.engine.LMSession.load")
        refuse_devices(manifest.get("devices", 1))
        verify_checksums(path, manifest)
        db = ScheduleDatabase()
        db.load_blob(manifest.get("db", {}))
        source = manifest.get("source")
        graph = params = pipeline = None
        if source is not None:
            graph = _graph_from_json(source["graph"])
            try:
                leaves, _, _ = CheckpointStore(
                    path / "source").restore_flat(step=0)
            except (ValueError, FileNotFoundError, KeyError) as e:
                raise ArtifactCorruptError(
                    f"artifact source weights under {path}/source are "
                    f"corrupt or incomplete: {e}") from e
            params = _params_from_flat(leaves, device)
            pipeline = Pipeline.preset(source.get("pipeline") or "fusion")
        sess = cls(graph=graph,
                   base_shapes={k: tuple(v) for k, v in
                                manifest["input_spec"].items()},
                   params=params, pipeline=pipeline, db=db,
                   tuning=manifest["tuning"],
                   transform_bw=manifest.get("transform_bw"),
                   search_budget=tuple(
                       (source or {}).get("search_budget", (6, 2, 3))),
                   dispatch=dispatch or manifest.get("dispatch", "whole"),
                   dtype=(manifest.get("quantized") or {}).get("dtype",
                                                               "fp32"),
                   use_kernel=bool(manifest.get("use_pallas", False)),
                   model_name=manifest.get("model"), device=device)
        store = CheckpointStore(path / "weights")
        specs = manifest.get("specializations")
        if not isinstance(specs, dict):
            raise ArtifactCorruptError(
                f"{path} manifest has no specializations table (corrupt "
                "artifact)")
        for bstr, plan_js in specs.items():
            batch = int(bstr)
            if isinstance(plan_js, dict) and set(plan_js) == {"file"}:
                # v3+: the plan as an external per-batch file (already
                # checksum-verified when the manifest carries sums)
                try:
                    plan_js = json.loads((path / plan_js["file"])
                                         .read_text())
                except FileNotFoundError as e:
                    raise ArtifactCorruptError(
                        f"artifact plan for batch {batch} is missing: "
                        f"{e}") from e
                except json.JSONDecodeError as e:
                    raise ArtifactCorruptError(
                        f"artifact plan for batch {batch} is corrupt "
                        f"(not valid JSON): {e}") from e
            try:
                plan = _plan_from_json(plan_js)
                leaves, _, _ = store.restore_flat(step=batch)
            except (ValueError, FileNotFoundError, KeyError) as e:
                raise ArtifactCorruptError(
                    f"artifact specialization for batch {batch} is "
                    f"corrupt or incomplete: {e}") from e
            sess._specialized[batch] = CompiledModel(
                plan=plan, params=_params_from_flat(leaves, device),
                dispatch=sess.dispatch, use_kernel=sess.use_kernel)
        return sess


# Short alias used throughout the docs: Session.load(path).predict(x)
Session = InferenceSession


# ---------------------------------------------------------------------------
# compile(): the public front door
# ---------------------------------------------------------------------------

def compile(model: Union[str, Graph, "LMConfig"],        # noqa: A001
            input_spec: Union[Dict[str, Tuple[int, ...]],
                              Tuple[int, ...], None] = None, *,
            params: Optional[Params] = None,
            tuning: str = "roofline",
            pipeline: Optional[Pipeline] = None,
            db: Union[ScheduleDatabase, str, Path, None] = None,
            transform_bw: Optional[float] = None,
            search_budget: Tuple[int, int, int] = (6, 2, 3),
            machine: Optional[MachineModel] = None,
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
                "cached"   — reuse what the schedule database holds
                             (e.g. measured winners of another session),
                             analytical for misses, never measures;
                "measured" — the guided search (``core.local_search``):
                             the model prunes, the convs the session runs
                             are timed on ``device`` (B1 or the
                             lowerings), and ``transform_bw`` is
                             calibrated on the same clock
    pipeline    a ``core.pipeline.Pipeline``; default is the full ladder
                (``Pipeline.preset("fusion")``)
    db          schedule database instance, or the path of a persisted one
                (read as a snapshot: the session never writes the file)
    transform_bw  bytes/s a layout transform moves at on ``device``, the
                price of a plan's edges (default: the machine's memory
                rate, or the probe's under measured or cached tuning over
                measured entries)
    search_budget  measured tuning's (top_k, per_variant, repeats)
    machine     the ``MachineModel`` plans are priced on (default
                ``core.cost.machine_for(use_kernel)``: the H100 with B1's
                tile, or with the reference's for the lowerings)
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
        model_name = None
    else:
        model_name = model
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
    if isinstance(db, (str, Path)):
        db = ScheduleDatabase(db)
        # read-only snapshot: the session persists its database inside the
        # artifact; cache misses must not rewrite the source file
        db.path = None
    if params is None:
        params = init_params(graph, shapes, seed=seed, device=device)
    sess = InferenceSession(
        graph=graph, base_shapes=shapes, params=params,
        pipeline=pipeline or Pipeline.preset("fusion"), db=db,
        tuning=tuning, transform_bw=transform_bw,
        search_budget=search_budget, machine=machine,
        dispatch=dispatch, dtype=dtype, use_kernel=use_kernel,
        model_name=model_name, device=device)
    if eager:
        sess.specialize(next(iter(shapes.values()))[0])
    return sess
