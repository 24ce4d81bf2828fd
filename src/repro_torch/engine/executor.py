"""Inference engine: planned graph -> executable on one device.

Binding a ``Plan`` to parameters performs §3.2's compile-time weight
transformation once — conv kernels to ``KCRS[x]c[y]k``, BN vectors to the
blocked broadcast shape — then the forward pass executes the rewritten
graph with zero runtime weight relayouts.  For fused ``conv_block`` nodes
(§3.1 operation fusion) binding also folds the absorbed BatchNorm into the
conv (``fold_bn``, the default): the scale multiplies the kernel's output
channels and the shift becomes the block's epilogue vector, so the fused
kernel runs a pure conv + shift + (residual) + ReLU (+ pool) epilogue.  A
conv scheduled in int8 gets per-output-channel int8 codes at bind time,
its dequantize scale in the epilogue's scale.

The port runs eagerly, node by node, on the device its parameters live on.
With ``use_kernel`` (the default) every blocked conv launches the conv
kernel (``kernels/conv2d_nchwc.py``) on a CUDA device and its plain version
on the CPU; with ``use_kernel=False`` every blocked conv runs its
schedule's lowering (variant and dtype) as torch ops on either device, the
reference's ``use_pallas=False`` path.  ``dispatch`` keeps the
reference's two names ("whole", "op"); both walk the graph node by node
here, because the reference's whole-graph ``jax.jit`` has no counterpart
until CUDA-graph capture lands.  ``replica(device)`` is the same program
with its bound parameters on another device, the executable a serving
worker on that device runs.

``devices=D`` executes batch-sharded, as the reference's ``shard_map`` over
a 1-D data mesh does: the parameters are put on each device once (through
``replica``), a batch of B is cut on dim 0 into D shards of B/D rows, each
shard runs the plan built for B/D on its own device, and the outputs are
concatenated in order on the first.  On "cuda" the shards run on
``cuda:0`` to ``cuda:D-1``, all enqueued by the calling thread with no
synchronisation between them (the launches are asynchronous); fewer
visible cards than D raises (``shard_devices``).  On "cpu" the D shards
run in turn, the stand-in for the reference's D forced host devices.

While ``repro_torch.trace.tracing`` is on, a call records one ``predict``
span (its argument the batch) and, under it, one span per graph node walked
(named by the node, its kind the node's op; one clock reading a node, a
node ending where the next begins), those of every shard of a sharded call
included; with tracing off a walk reads the switch once and records
nothing.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from array import array
from typing import Dict, List, Optional

import torch

from repro_torch import trace
from repro_torch.core.epilogue import (EpilogueSpec, PoolSpec,
                                       fold_dequant_scale)
from repro_torch.core.layout import Layout, NCHW, kernel_to_kcrs_ck
from repro_torch.core.pipeline import Plan
from repro_torch.core.quantize import quantize_per_channel
from repro_torch.kernels.ops import prelay_patch_gemm_weight
from repro_torch.nn import ops
from repro_torch.nn.init import Params

DISPATCH_MODES = ("whole", "op")


def _patch_gemm_prelaid(schedule, layout: Layout, use_kernel: bool) -> bool:
    """Whether this conv's weight is stored panel-major at bind time: the
    patch_gemm lowering is the only consumer of the pre-laid form (the
    conv kernel reads KCRS[x]c[y]k).  The one predicate ``bind_params``
    (to transform once) and ``_eval_node`` (to tell the conv what
    arrived) both use."""
    return (not use_kernel and schedule is not None and layout.is_blocked
            and schedule.resolved_variant() == "patch_gemm")


def _block_channel_vec(v: torch.Tensor, layout: Layout) -> torch.Tensor:
    c = v.shape[0]
    if layout.is_blocked:
        x = layout.block
        return v.reshape(c // x, x)[:, None, None, :]      # (C//x, 1, 1, x)
    return v[:, None, None]                                # (C, 1, 1)


def _bind_conv_block(plan: Plan, node, params: Params, fold_bn: bool,
                     use_kernel: bool) -> Dict[str, torch.Tensor]:
    """Fused-block binding: conv weight/bias under the block's own name,
    the absorbed BN's scale/shift under ``attrs["bn_from"]``.  With
    ``fold_bn`` (the default: conv weights are static at bind time) the
    BN scale is multiplied into the kernel's output channels and only the
    shift survives as an epilogue vector; without it the scale rides the
    epilogue's ``scale`` operand.  An int8 schedule then quantizes the
    weight per output channel and folds the dequantize scale into the
    epilogue's scale."""
    p_conv = params[node.name]
    w = p_conv["w"]
    scale: Optional[torch.Tensor] = None
    shift: Optional[torch.Tensor] = None
    if "b" in p_conv:
        shift = p_conv["b"].float()
    bn_from = node.attrs.get("bn_from")
    if bn_from is not None:
        p_bn = params[bn_from]
        s = p_bn["scale"].float()
        t = p_bn["shift"].float()
        # bn(conv(x) + b) = conv(x) * s + (b * s + t)
        shift = t if shift is None else shift * s + t
        scale = s
    if fold_bn and scale is not None:
        w = (w.float() * scale[:, None, None, None]).to(w.dtype)
        scale = None

    lay = plan.planned.layouts[node.name]
    sched = plan.planned.schedules.get(node.name)
    if sched is not None and lay.is_blocked and sched.dtype == "int8":
        # §3.2 extended to numerics: per-output-channel symmetric int8
        # codes replace the fp32 kernel (after any BN fold, so the codes
        # absorb the BN scale), quantized on the host as the reference
        # does, so the codes are the reference's bit for bit; the
        # dequantize scale folds into the epilogue's per-channel scale
        # exactly like an unfolded BN scale.
        wq, w_scale = quantize_per_channel(w.detach().cpu().numpy(), axis=0)
        w = torch.from_numpy(wq).to(w.device)
        scale = fold_dequant_scale(
            scale, torch.from_numpy(w_scale).to(w.device))
    q: Dict[str, torch.Tensor] = {}
    if sched is not None and lay.is_blocked:
        q["w"] = kernel_to_kcrs_ck(w, sched.ic_bn, sched.oc_bn)
        if _patch_gemm_prelaid(sched, lay, use_kernel):
            q["w"] = prelay_patch_gemm_weight(q["w"])

        def blk(v):
            return v.reshape(-1, sched.oc_bn).contiguous()
    else:
        q["w"] = w

        def blk(v):
            return v[:, None, None]
    if scale is not None:
        q["scale"] = blk(scale)
    if shift is not None:
        q["shift"] = blk(shift)
    return q


def bind_params(plan: Plan, params: Params, fold_bn: bool = True,
                use_kernel: bool = True) -> Params:
    """Pre-transform logical parameters to the plan's physical layouts.
    With ``use_kernel=False`` the weights of convs scheduled on the
    ``patch_gemm`` lowering are also pre-laid panel-major (``w_prelaid``),
    so the lowering's run-time weight transpose disappears."""
    g = plan.planned.graph
    out: Params = {}
    consumed = set()
    for node in g.topo_order():
        if node.op != "conv_block":
            continue
        out[node.name] = _bind_conv_block(plan, node, params, fold_bn,
                                          use_kernel)
        consumed.add(node.name)
        if node.attrs.get("bn_from") is not None:
            consumed.add(node.attrs["bn_from"])
    for name, p in params.items():
        if name in consumed:
            continue
        node = g.nodes.get(name)
        if node is None:       # node was renamed/removed by the rewrite
            out[name] = dict(p)
            continue
        lay = plan.planned.layouts[name]
        if node.op == "conv2d" and name in plan.planned.schedules:
            s = plan.planned.schedules[name]
            q = {"w": kernel_to_kcrs_ck(p["w"], s.ic_bn, s.oc_bn)}
            if _patch_gemm_prelaid(s, lay, use_kernel):
                q["w"] = prelay_patch_gemm_weight(q["w"])
            if "b" in p:
                q["b"] = _block_channel_vec(p["b"], lay)
            out[name] = q
        elif node.op == "conv2d":
            q = {"w": p["w"]}
            if "b" in p:
                q["b"] = _block_channel_vec(p["b"], NCHW)
            out[name] = q
        elif node.op == "batch_norm":
            out[name] = {"scale": _block_channel_vec(p["scale"], lay),
                         "shift": _block_channel_vec(p["shift"], lay)}
        else:
            out[name] = dict(p)
    return out


def _eval_node(node, lay: Layout, schedule, use_kernel: bool,
               p: Dict[str, torch.Tensor], *ins: torch.Tensor
               ) -> torch.Tensor:
    """One graph node on already-computed inputs; a conv runs under its
    planned ``schedule``, on the conv kernel or (``use_kernel=False``) the
    schedule's lowering."""
    a = node.attrs
    ph = a.get("pad", 0)
    pw = a.get("pad_w", -1)
    pad = ph if pw < 0 else (ph, pw)
    conv = dict(schedule=schedule, use_kernel=use_kernel,
                w_prelaid=_patch_gemm_prelaid(schedule, lay, use_kernel))
    if node.op == "conv2d":
        return ops.conv2d(ins[0], p["w"], p.get("b"), lay,
                          stride=a.get("stride", 1), pad=pad,
                          groups=a.get("groups", 1), **conv)
    if node.op == "conv_block":
        # inputs: [data, residual?, concat_buf?] — buffer last when fused
        concat_into = bool(a.get("concat_into"))
        out_buf = ins[-1] if concat_into else None
        n_extra = len(ins) - 1 - (1 if concat_into else 0)
        residual = ins[1] if n_extra >= 1 else None
        pool = None
        if a.get("pool_kind"):
            pool = PoolSpec(a["pool_kind"], a["pool_k"], a["pool_stride"],
                            a.get("pool_pad", 0),
                            bool(a.get("pool_ceil", False)))
        spec = EpilogueSpec(
            relu=bool(a.get("relu")), pool=pool,
            concat_offset=a.get("concat_offset", 0) if concat_into else 0,
            concat_total=a.get("concat_total", 0) if concat_into else 0)
        return ops.conv_block(
            ins[0], p["w"], p.get("scale"), p.get("shift"), residual, lay,
            stride=a.get("stride", 1), pad=pad, groups=a.get("groups", 1),
            epilogue=spec, out_buf=out_buf, **conv)
    if node.op == "batch_norm":
        return ops.batch_norm(ins[0], p["scale"], p["shift"], lay)
    if node.op == "relu":
        return ops.relu(ins[0])
    if node.op == "softmax":
        return ops.softmax(ins[0], lay)
    if node.op == "l2_normalize":
        return ops.l2_normalize(ins[0], lay)
    if node.op == "max_pool":
        return ops.max_pool(ins[0], a["k"], a.get("stride", a["k"]),
                            a.get("pad", 0), a.get("ceil_mode", False))
    if node.op == "avg_pool":
        return ops.avg_pool(ins[0], a["k"], a.get("stride", a["k"]),
                            a.get("pad", 0), a.get("ceil_mode", False))
    if node.op == "global_avg_pool":
        return ops.global_avg_pool(ins[0])
    if node.op == "add":
        return ops.add(*ins)
    if node.op == "concat":
        return ops.concat(list(ins), lay)
    if node.op == "concat_alloc":
        return ops.concat_alloc(list(ins), a["offsets"],
                                a["total_channels"], lay)
    if node.op == "flatten":
        return ops.flatten(ins[0])
    if node.op == "reshape":
        return ins[0].reshape(a["shape"])
    if node.op == "dense":
        return ops.dense(ins[0], p["w"], p.get("b"))
    if node.op == "layout_transform":
        return ops.layout_transform(ins[0], a["src_layout"], a["dst_layout"])
    raise NotImplementedError(node.op)


def shard_devices(devices: int, device) -> List[torch.device]:
    """The devices that a model batch-sharded over ``devices`` runs its
    shards on, the first holding its parameters: ``device`` itself for one;
    on "cuda" ``cuda:0`` to ``cuda:D-1``, and ``RuntimeError`` where fewer
    cards are visible (there is no fallback to the CPU); on "cpu" the CPU
    D times (the shards run in turn)."""
    devices = int(devices)
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * devices
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < devices:
        raise RuntimeError(
            f"{devices} CUDA device(s) requested, {found} visible "
            f"(CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES', '<unset>')}); run on "
            f"a host with {devices} cards and CUDA_VISIBLE_DEVICES naming "
            "them, lower devices=, or pass device='cpu' (--device cpu) for "
            "the kernels' plain versions")
    if devices == 1:
        return [_concrete(device)]
    return [torch.device("cuda", i) for i in range(devices)]


@dataclasses.dataclass
class CompiledModel:
    """Callable end-to-end executable for one plan, on the device its
    bound parameters live on; ``devices > 1`` executes batch-sharded (see
    the module docs)."""

    plan: Plan
    params: Params               # pre-transformed (bind_params output)
    dispatch: str = "whole"      # "whole" | "op": both node by node here
    use_kernel: bool = True      # False: the schedules' lowerings
    devices: int = 1             # batch-sharded over this many devices

    def __post_init__(self):
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(f"unknown dispatch mode {self.dispatch!r}")
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.devices > 1 and self.dispatch != "whole":
            raise ValueError("sharded execution (devices > 1) requires "
                             "whole-graph dispatch; per-node dispatch "
                             "would materialize every intermediate "
                             "across the devices")
        self._topo = self.plan.planned.graph.topo_order()
        self._span_ids = (None, None)    # (recorder, (names, kinds))
        self._replicas: Dict[torch.device, "CompiledModel"] = {}
        self._replica_lock = threading.Lock()
        self._shards: List["CompiledModel"] = []
        if self.devices > 1:
            # replicate once at bind, not per call
            here = self.device
            devs = shard_devices(self.devices,
                                 here if here is not None else "cpu")
            self._shards = [self._on(d) for d in devs]

    def _check_batch(self, inputs: Dict[str, torch.Tensor]) -> None:
        for name, v in inputs.items():
            if v.shape[0] % self.devices:
                raise ValueError(
                    f"input {name!r} batch {v.shape[0]} is not divisible "
                    f"by devices={self.devices}; sharded programs need an "
                    "equal per-device sub-batch")

    @torch.inference_mode()
    def __call__(self, inputs: Dict[str, torch.Tensor]):
        rec = trace.active()
        if rec is None:
            return self._call(inputs)
        # name and kind 0: ``predict``, interned first in every recorder
        i = rec.open(0, 0, int(next(iter(inputs.values())).shape[0]))
        try:
            return self._call(inputs)
        finally:
            rec.close(i)

    def _call(self, inputs: Dict[str, torch.Tensor]):
        """One predict: the walk, or each shard's walk in turn."""
        if self.devices == 1:
            return self._walk(inputs)
        self._check_batch(inputs)
        d = self.devices
        outs = []
        for i, shard in enumerate(self._shards):
            dev = shard.device
            part = {k: v[i * (v.shape[0] // d):(i + 1) * (v.shape[0] // d)]
                    for k, v in inputs.items()}
            if dev is not None:
                part = {k: v.to(dev, non_blocking=True)
                        for k, v in part.items()}
            outs.append(shard._walk(part))
        first = self._shards[0].device
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[j].to(first) for o in outs])
                         for j in range(len(outs[0])))
        return torch.cat([o.to(first) for o in outs])

    @torch.inference_mode()
    def _walk(self, inputs: Dict[str, torch.Tensor]):
        """The graph, node by node, on this model's parameters."""
        structure = self.plan.planned
        env: Dict[str, torch.Tensor] = {}
        rec = trace.active()              # the switch, read once a walk
        walk = None if rec is None else rec.walk(*self._node_span_ids(rec))
        try:
            for node in self._topo:
                if node.op == "input":
                    env[node.name] = inputs[node.name]
                    continue
                if walk is not None:
                    walk.step()
                env[node.name] = _eval_node(
                    node, structure.layouts[node.name],
                    structure.schedules.get(node.name), self.use_kernel,
                    self.params.get(node.name, {}),
                    *[env[i] for i in node.inputs])
        finally:
            if walk is not None:
                walk.done()
        outs = [env[o] for o in structure.graph.outputs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _node_span_ids(self, rec) -> tuple:
        """The walked nodes' span names (the nodes') and kinds (their
        ops), interned in ``rec``, in walk order."""
        held, ids = self._span_ids
        if held is not rec:
            nodes = [n for n in self._topo if n.op != "input"]
            ids = (array("q", [rec.intern(n.name) for n in nodes]),
                   array("q", [rec.intern(n.op) for n in nodes]))
            self._span_ids = (rec, ids)
        return ids

    def predict(self, x: torch.Tensor):
        """Single-input convenience (the common CNN case)."""
        return self(inputs={self.input_name: x})

    @property
    def input_name(self) -> str:
        (inp,) = [n.name for n in self._topo if n.op == "input"]
        return inp

    @property
    def device(self) -> Optional[torch.device]:
        """Where the bound parameters live (None for a model without
        any)."""
        for node in self.params.values():
            for t in node.values():
                return t.device
        return None

    def replica(self, device) -> "CompiledModel":
        """The same program with its bound parameters on ``device`` — the
        executable a serving worker on that device runs.  ``self`` for the
        model's own device, and for a sharded model (it already spans its
        devices); for another, a copy made once and cached per device (the
        parameters copied, nothing re-planned or re-bound)."""
        if self.devices > 1:
            return self
        return self._on(device)

    def _on(self, device) -> "CompiledModel":
        """The one-device program on ``device``: ``self`` where its
        parameters live, else a cached copy of them there."""
        device = _concrete(torch.device(device))
        if device == self.device or self.device is None:
            return self
        with self._replica_lock:
            rep = self._replicas.get(device)
            if rep is None:
                rep = CompiledModel(
                    plan=self.plan,
                    params={name: {k: t.to(device) for k, t in p.items()}
                            for name, p in self.params.items()},
                    dispatch=self.dispatch, use_kernel=self.use_kernel)
                self._replicas[device] = rep
        return rep


def _concrete(device: torch.device) -> torch.device:
    """``cuda`` as the indexed device it means (the current one)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def compile_model(plan: Plan, params: Params, dispatch: str = "whole",
                  use_kernel: bool = True, fold_bn: bool = True,
                  devices: int = 1) -> CompiledModel:
    """Bind ``params`` to ``plan`` and wrap the executable.  ``use_kernel``
    (default) runs every blocked conv on the conv kernel; ``False`` runs
    each on its schedule's lowering (the reference's ``use_pallas=False``
    path), which int8 schedules need.  ``devices > 1``: ``plan`` is the
    per-device sub-batch's, and the model runs batch-sharded."""
    bound = bind_params(plan, params, fold_bn=fold_bn, use_kernel=use_kernel)
    return CompiledModel(plan=plan, params=bound, dispatch=dispatch,
                         use_kernel=use_kernel, devices=devices)
