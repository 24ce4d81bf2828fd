"""Roofline analysis in the H100's terms — the port of the reference's
``repro/analysis/roofline.py``.

    compute term    = FLOPs / (chips x 989 TFLOP/s dense bf16)
    memory term     = bytes / (chips x 3.35 TB/s)
    collective term = collective_bytes / (chips x 450 GB/s NVLink)

The figures are NVIDIA's published peaks for one H100 SXM (data sheet,
dense rates without sparsity, at its 700 W limit), stated here once for
the port: ``core.cost.MachineModel.h100`` and ``chip_smoke.py``'s bounds
read them from this module.  FLOPs and heavy bytes come from
``analysis.flops.count_costs`` (the aten ops of a step on the meta
device); ``model_flops`` and ``model_bytes`` are the algorithmic minimum
from the config alone.  The reference parses its collectives out of XLA's
optimized HLO text (``parse_collective_bytes``, ``count_ops``); the port
produces no HLO.  Its collectives are the ones that DTensor issues while a
step runs on a mesh, counted by :class:`CollectiveCounter` (a
``CommDebugMode``) under the reference's kind names, each one's bytes the
sum of its operands' local sizes (``launch/dryrun.py`` fills
``RooflineReport.collectives`` and ``collective_bytes_per_device`` with
them).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# H100 SXM data sheet (dense, no sparsity)
PEAK_FLOPS = 989e12          # bf16 / card, on the tensor cores
PEAK_TF32 = 495e12           # TF32 / card, on the tensor cores
PEAK_FP32 = 67e12            # fp32 / card, outside the tensor cores
HBM_BW = 3.35e12             # device-memory bytes/s / card
NVLINK_BW = 450e9            # bytes/s / card, per direction


# the reference's collective kinds (XLA's HLO op names)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d functional collectives (native and legacy names) -> the kind
_KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "broadcast": "collective-permute"}


def collective_kind(op_name: str):
    """The reference's kind of a c10d collective op (``"all-gather"`` for
    ``all_gather_into_tensor``), or None for any other op."""
    return _KINDS.get(op_name.split(".")[-1].split("::")[-1])


def CollectiveCounter():
    """A ``torch.distributed.tensor.debug.CommDebugMode`` that also keeps,
    by kind (``COLLECTIVES``), the count of the collectives dispatched
    while it is active (``counts``) and their bytes: each one's operands'
    local sizes summed (``bytes``, with a ``"total"``).  Built inside the
    function, so importing this module imports no distributed module."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    class _Counter(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.counts = {c: 0 for c in COLLECTIVES}
            self.bytes = {c: 0 for c in COLLECTIVES}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            # a DTensor op goes back to DTensor, which issues its
            # collectives as plain ops; every other op but a collective
            # runs as it is (CommDebugMode's record of each op would cost
            # more than the op itself on the meta device)
            if any(t is DTensor for t in types):
                return NotImplemented
            kind = None
            if not isinstance(func, torch._ops.HigherOrderOperator):
                kind = collective_kind(func._overloadpacket.__name__)
            if kind is None:
                return func(*args, **(kwargs or {}))
            self.counts[kind] += 1
            self.bytes[kind] += sum(
                a.numel() * a.element_size()
                for a in torch.utils._pytree.tree_leaves(args)
                if isinstance(a, torch.Tensor))
            return super().__torch_dispatch__(func, types, args, kwargs)

        def collective_bytes(self) -> Dict[str, int]:
            out = dict(self.bytes)
            out["total"] = sum(self.bytes.values())
            return out

    return _Counter()


@dataclasses.dataclass
class RooflineReport:
    """Primary FLOP/byte source is the aten-op counter (analysis/flops.py)
    — exact under Python loops — divided by chips for the per-device
    terms.  ``ca_*`` carry a second counter's figures for comparison (the
    reference keeps XLA's ``cost_analysis()`` there, which counts a
    while-loop body once)."""

    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float            # counted total / chips
    bytes_per_device: float            # counted heavy bytes / chips
    collective_bytes_per_device: float
    collectives: Dict[str, int]
    model_flops_total: float           # 6·N·D (train) / 2·N·D (inference)
    ca_flops_per_device: float = 0.0
    ca_bytes_per_device: float = 0.0
    model_bytes_total: float = 0.0     # algorithmic minimum device traffic

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips) — catches remat and
        redundancy."""
        hw = self.flops_per_device * self.chips
        return self.model_flops_total / hw if hw else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline-optimal step time: overlapped compute/memory plus the
        collective term charged serially (conservative)."""
        return max(self.compute_s, self.memory_s) + self.collective_s

    @property
    def ideal_step_s(self) -> float:
        """The algorithmic lower bound: the larger of the compute roofline
        on MODEL_FLOPS and the memory roofline on MODEL_BYTES (for decode
        the latter dominates — params+cache must stream once per token)."""
        c = self.model_flops_total / (self.chips * PEAK_FLOPS)
        m = self.model_bytes_total / (self.chips * HBM_BW)
        return max(c, m)

    @property
    def roofline_fraction(self) -> float:
        """ideal_step / achieved step — 1.0 means sitting on the roofline
        that binds this workload (compute for train, memory for decode)."""
        return self.ideal_step_s / self.step_time_s if self.step_time_s \
            else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "ca_flops_per_device": self.ca_flops_per_device,
            "ca_bytes_per_device": self.ca_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collectives": self.collectives,
            "model_flops_total": self.model_flops_total,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "model_bytes_total": self.model_bytes_total,
            "ideal_step_s": self.ideal_step_s,
            "step_time_s": self.step_time_s,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """6·N·D for training, 2·N·D for inference (N = active params)."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch          # decode: one token per sequence


def _param_bytes(cfg) -> float:
    return cfg.param_count() * (2 if cfg.dtype == "bfloat16" else 4)


def _cache_bytes(cfg, batch: int, seq: int) -> float:
    el = 2 if cfg.dtype == "bfloat16" else 4
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        return (cfg.n_layers * batch * cfg.n_kv * seq * cfg.head_dim
                * 2 * el)
    if cfg.family == "ssm":
        return (cfg.n_layers * batch * cfg.ssm_heads * cfg.ssm_head_dim
                * cfg.ssm_state * 4)
    if cfg.family == "hybrid":
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.layer_kind(i) == "attn")
        w = min(cfg.local_window, seq)
        kv = n_attn * batch * cfg.n_kv * w * cfg.head_dim * 2 * el
        lru = (cfg.n_layers - n_attn) * batch * cfg.lru_width * 4
        return kv + lru
    return 0.0


def model_bytes(cfg, kind: str, batch: int, seq: int) -> float:
    """Algorithmic minimum device-memory traffic per step:
    train — params read (fwd+bwd) + grads written + Adam moments r/w +
    activations floor (one residual-stream r/w per layer);
    decode — params (all experts resident stream for MoE routing is NOT
    needed: only active experts' weights are read) + the KV/state cache;
    prefill — params + activations floor + cache write."""
    pb = _param_bytes(cfg)
    act_el = 2 if cfg.dtype == "bfloat16" else 4
    layer_io = batch * seq * cfg.d_model * act_el * cfg.n_layers * 2
    if kind == "train":
        # fwd read + bwd read + grad write (bf16) + 2 fp32 moments r/w +
        # fp32 master update ≈ 3·pb + 16·N
        n = cfg.param_count()
        return 3 * pb + 16 * n + 2 * layer_io
    if kind == "prefill":
        return pb + layer_io + _cache_bytes(cfg, batch, seq)
    # decode: active params stream once + full cache read + tiny writes
    active_pb = cfg.active_param_count() * (2 if cfg.dtype == "bfloat16"
                                            else 4)
    return active_pb + _cache_bytes(cfg, batch, seq)
