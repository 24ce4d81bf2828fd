"""LM architecture configuration: a copy of the JAX reference's ``LMConfig``
(``repro/models/lm/config.py``), field for field.

One config class covers the 10 assigned architectures; ``family`` selects
the layer recipe:

    dense   — GQA transformer (qwen2, stablelm, starcoder2, yi)
    moe     — GQA attention + mixture-of-experts FFN (kimi-k2, arctic)
    ssm     — attention-free Mamba-2 / SSD stack (mamba2-130m)
    hybrid  — RG-LRU recurrent blocks + local attention 1:2 (recurrentgemma)
    encdec  — encoder-decoder with cross attention (whisper; audio frontend
              stubbed per assignment: input_specs provides frame embeddings)
    vlm     — dense decoder consuming [image-patch embeds | text tokens]
              (llava-next; anyres tiling enters as the image-token count)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_gated: bool = True     # SwiGLU (llama-like) vs plain GELU MLP
    norm: str = "rmsnorm"      # "rmsnorm" | "layernorm"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "float32"     # smoke default; production configs use bf16
    # remat and remat_policy are read by the training forward
    # (models/lm/model.py); shard_strategy by the dry run and its mesh
    # context (launch/dryrun.py, models/lm/sharding.py::use_mesh);
    # unroll_layers changes nothing in the port, whose layer loop is
    # already Python, and is kept so configs and their JSON round-trip
    # with the reference's
    remat: bool = False        # activation checkpointing in train_step
    shard_strategy: str = "tp"   # "tp" | "pure_dp" (model axis as extra DP)
    fused_gates: bool = False    # rglru: one (W, 2W) gate matmul, not two
    remat_policy: str = "full"   # "full" | "dots" (save matmul outputs)
    # TPU flash-attention VMEM block sizes: the chunk sizes of the plain
    # version on the CPU; the CUDA kernel (B3) has its own tiles and does
    # not read them
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    unroll_layers: bool = False  # measurement mode: unroll the layer scan
                                 # so HLO text shows per-layer collectives

    # MoE ------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0          # per-expert hidden dim
    n_shared_experts: int = 0  # kimi-style always-on experts
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD) -----------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssm_chunk: int = 256

    # hybrid (recurrentgemma / griffin) --------------------------------------
    block_pattern: Tuple[str, ...] = ()   # cycled over layers, e.g. (rec, rec, attn)
    local_window: int = 0
    lru_width: int = 0

    # encoder-decoder (whisper) ----------------------------------------------
    enc_layers: int = 0
    enc_positions: int = 0     # precomputed frame embeddings (stub frontend)

    # vlm (llava) -------------------------------------------------------------
    n_img_tokens: int = 0

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; pick one of "
                             f"{FAMILIES}")
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:          # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kind(self, i: int) -> str:
        """hybrid: which sublayer type layer ``i`` is."""
        if self.family != "hybrid":
            return "attn"
        return self.block_pattern[i % len(self.block_pattern)]

    # -- parameter counting (documentation + roofline MODEL_FLOPS) -----------
    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd, h, kv = self.head_dim, self.n_heads, self.n_kv
        n = v * d                                   # embedding
        if not self.tie_embeddings:
            n += v * d                              # lm head
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp = (3 if self.mlp_gated else 2) * d * ff
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            per_layer = attn
            if self.family == "moe":
                expert = (3 if self.mlp_gated else 2) * d * self.moe_d_ff
                per_layer += self.n_experts * expert + d * self.n_experts
                per_layer += self.n_shared_experts * expert
                if self.dense_residual:
                    per_layer += mlp
            else:
                per_layer += mlp
            n += self.n_layers * per_layer
            if self.family == "encdec":
                # encoder layers + decoder cross-attention
                n += self.enc_layers * (attn + mlp)
                n += self.n_layers * attn           # cross-attn per dec layer
        elif self.family == "ssm":
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * ns + nh)
            per_layer = in_proj + di * d + self.conv_kernel * (di + 2 * ns)
            n += self.n_layers * per_layer
        elif self.family == "hybrid":
            w = self.lru_width
            rec = d * w * 2 + w * d + 2 * w * w + self.conv_kernel * w + w
            for i in range(self.n_layers):
                n += mlp + (attn if self.layer_kind(i) == "attn" else rec)
        return n

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        expert = (3 if self.mlp_gated else 2) * d * self.moe_d_ff
        inactive = (self.n_experts - self.top_k) * expert
        return self.param_count() - self.n_layers * inactive
