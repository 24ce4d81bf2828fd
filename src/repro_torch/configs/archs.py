"""The 10 assigned architectures — exact configs from the assignment table
(a copy of the JAX reference's ``repro/configs/archs.py``; pure data).

Each entry has a PRODUCTION config (bf16, remat for the big ones; exercised
only via the dry-run's ShapeDtypeStructs) and a REDUCED config of the same
family (fp32, tiny dims; instantiated for CPU smoke tests).

Sources as given in the assignment: [arXiv:2212.04356] whisper,
[hf:llava-hf/llava-v1.6-mistral-7b-hf], [arXiv:2402.19427] recurrentgemma,
[arXiv:2405.21060] mamba2, [arXiv:2501.kimi2], [hf:Snowflake/snowflake-
arctic-base], [arXiv:2407.10671] qwen2, [hf:stabilityai/stablelm-2-1_6b],
[arXiv:2402.19173] starcoder2, [arXiv:2403.04652] yi.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.lm.config import LMConfig

ARCHS: Dict[str, LMConfig] = {
    # [audio] enc-dec, conv frontend stubbed: input_specs provides
    # precomputed frame embeddings (B, 1500, d)
    "whisper-tiny": LMConfig(
        name="whisper-tiny", family="encdec", n_layers=4, enc_layers=4,
        d_model=384, n_heads=6, n_kv=6, d_ff=1536, vocab=51865,
        enc_positions=1500, norm="layernorm", mlp_gated=False,
        qkv_bias=True, tie_embeddings=True, dtype="bfloat16"),

    # [vlm] mistral-7b backbone; anyres tiling enters as the image-token
    # count (5 tiles x 24x24 patches = 2880), frontend stubbed
    "llava-next-mistral-7b": LMConfig(
        name="llava-next-mistral-7b", family="vlm", n_layers=32,
        d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=32000,
        n_img_tokens=2880, rope_theta=1e6, dtype="bfloat16", remat=True),

    # [hybrid] RG-LRU + local attention, 1 attn : 2 recurrent
    "recurrentgemma-2b": LMConfig(
        name="recurrentgemma-2b", family="hybrid", n_layers=26,
        d_model=2560, n_heads=10, n_kv=1, head_dim=256, d_ff=7680,
        vocab=256000, block_pattern=("rec", "rec", "attn"),
        local_window=2048, lru_width=2560, tie_embeddings=True,
        dtype="bfloat16", remat=True),

    # [ssm] SSD (state-space duality), attention-free
    "mamba2-130m": LMConfig(
        name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
        n_heads=0, n_kv=0, d_ff=0, vocab=50280, ssm_state=128,
        ssm_head_dim=64, ssm_expand=2, conv_kernel=4, ssm_chunk=256,
        tie_embeddings=True, dtype="bfloat16", remat=True),

    # [moe] trillion-param: 384 experts top-8 + 1 shared expert
    "kimi-k2-1t-a32b": LMConfig(
        name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv=8, head_dim=112, d_ff=2048, vocab=163840,
        n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
        dtype="bfloat16", remat=True),

    # [moe] 128 experts top-2 + dense residual FFN in parallel
    "arctic-480b": LMConfig(
        name="arctic-480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv=8, head_dim=128, d_ff=4864, vocab=32000,
        n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
        dtype="bfloat16", remat=True),

    # [dense] GQA with QKV bias
    "qwen2-1.5b": LMConfig(
        name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
        n_heads=12, n_kv=2, head_dim=128, d_ff=8960, vocab=151936,
        qkv_bias=True, rope_theta=1e6, dtype="bfloat16"),

    # [dense] MHA (kv == heads)
    "stablelm-3b": LMConfig(
        name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
        n_heads=32, n_kv=32, d_ff=6912, vocab=50304, norm="layernorm",
        dtype="bfloat16"),

    # [dense] GQA, RoPE, plain-GELU MLP
    "starcoder2-3b": LMConfig(
        name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
        n_heads=24, n_kv=2, head_dim=128, d_ff=12288, vocab=49152,
        norm="layernorm", mlp_gated=False, qkv_bias=True,
        rope_theta=1e5, dtype="bfloat16"),

    # [dense] llama-arch GQA
    "yi-9b": LMConfig(
        name="yi-9b", family="dense", n_layers=48, d_model=4096,
        n_heads=32, n_kv=4, d_ff=11008, vocab=64000, rope_theta=5e6,
        dtype="bfloat16", remat=True),
}


def reduced(cfg: LMConfig) -> LMConfig:
    """Same-family tiny config for CPU smoke tests: few layers, small width,
    few experts, tiny vocab — one forward/train step asserts shapes + no
    NaNs (the FULL config is exercised only via the dry-run)."""
    kw = dict(
        name=f"{cfg.name}-reduced", family=cfg.family,
        n_layers=min(cfg.n_layers, 2), d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv=min(cfg.n_kv, 4) if cfg.n_kv else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0, vocab=512,
        qkv_bias=cfg.qkv_bias, mlp_gated=cfg.mlp_gated, norm=cfg.norm,
        rope_theta=cfg.rope_theta, tie_embeddings=cfg.tie_embeddings,
        dtype="float32", remat=False)
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=96,
                  n_shared_experts=cfg.n_shared_experts,
                  dense_residual=cfg.dense_residual, capacity_factor=2.0)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_expand=2,
                  conv_kernel=4, ssm_chunk=8)
    if cfg.family == "hybrid":
        kw.update(block_pattern=cfg.block_pattern, local_window=8,
                  lru_width=64, n_layers=3)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, enc_positions=16)
    if cfg.family == "vlm":
        kw.update(n_img_tokens=8)
    return LMConfig(**kw)


def get(name: str) -> LMConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
