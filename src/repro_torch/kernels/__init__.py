"""Hand-written Hopper kernels, their plain versions, and the conv entries.

conv2d_nchwc    — the paper's CONV template (Algorithm 1) in NCHW[x]c with
                  the fused conv_block epilogue (B1: a 3xTF32 implicit GEMM
                  on the tensor cores, ``csrc/conv2d_nchwc_sm90.cu``);
matmul_blocked  — ``(M, K) @ (K, N)`` with the fused scale, causal-mask,
                  row-softmax and ReLU tail, the MoE router's (B2:
                  ``csrc/matmul_splitk.cu``, ``csrc/matmul_blocked_sm90.cu``
                  and ``csrc/matmul_blocked.cu``);
flash_attention — forward attention with an online softmax, the LM
                  prefill's (B3: bf16 on the tensor cores,
                  ``csrc/flash_attention_sm90.cu``; fp32 on the FMA units,
                  ``csrc/flash_attention.cu``);
ssd_chunk       — the Mamba-2 SSD intra-chunk block (B4: 3xTF32 on the
                  tensor cores, the scores shared across heads,
                  ``csrc/ssd_chunk_sm90.cu``).

Each CUDA kernel sits beside its plain PyTorch version; build.py compiles
and loads them; ops.py carries the engine-facing conv entries and the LM's
fused matmul tails (``dense_softmax``, ``attention_probs``), ref.py the
plain oracles.
"""
from repro_torch.kernels.matmul_blocked import matmul_blocked
from repro_torch.kernels.ops import attention_probs, dense_softmax

__all__ = ["attention_probs", "dense_softmax", "matmul_blocked"]
