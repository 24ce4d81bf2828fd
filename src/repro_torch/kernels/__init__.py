"""Hand-written Hopper kernels, their plain versions, and the conv entries.

conv2d_nchwc — the paper's CONV template (Algorithm 1) in NCHW[x]c with the
fused conv_block epilogue, as a CUDA kernel (``csrc/conv2d_nchwc.cu``) beside
its plain PyTorch version; ops.py carries the engine-facing entries, ref.py
the plain oracles.
"""
