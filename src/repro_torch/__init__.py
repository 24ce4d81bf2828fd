"""NeoCPU's CNN inference compiler in PyTorch, for NVIDIA Hopper, with the
reference's LM serving path.

The port of the JAX reference package ``repro``, module by module under the
same names.  It imports neither JAX nor ``repro``.  Entry points take a
``device`` (default "cuda"): on a CUDA device every blocked convolution
launches the hand-written kernel of ``kernels/conv2d_nchwc.py``, every LM
prefill attention that of ``kernels/flash_attention.py``, every Mamba-2
intra-chunk block that of ``kernels/ssd_chunk.py`` and every MoE router
that of ``kernels/matmul_blocked.py``; on the CPU they run those kernels'
plain PyTorch versions.

    from repro_torch import compile
    session = compile("resnet-50", (1, 3, 224, 224))
    probs = session.predict(x)          # x: (1, 3, 224, 224) on the card
    lm = compile("qwen2-1.5b", (1, 2048))
    tokens = lm.generate(prompt, 32)    # prompt: (1, prompt_len) ints
"""
from repro_torch.engine import LMSession, compile, compile_lm

__all__ = ["LMSession", "compile", "compile_lm"]
