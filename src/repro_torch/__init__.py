"""NeoCPU's CNN inference compiler in PyTorch, for NVIDIA Hopper.

The port of the JAX reference package ``repro``, module by module under the
same names.  It imports neither JAX nor ``repro``.  Entry points take a
``device`` (default "cuda"): on a CUDA device every blocked convolution
launches the hand-written kernel of ``kernels/conv2d_nchwc.py``; on the CPU
it runs that kernel's plain PyTorch version.

    from repro_torch import compile
    session = compile("resnet-50", (1, 3, 224, 224))
    probs = session.predict(x)          # x: (1, 3, 224, 224) on the card
"""
from repro_torch.engine import compile

__all__ = ["compile"]
