"""Optimizers: AdamW, SGD, the cosine schedule."""
from repro_torch.optim.adamw import AdamW, AdamWState, SGD, cosine_lr

__all__ = ["AdamW", "AdamWState", "SGD", "cosine_lr"]
