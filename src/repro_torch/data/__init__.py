"""Deterministic shard-aware synthetic data pipelines."""
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream

__all__ = ["DataConfig", "SyntheticLMStream"]
