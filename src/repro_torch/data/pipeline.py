"""Deterministic, shard-aware synthetic data pipeline — a copy of the
reference's ``repro/data/pipeline.py`` (numpy only): the same arrays for
the same seed and step.

Production-shaped properties the runtime relies on:

* **Deterministic addressing** — batch ``i`` is a pure function of
  (seed, step), so any host can regenerate any step's data: this is what
  makes checkpoint-restart and elastic re-sharding exact (no data-order
  drift after a failure).
* **Shard-aware** — each host materializes only its slice of the global
  batch (``host_slice``); re-meshing after a failure just changes the
  slice arithmetic (``runtime/fault_tolerance.py``).
* **Prefetchable** — an iterator with a bounded lookahead for overlap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.lm.config import LMConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0


class SyntheticLMStream:
    """Token stream with learnable structure (a noisy copy task) so smoke
    training actually reduces loss rather than fitting noise."""

    def __init__(self, dc: DataConfig, cfg: Optional[LMConfig] = None):
        self.dc = dc
        self.cfg = cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.dc.seed, step]))

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The full (global_batch, seq) arrays for one step."""
        dc = self.dc
        rng = self._rng(step)
        period = 8
        motif = rng.integers(0, dc.vocab, size=(dc.global_batch, period))
        reps = dc.seq_len // period + 1
        tokens = np.tile(motif, (1, reps))[:, :dc.seq_len]
        noise = rng.uniform(size=tokens.shape) < 0.05
        tokens = np.where(noise,
                          rng.integers(0, dc.vocab, size=tokens.shape),
                          tokens).astype(np.int32)
        targets = np.concatenate(
            [tokens[:, 1:], tokens[:, :1]], axis=1).astype(np.int32)
        out = {"tokens": tokens, "targets": targets}
        if self.cfg is not None and self.cfg.family == "vlm":
            out["img_embeds"] = rng.normal(size=(
                dc.global_batch, self.cfg.n_img_tokens,
                self.cfg.d_model)).astype(np.float32)
        if self.cfg is not None and self.cfg.family == "encdec":
            out["frames"] = rng.normal(size=(
                dc.global_batch, self.cfg.enc_positions,
                self.cfg.d_model)).astype(np.float32)
        return out

    def host_slice(self, step: int, host_index: int,
                   n_hosts: int) -> Dict[str, np.ndarray]:
        """This host's contiguous slice of the global batch.  Elastic
        re-meshing = calling this with new (host_index, n_hosts)."""
        assert self.dc.global_batch % n_hosts == 0, \
            (self.dc.global_batch, n_hosts)
        per = self.dc.global_batch // n_hosts
        full = self.global_batch(step)
        lo = host_index * per
        return {k: v[lo:lo + per] for k, v in full.items()}

    def iterator(self, start_step: int = 0, host_index: int = 0,
                 n_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.host_slice(step, host_index, n_hosts)
            step += 1
