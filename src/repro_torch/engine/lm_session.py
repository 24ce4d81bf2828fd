"""LM inference sessions: seq-bucketed prefill + decode — the port of the
reference's ``repro/engine/lm_session.py``.

An LM session prefills a prompt through the largest sequence-length bucket
``<=`` its length and catches the leftover tokens up through decode, one
step each (right-padding a prompt would corrupt recurrent state).  The
bucket set comes from measured prompt-length traffic through
:func:`repro_torch.engine.traffic.solve_seq_buckets`, or is the halving
ladder ``{max_len, max_len//2, max_len//4}``.  ``generate`` is greedy
(argmax) decode with an optional ``on_token`` callback that sees exactly
the tokens the returned array holds.

PyTorch runs eagerly, so there are no per-bucket programs to compile:
``prewarm`` builds the kernels and runs one prefill per bucket and one
decode step.  On a CUDA device every prefill attention (dense, moe) or
SSD intra-chunk block (ssm) launches the hand-written kernel B3 or B4, and
every MoE router (moe, at prefill and at each decode step) the blocked
matmul B2.

``save`` writes the reference's version-5 LM artifact: a manifest whose
``"lm"`` section holds the config, ``max_len``, ``batch``, the bucket set
and the prompt-traffic histogram, and the weights as step 0 of a
``CheckpointStore``, every file checksummed, swapped in atomically.
``load`` verifies the checksums and rebuilds the nested-dict tree from the
leaves' dotted paths, bf16 leaves bit for bit — an artifact of either
package, so also a bf16 one the reference writes but cannot read back
(ROADMAP C5).  It never draws a template tree: arctic-480b's alone would
be 55 GB.  Nothing is searched.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore, unflatten_dicts
from repro_torch.engine.telemetry import SizeHistogram
from repro_torch.engine.traffic import _coerce_counts, solve_seq_buckets
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.model import (check_family, decode_step,
                                         init_cache, init_params, prefill)

__all__ = ["LMSession", "compile_lm"]


def _lm_archs() -> Dict[str, LMConfig]:
    from repro_torch.configs import ARCHS
    return ARCHS


class LMSession:
    """A compiled LM: params bound on their device, prefill per seq
    bucket, one decode step.  ``generate`` keeps all its state (the cache)
    local."""

    def __init__(self, cfg: LMConfig, params, *, max_len: int,
                 batch: int = 1,
                 seq_buckets: Sequence[int] = (),
                 model_name: Optional[str] = None) -> None:
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        buckets = sorted({int(b) for b in seq_buckets})
        if any(b < 1 or b > max_len for b in buckets):
            raise ValueError(f"seq_buckets must lie in [1, max_len="
                             f"{max_len}], got {seq_buckets}")
        check_family(cfg)
        self.cfg = cfg
        self.max_len = int(max_len)
        self.batch = int(batch)
        self.seq_buckets = buckets
        self.model_name = model_name or cfg.name
        self.traffic = SizeHistogram()        # prompt lengths, not rows
        self._params = params
        self.device = params["embed"].device

    # -- the surface AsyncServer speaks --------------------------------------
    @property
    def input_spec(self) -> Dict[str, tuple]:
        return {"tokens": (self.batch, self.max_len)}

    @property
    def frozen(self) -> bool:
        # the batch dimension is fixed at compile time (decode caches are
        # allocated per batch); seq buckets are the flexible axis
        return True

    @property
    def batch_sizes(self):
        return [self.batch]

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        """Largest seq bucket ``<=`` the prompt length, or None (the
        prompt runs entirely through decode)."""
        under = [b for b in self.seq_buckets if b <= prompt_len]
        return max(under) if under else None

    def prewarm(self) -> None:
        """Build the kernels and run one prefill per bucket and one decode
        step up front, so that no request pays the first build."""
        dummy = torch.zeros((self.batch, 1), dtype=torch.long,
                            device=self.device)
        cache = init_cache(self.cfg, self.batch, self.max_len, self.device)
        decode_step(self._params, self.cfg, dummy, cache, 0)
        for b in self.seq_buckets:
            toks = torch.zeros((self.batch, b), dtype=torch.long,
                               device=self.device)
            prefill(self._params, self.cfg, toks, max_len=self.max_len)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- generation ------------------------------------------------------------
    def generate(self, tokens, max_new_tokens: int, *,
                 on_token: Optional[Callable[[int, np.ndarray], None]] = None,
                 pick: Optional[Callable[[int, torch.Tensor], torch.Tensor]]
                 = None) -> np.ndarray:
        """Greedy decode: returns the ``(batch, max_new_tokens)`` int32
        token array.  ``on_token(step, tokens_b)`` fires as each step's
        tokens become available — the streaming hook; it observes the
        exact values the return array holds.  ``pick(step, logits)``, if
        given, chooses each step's ``(batch,)`` tokens from its
        ``(batch, vocab)`` logits in place of the argmax (to read the
        logits, or to feed back tokens of another run)."""
        toks = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens)
        if toks.dim() != 2 or toks.shape[0] != self.batch:
            raise ValueError(
                f"tokens must be ({self.batch}, prompt_len), got "
                f"{tuple(toks.shape)}")
        if toks.dtype.is_floating_point or toks.dtype.is_complex \
                or toks.dtype == torch.bool:
            raise ValueError(f"tokens must be integers, got {toks.dtype}")
        toks = toks.to(device=self.device, dtype=torch.long)
        prompt_len = int(toks.shape[1])
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if prompt_len + max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + new tokens ({max_new_tokens}) "
                f"overflow max_len={self.max_len}")
        params, cfg = self._params, self.cfg
        bucket = self.bucket_for(prompt_len)
        if bucket is None:
            # below every bucket: run the whole prompt through decode
            cache = init_cache(cfg, self.batch, self.max_len, self.device)
            logits = None
            start = 0
        else:
            cache, logits = prefill(params, cfg, toks[:, :bucket],
                                    max_len=self.max_len)
            start = bucket
        for p in range(start, prompt_len):       # decode catch-up
            logits, cache = decode_step(params, cfg, toks[:, p:p + 1], cache,
                                        p)
        out = []
        for t in range(max_new_tokens):
            nxt = (torch.argmax(logits, dim=-1) if pick is None
                   else pick(t, logits).to(self.device))    # (batch,)
            step = nxt.cpu().numpy().astype(np.int32)
            out.append(step)
            if on_token is not None:
                on_token(t, step)
            if t + 1 < max_new_tokens:           # advance for the next token
                logits, cache = decode_step(params, cfg, nxt[:, None], cache,
                                            prompt_len + t)
        return np.stack(out, axis=1)

    # -- persistence -----------------------------------------------------------
    def save(self, path: Union[str, Path]) -> Path:
        """Write the version-5 LM artifact: manifest (config, bucket set,
        traffic provenance) + checksummed weights, through the same atomic
        temp-dir swap CNN artifacts use."""
        from repro_torch.engine.session import (ARTIFACT_FORMAT,
                                                ARTIFACT_VERSION, fresh_tmp,
                                                write_artifact)

        path = Path(path)
        tmp = fresh_tmp(path)
        CheckpointStore(tmp / "weights").save(
            step=0, tree=self._params, meta={"kind": "lm-params"})
        hist = self.traffic.counts()
        manifest = {
            "format": ARTIFACT_FORMAT,
            "version": ARTIFACT_VERSION,
            "model": self.model_name,
            "lm": {
                "config": dataclasses.asdict(self.cfg),
                "max_len": self.max_len,
                "batch": self.batch,
                "seq_buckets": list(self.seq_buckets),
                "traffic": {"histogram": {str(s): c for s, c in
                                          sorted(hist.items())}},
            },
        }
        return write_artifact(tmp, path, manifest)

    @classmethod
    def load(cls, path: Union[str, Path], *, device="cuda") -> "LMSession":
        """Reconstruct an LM session from :meth:`save` output (of either
        package), its weights on ``device``: checksums verified before
        anything is read, zero schedule searches."""
        from repro_torch.engine.session import (ArtifactCorruptError,
                                                ArtifactError, read_manifest,
                                                verify_checksums)

        path = Path(path)
        manifest = read_manifest(path)
        lm = manifest.get("lm")
        if not lm:
            raise ArtifactError(
                f"{path} is a CNN artifact (no 'lm' section); load it "
                "with InferenceSession.load")
        verify_checksums(path, manifest)
        cfg_d = dict(lm["config"])
        cfg_d["block_pattern"] = tuple(cfg_d.get("block_pattern") or ())
        cfg = LMConfig(**cfg_d)
        try:
            leaves, _, _ = CheckpointStore(path / "weights").restore_flat(
                step=0)
        except (ValueError, FileNotFoundError, KeyError) as e:
            raise ArtifactCorruptError(
                f"artifact weights under {path}/weights are corrupt or "
                f"incomplete: {e}") from e
        params = unflatten_dicts({p: t.to(device)
                                  for p, t in leaves.items()})
        sess = cls(cfg, params, max_len=int(lm["max_len"]),
                   batch=int(lm["batch"]),
                   seq_buckets=[int(b) for b in lm.get("seq_buckets", [])],
                   model_name=manifest.get("model"))
        for s, c in (lm.get("traffic", {}).get("histogram") or {}).items():
            sess.traffic.add(int(s), int(c))
        return sess


def compile_lm(model: Union[LMConfig, str], *,
               max_len: int, batch: int = 1,
               seq_buckets: Union[None, str, Sequence[int]] = None,
               prompt_hist=None, max_seq_buckets: int = 8,
               seed: int = 0, params=None,
               prewarm: bool = False, device="cuda") -> LMSession:
    """Build an :class:`LMSession` — the LM arm of ``engine.compile``.

    model        an ``LMConfig`` (e.g. ``reduced(ARCHS["qwen2-1.5b"])``)
                 or an assigned-architecture name; the port runs the
                 ``dense``, ``moe`` and ``ssm`` families
    seq_buckets  explicit prefill bucket lengths; ``"auto"`` solves them
                 from ``prompt_hist`` (a ``{len: count}`` mapping or
                 ``SizeHistogram``) via the reflected exact DP; default
                 ``None`` uses the halving ladder
                 ``{max_len, max_len//2, max_len//4}``
    prompt_hist  measured prompt-length histogram for ``"auto"``
    params       the parameter tree on its device (default: drawn from
                 ``seed`` on ``device``)
    device       where the model runs: "cuda" (default) launches the
                 hand-written kernels; "cpu" runs their plain versions
    """
    if isinstance(model, str):
        archs = _lm_archs()
        if model not in archs:
            raise ValueError(f"unknown LM architecture {model!r}; "
                             f"pick one of {sorted(archs)}")
        cfg = archs[model]
    else:
        cfg = model
    if seq_buckets == "auto":
        if prompt_hist is None:
            raise ValueError("seq_buckets='auto' needs prompt_hist= a "
                             "recorded prompt-length histogram")
        counts = _coerce_counts(prompt_hist)
        solved = solve_seq_buckets(counts, max_buckets=max_seq_buckets)
        buckets = [b for b in solved if b <= max_len]
    elif seq_buckets is None:
        if prompt_hist is not None:
            raise ValueError("prompt_hist= is only meaningful with "
                             "seq_buckets='auto'")
        buckets = sorted({max_len, max(1, max_len // 2),
                          max(1, max_len // 4)})
    else:
        buckets = [int(b) for b in seq_buckets]
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    sess = LMSession(cfg, params, max_len=max_len, batch=batch,
                     seq_buckets=buckets,
                     model_name=cfg.name if isinstance(model, LMConfig)
                     else model)
    if prompt_hist is not None and seq_buckets == "auto":
        for s, c in _coerce_counts(prompt_hist).items():
            sess.traffic.add(s, c)
    if prewarm:
        sess.prewarm()
    return sess
