"""Assigned input shapes and meta-tensor input specs per (arch, shape) —
the port of the reference's ``repro/configs/shapes.py``.

Shapes are seq_len x global_batch.  ``decode_*`` / ``long_*`` run
``serve_step`` (one token against a seq_len cache), not ``train_step``.
``long_500k`` needs sub-quadratic attention: it runs for the SSM and
hybrid families and is skipped for full-attention archs.

Where the reference returns ``jax.ShapeDtypeStruct`` stand-ins,
``input_specs`` returns tensors on the ``meta`` device: shapes and dtypes,
no storage.  Token inputs are int64, the index type the port's model takes
(``params["embed"][tokens]``), where the reference's are int32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.lm import model
from repro_torch.models.lm.config import LMConfig

TOKEN_DTYPE = torch.int64


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str       # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SUBQUADRATIC = ("ssm", "hybrid")


def applicable(cfg: LMConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped).  long_500k only for sub-quadratic decode
    state; every assigned arch has a decoder, so decode shapes always run."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC:
        return False, ("full-attention KV decode at 524k is quadratic-cost "
                       "prefill / O(S) KV per token; skipped per assignment "
                       "(sub-quadratic archs only)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: LMConfig, shape: ShapeSpec) -> Dict:
    """Meta-tensor stand-ins for every model input of this cell: the
    shapes and dtypes, no storage."""
    tok = TOKEN_DTYPE
    dt = getattr(torch, cfg.dtype)
    b, s = shape.batch, shape.seq

    if shape.kind == "train":
        if cfg.family == "vlm":
            s_txt = s - cfg.n_img_tokens
            return {"tokens": _meta((b, s_txt), tok),
                    "targets": _meta((b, s_txt), tok),
                    "img_embeds": _meta((b, cfg.n_img_tokens, cfg.d_model),
                                        dt)}
        if cfg.family == "encdec":
            return {"tokens": _meta((b, s), tok),
                    "targets": _meta((b, s), tok),
                    "frames": _meta((b, cfg.enc_positions, cfg.d_model), dt)}
        return {"tokens": _meta((b, s), tok), "targets": _meta((b, s), tok)}

    if shape.kind == "prefill":
        out = {"tokens": _meta((b, s), tok)}
        if cfg.family == "vlm":
            out["tokens"] = _meta((b, s - cfg.n_img_tokens), tok)
            out["img_embeds"] = _meta((b, cfg.n_img_tokens, cfg.d_model), dt)
        if cfg.family == "encdec":
            out["frames"] = _meta((b, cfg.enc_positions, cfg.d_model), dt)
        return out

    # decode: one new token against a cache of length seq
    cache = model.init_cache(cfg, b, s, "meta")
    return {"token": _meta((b, 1), tok), "cache": cache,
            "pos": _meta((), tok)}
