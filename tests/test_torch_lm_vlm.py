"""Port parity: the vision-language family (llava-next-mistral-7b) against
the reference, on the CPU.

Reduced llava (2 dense layers, GQA 4:4, 8 image tokens from a stub
frontend), with the reference's parameters carried over by
``lm_params_from_numpy``: ``forward`` and ``prefill`` with the image
embeddings before the text, then decode steps from position
``n_img_tokens + len``, hold the reference's logits to 1e-4 of the
largest, and the KV cache to rtol = atol = 1e-4.  A bf16 copy casts fp32
image embeddings to the model's type, as the reference does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.models.lm import model as RM
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import compile, lm_params_from_numpy
from repro_torch.models.lm import model as TM

NAME = "llava-next-mistral-7b"
REL = 1e-4
R_PREFILL = jax.jit(RM.prefill, static_argnums=(1,),
                    static_argnames=("max_len",))
R_DECODE = jax.jit(RM.decode_step, static_argnums=(1,))
R_FORWARD = jax.jit(RM.forward, static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def _setup(dtype="float32", seed=0):
    r_cfg = dataclasses.replace(r_reduced(R_ARCHS[NAME]), dtype=dtype)
    t_cfg = dataclasses.replace(reduced(ARCHS[NAME]), dtype=dtype)
    r_p = RM.init_params(r_cfg, jax.random.PRNGKey(seed))
    return r_cfg, t_cfg, r_p, lm_params_from_numpy(r_p, "cpu")


def _inputs(cfg, batch, text, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(batch, text))
    img = rng.standard_normal((batch, cfg.n_img_tokens, cfg.d_model),
                              dtype=np.float32)
    return toks, img


def _close_rel(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max() \
        / np.abs(want).max()
    assert err <= rel, err


def test_forward_with_image_embeddings_matches_reference():
    r_cfg, t_cfg, r_p, t_p = _setup()
    toks, img = _inputs(t_cfg, 2, 7)
    want, _ = R_FORWARD(r_p, r_cfg, jnp.asarray(toks),
                        img_embeds=jnp.asarray(img))
    got = TM.forward(t_p, t_cfg, torch.from_numpy(toks),
                     img_embeds=torch.from_numpy(img))
    assert got.shape == (2, t_cfg.n_img_tokens + 7, t_cfg.vocab)
    _close_rel(got.numpy(), want)
    with pytest.raises(ValueError, match="img_embeds"):
        TM.forward(t_p, t_cfg, torch.from_numpy(toks))


@pytest.mark.parametrize("text", [1, 6])
def test_prefill_then_decode_from_after_the_image(text):
    """Prefill of the image and ``text`` tokens, then decode steps at
    positions n_img_tokens + text onwards, each against the reference and
    against the port's own forward over the whole sequence."""
    r_cfg, t_cfg, r_p, t_p = _setup()
    toks, img = _inputs(t_cfg, 2, text + 4, seed=text)
    n = t_cfg.n_img_tokens
    full = TM.forward(t_p, t_cfg, torch.from_numpy(toks),
                      img_embeds=torch.from_numpy(img))
    r_cache, r_lg = R_PREFILL(r_p, r_cfg, jnp.asarray(toks[:, :text]),
                              max_len=32, img_embeds=jnp.asarray(img))
    t_cache, t_lg = TM.prefill(t_p, t_cfg, torch.from_numpy(toks[:, :text]),
                               max_len=32, img_embeds=torch.from_numpy(img))
    _close_rel(t_lg.numpy(), r_lg)
    for j in range(text, text + 4):
        p = n + j
        r_lg, r_cache = R_DECODE(r_p, r_cfg, jnp.asarray(toks[:, j:j + 1]),
                                 r_cache, jnp.int32(p))
        t_lg, t_cache = TM.decode_step(t_p, t_cfg,
                                       torch.from_numpy(toks[:, j:j + 1]),
                                       t_cache, p)
        _close_rel(t_lg.numpy(), r_lg)
        _close_rel(t_lg.numpy(), full[:, p].numpy())
    for k in ("k", "v"):
        np.testing.assert_allclose(t_cache[k].numpy(), np.asarray(r_cache[k]),
                                   rtol=1e-4, atol=1e-4)


def test_bf16_casts_the_image_embeddings():
    r_cfg, t_cfg, r_p, t_p = _setup("bfloat16")
    toks, img = _inputs(t_cfg, 1, 5)
    _, r_lg = R_PREFILL(r_p, r_cfg, jnp.asarray(toks), max_len=16,
                        img_embeds=jnp.asarray(img))
    cache, t_lg = TM.prefill(t_p, t_cfg, torch.from_numpy(toks), max_len=16,
                             img_embeds=torch.from_numpy(img))
    assert t_lg.dtype == cache["k"].dtype == torch.bfloat16
    # a few bf16 roundings (2^-8 each) through two layers
    _close_rel(t_lg.float().numpy(), r_lg, rel=3e-2)


def test_session_serves_text_prompts():
    """As in the reference, a vlm session takes tokens only: its
    prefills are text-only, on the dense layers."""
    _, t_cfg, _, t_p = _setup()
    sess = compile(t_cfg, (1, 16), params=t_p, device="cpu")
    toks, _ = _inputs(t_cfg, 1, 11)
    out = sess.generate(toks, 3)
    want = TM.forward(t_p, t_cfg, torch.from_numpy(toks),
                      img_embeds=torch.zeros((1, 0, t_cfg.d_model)))
    assert out.shape == (1, 3)
    assert out[0, 0] == int(want[0, -1].argmax())
