"""The LM kernels on the card: B3 (both routes, also with keys of a length
of their own) and B4 against their plain versions (B4 bit-identical over
two launches), the wrappers' refusals, and their launches through
``prefill`` (B4 24 times in mamba2-130m's at full depth; B3 in the reduced
hybrid, vlm and encdec families, and in encdec's decode steps).  An LM artifact saved on the card (fp32 and bf16) loads on the
card with every leaf bit for bit and the same tokens, and on the CPU with
every leaf bit for bit.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor the reference, so it also runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import compile_lm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.models.lm import model as TM

pytestmark = pytest.mark.cuda

# kernel vs plain: fp32 sums in another order; bf16 compared in fp32 after
# the output's rounding to bf16 (the two may differ by one bf16 step, 2^-7
# relative at most, under the rtol; the atol is twice the largest error
# chip_smoke.py measured for the FMA kernel on bf16; the sm90 route's P in
# bf16 stays inside both, chip_smoke.py's ATTN_TOL note)
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=8e-3)}
# per-position log-decay steps -dt*A: "slow" is Mamba-2's dt*A range, so
# every column of a 256-token chunk adds well above the tolerance; "none"
# (acum = 0) weighs all columns alike; "steep" hides columns more than ~40
# positions back and checks the exponent's range
DECAY = {"slow": (1e-3, 2e-2), "steep": (0.01, 0.5), "none": None}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, hq, hkv, s, d, dtype, device):
    g = torch.Generator().manual_seed(0)
    return [torch.randn((b, h, s, d), generator=g).to(device=device,
                                                      dtype=dtype)
            for h in (hq, hkv, hkv)]


# (B, Hq, Hkv, S, D, causal, window): each in fp32 (the FMA route) and
# bf16 (the sm90 route), then bf16 only: kimi-k2's 112 and stablelm-3b's
# 80, ragged S (700; 129, one row past a q tile), D = 256 with a window,
# batch 4; and fp32 at 112 and 80, head dims that the FMA route refused
# until ROADMAP C1 was repaired
BOTH = [(1, 12, 2, 300, 128, True, 0), (2, 4, 4, 65, 64, False, 0),
        (1, 4, 1, 200, 256, True, 64), (2, 4, 2, 17, 16, True, 0),
        (1, 2, 1, 96, 64, False, 40)]
BF16_ONLY = [(1, 8, 1, 300, 112, True, 0), (1, 4, 2, 333, 80, True, 0),
             (1, 12, 2, 700, 128, True, 0), (1, 4, 1, 129, 128, True, 0),
             (1, 10, 1, 300, 256, True, 64), (4, 12, 2, 256, 128, True, 0),
             (2, 4, 2, 150, 80, False, 32)]
FP32_HEAD_DIMS = [(1, 8, 1, 300, 112, True, 0), (1, 4, 2, 333, 80, True, 0),
                  (2, 4, 2, 150, 80, False, 32)]
ROUTE = {torch.float32: "fma", torch.bfloat16: "sm90"}


@pytest.mark.parametrize("dtype,b,hq,hkv,s,d,causal,window", [
    *[(dt, *c) for c in BOTH for dt in (torch.float32, torch.bfloat16)],
    *[(torch.bfloat16, *c) for c in BF16_ONLY],
    *[(torch.float32, *c) for c in FP32_HEAD_DIMS]])
def test_flash_kernel_matches_plain(card, dtype, b, hq, hkv, s, d, causal,
                                    window):
    q, k, v = _qkv(b, hq, hkv, s, d, dtype, card)
    before = fa.flash_attention.launches
    by_route = dict(fa.flash_attention.launches_by_route)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    by_route[ROUTE[dtype]] += 1
    assert fa.flash_attention.launches_by_route == by_route
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# (B, Hq, Hkv, S, Sk, D, causal): keys of their own length (whisper's
# cross-attention: a decode step, a prompt, a tile and a half of queries
# against 1,500 encoder positions), fewer keys than queries, causal ones
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,sk,d,causal", [
    (1, 6, 6, 1, 1500, 64, False), (4, 6, 6, 4, 1500, 64, False),
    (1, 6, 6, 200, 1500, 64, False), (2, 4, 2, 300, 77, 128, False),
    (1, 4, 1, 150, 90, 256, True), (1, 4, 2, 70, 500, 64, True)])
def test_flash_kernel_with_a_kv_length_of_its_own(card, dtype, b, hq, hkv, s,
                                                  sk, d, causal):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).to(device=card, dtype=dtype)
               for shape in ((b, hq, s, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    by_route = dict(fa.flash_attention.launches_by_route)
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    by_route[ROUTE[dtype]] += 1
    assert fa.flash_attention.launches_by_route == by_route
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_flash_wrapper_rejects_what_the_kernel_cannot_take(card):
    q, k, v = _qkv(1, 4, 2, 16, 64, torch.float32, card)
    strided = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(strided, k, v)
    with pytest.raises(TypeError, match="share"):
        fa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :40].contiguous(), k[..., :40].contiguous(),
                           v[..., :40].contiguous())
    q16, k16, v16 = (t[..., :40].bfloat16().contiguous() for t in (q, k, v))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q16, k16, v16)
    # contiguous but 2 bytes past an aligned start: TMA needs 16
    kb, vb = k.bfloat16(), v.bfloat16()
    shifted = torch.empty(q.numel() + 1, dtype=torch.bfloat16,
                          device=card)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(shifted, kb, vb)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(q[:, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention(q, k.cpu(), v)
    # a window needs every query row to reach a key; no keys at all
    with pytest.raises(ValueError, match="Sk >= S"):
        fa.flash_attention(q, k[:, :, :8].contiguous(),
                           v[:, :, :8].contiguous(), window=4)
    with pytest.raises(ValueError, match="Sk = 0"):
        fa.flash_attention(q, k[:, :, :0], v[:, :, :0])
    with pytest.raises(ValueError, match="must be"):
        fa.flash_attention(q, k, v[:, :, :8].contiguous())


# (BC, H, Q, N, P, decay): mamba2-130m's 512-token shape, its 2,048-token
# one (BC = 8), 23 heads at BC = 8 (the plan takes 4 a block, so the last
# group has 3), the reduced config's chunk, and ragged Q, N and P
@pytest.mark.parametrize("bcn,h,q,n,p,decay", [
    (2, 24, 256, 128, 64, "steep"), (2, 24, 256, 128, 64, "slow"),
    (1, 24, 256, 128, 64, "none"), (3, 8, 8, 16, 16, "steep"),
    (1, 3, 100, 20, 40, "slow"), (8, 24, 256, 128, 64, "slow"),
    (8, 23, 256, 128, 64, "slow")])
def test_ssd_kernel_matches_plain(card, bcn, h, q, n, p, decay):
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(card)

    scale = n ** -0.25
    steps = DECAY[decay]
    args = (t(rng.normal(0, scale, size=(bcn, q, n))),
            t(rng.normal(0, scale, size=(bcn, q, n))),
            t(np.zeros((bcn, h, q)) if steps is None else
              -np.cumsum(rng.uniform(*steps, size=(bcn, h, q)), axis=-1)),
            t(rng.normal(size=(bcn, h, q, p))))
    before = sc.ssd_intra.launches
    got = sc.ssd_intra(*args)
    torch.cuda.synchronize()
    assert sc.ssd_intra.launches == before + 1
    torch.testing.assert_close(got, sc.ssd_intra_plain(*args),
                               **TOL[torch.float32])
    # no atomics, no order that depends on timing
    assert torch.equal(sc.ssd_intra(*args), got)
    assert sc.ssd_intra.launches == before + 2


def test_ssd_wrapper_rejects_what_the_kernel_cannot_take(card):
    cc = torch.zeros((2, 8, 4), device=card)
    acum = torch.zeros((2, 3, 8), device=card)
    xd = torch.zeros((2, 3, 8, 4), device=card)
    with pytest.raises(TypeError, match="float32"):
        sc.ssd_intra(cc.double(), cc, acum, xd)
    with pytest.raises(ValueError, match="shape"):
        sc.ssd_intra(cc, cc[:, :7], acum, xd)
    with pytest.raises(ValueError, match="above the kernel"):
        sc.ssd_intra(cc, cc, acum, torch.zeros((2, 3, 8, 80), device=card))
    wide = torch.zeros((2, 8, 132), device=card)
    with pytest.raises(ValueError, match="state dim"):
        sc.ssd_intra(wide, wide, acum, xd)


def test_mamba2_full_depth_prefill_launches_b4_per_layer(card):
    """mamba2-130m at full width and depth (bf16, random weights): a
    2,048-token prefill launches B4 once in each of its 24 layers."""
    cfg = ARCHS["mamba2-130m"]
    params = TM.init_params(cfg, seed=0, device=card)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(1, 2048))).to(card)
    before = sc.ssd_intra.launches
    _, logits = TM.prefill(params, cfg, toks, max_len=2048)
    torch.cuda.synchronize()
    assert sc.ssd_intra.launches - before == cfg.n_layers == 24
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-130m"])
def test_prefill_launches_once_per_layer_and_matches_cpu(card, name):
    cfg = reduced(ARCHS[name])
    params = TM.init_params(cfg, seed=0, device="cpu")
    fn = fa.flash_attention if cfg.family == "dense" else sc.ssd_intra
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 21)))
    before = fn.launches
    cache, logits = TM.prefill(TM.params_to(params, card), cfg,
                               toks.to(card), max_len=32)
    torch.cuda.synchronize()
    assert fn.launches - before == cfg.n_layers
    _, want = TM.prefill(params, cfg, toks, max_len=32)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
    sess = compile_lm(cfg, max_len=32, params=TM.params_to(params, card))
    before = fn.launches
    out = sess.generate(toks[:1, :13].numpy(), 4)    # bucket 8 + catch-up
    assert fn.launches - before == cfg.n_layers
    assert out.shape == (1, 4) and 0 <= out.min() and out.max() < cfg.vocab


# B3 a prefill and a decode step of the reduced A8 families: hybrid's
# attention layers (1 of 3), vlm's layers, encdec's encoder, decoder and
# cross-attention (and the cross-attention of each decode step)
A8_LAUNCHES = {"recurrentgemma-2b": (1, 0), "llava-next-mistral-7b": (2, 0),
               "whisper-tiny": (6, 2)}


@pytest.mark.parametrize("name", sorted(A8_LAUNCHES))
def test_a8_family_launches_b3_and_matches_cpu(card, name):
    cfg = reduced(ARCHS[name])
    params = TM.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 12)))
    extra, pos = {}, 12
    if cfg.family == "vlm":
        extra["img_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_img_tokens, cfg.d_model), dtype=np.float32))
        pos += cfg.n_img_tokens
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_positions, cfg.d_model), dtype=np.float32))
    per_prefill, per_step = A8_LAUNCHES[name]
    dev = TM.params_to(params, card)
    before = fa.flash_attention.launches
    cache, logits = TM.prefill(dev, cfg, toks.to(card), max_len=32,
                               **{k: v.to(card) for k, v in extra.items()})
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - before == per_prefill
    want_cache, want = TM.prefill(params, cfg, toks, max_len=32, **extra)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
    # past the reduced hybrid's window of 8: the ring has wrapped
    nxt = toks[:, -1:]
    for p in range(pos, pos + 3):
        before = fa.flash_attention.launches
        logits, cache = TM.decode_step(dev, cfg, nxt.to(card), cache, p)
        assert fa.flash_attention.launches - before == per_step
        want, want_cache = TM.decode_step(params, cfg, nxt, want_cache, p)
        torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-130m"])
def test_lm_artifact_saved_and_loaded_on_card(card, tmp_path, name, dtype):
    """An LM artifact saved on the card loads on the card with every leaf
    bit for bit and the same tokens, launching its kernel once per layer
    per prefill.  Loaded onto the CPU its leaves are the card's bit for
    bit, and an fp32 one's prefill logits agree with the card's as in
    ``test_prefill_launches_once_per_layer_and_matches_cpu``."""
    import dataclasses

    from repro_torch.engine import LMSession

    cfg = dataclasses.replace(reduced(ARCHS[name]), dtype=dtype)
    sess = compile_lm(cfg, max_len=32, device=card)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(1, 13))
    want = sess.generate(toks, 4)
    sess.save(tmp_path / "lm")
    loaded = LMSession.load(tmp_path / "lm", device=card)
    on_cpu = LMSession.load(tmp_path / "lm", device="cpu")
    leaves = dict(_leaves(sess._params))
    cpu_leaves = dict(_leaves(on_cpu._params))
    for path, t in _leaves(loaded._params):
        assert t.device.type == "cuda" and t.dtype == leaves[path].dtype
        assert torch.equal(t, leaves[path]), path
        assert torch.equal(cpu_leaves[path], t.cpu()), path
    fn = fa.flash_attention if cfg.family == "dense" else sc.ssd_intra
    before = fn.launches
    np.testing.assert_array_equal(loaded.generate(toks, 4), want)
    assert fn.launches - before == cfg.n_layers       # bucket 8
    if dtype == "float32":
        x = torch.from_numpy(toks[:, :8])
        _, card_logits = TM.prefill(loaded._params, cfg, x.to(card),
                                    max_len=32)
        _, cpu_logits = TM.prefill(on_cpu._params, cfg, x, max_len=32)
        torch.testing.assert_close(card_logits.cpu(), cpu_logits,
                                   rtol=1e-4, atol=1e-4)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v
