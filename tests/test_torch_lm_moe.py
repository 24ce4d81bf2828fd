"""Port parity: the moe family (reduced arctic-480b and kimi-k2).

``moe_capacity`` and ``moe_ffn`` (``repro_torch/models/lm/layers.py``)
against the reference's, with and without capacity drops; ``forward``,
``prefill``, ``decode_step`` and an ``LMSession``'s greedy tokens against
the reference (``repro/models/lm``), with the reference's parameters carried
over by ``lm_params_from_numpy``; the moe parameter tree and the repaired
``init_params`` draws.  fp32; tolerance rtol = atol = 1e-4 on outputs and
logits (two layers of fp32 sums of up to a few hundred terms, in another
order), 1e-5 relative on the load-balance loss, and the dropped share
exact (both sides route the same tokens: no router probabilities here lie
within 1e-6 of a tie).  chip_smoke.py's arctic phases run here at a tiny
size.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.engine import compile_lm as r_compile_lm
from repro.models.lm import layers as RL
from repro.models.lm import model as RM
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import compile, compile_lm, lm_params_from_numpy
from repro_torch.models.lm import layers as TL
from repro_torch.models.lm import model as TM

TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-4
NAMES = ("arctic-480b", "kimi-k2-1t-a32b")


def _setup(name, seed=0, **overrides):
    r_cfg = dataclasses.replace(r_reduced(R_ARCHS[name]), **overrides)
    t_cfg = dataclasses.replace(reduced(ARCHS[name]), **overrides)
    r_p = RM.init_params(r_cfg, jax.random.PRNGKey(seed))
    return r_cfg, t_cfg, r_p, lm_params_from_numpy(r_p, "cpu")


def _toks(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


def _layer0_moe(r_p):
    return jax.tree_util.tree_map(lambda v: v[0], r_p["layers"]["moe"])


def _moe_inputs(r_cfg, r_p, t, skew, seed=2):
    """Tokens x (T, d) and layer 0's moe parameters; ``skew`` adds a
    common direction to the tokens and to experts 0 and 1 of the router,
    so that most tokens choose those two and overflow their capacity."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, r_cfg.d_model)).astype(np.float32)
    lp = _layer0_moe(r_p)
    if skew:
        u = rng.normal(size=r_cfg.d_model).astype(np.float32)
        u /= np.linalg.norm(u)
        x = x + 2.0 * u
        router = np.asarray(lp["router"]).copy()
        router[:, :2] += 1.5 * u[:, None]
        lp = dict(lp, router=jnp.asarray(router))
    return x, lp


# ---------------------------------------------------------------------------
# moe_capacity and moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_tokens", [1, 4, 8, 32, 33, 64, 100, 512, 1024,
                                      2048, 4096])
def test_moe_capacity_matches_reference(name, n_tokens):
    for t_cfg, r_cfg in ((ARCHS[name], R_ARCHS[name]),
                         (reduced(ARCHS[name]), r_reduced(R_ARCHS[name]))):
        assert TL.moe_capacity(n_tokens, t_cfg) == \
            RL.moe_capacity(n_tokens, r_cfg)


def test_arctic_capacities_on_the_card_path():
    """The capacities chip_smoke.py reports for arctic-480b's prefill
    buckets, and the dropless floor of its decode steps."""
    cfg = ARCHS["arctic-480b"]
    assert [TL.moe_capacity(t, cfg) for t in (2048, 1024, 512)] == \
        [40, 20, 10]
    assert [TL.moe_capacity(t, cfg) for t in (1, 4)] == [2, 8]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["no_drops", "skewed", "low_capacity"])
def test_moe_ffn_matches_reference(name, case):
    """T = 64 tokens: capacity 32 against a mean load of 16 (no drops),
    the same with a skewed router, and capacity factor 0.5 (capacity 8)."""
    over = {"capacity_factor": 0.5} if case == "low_capacity" else {}
    r_cfg, t_cfg, r_p, _ = _setup(name, **over)
    x, lp = _moe_inputs(r_cfg, r_p, 64, skew=case == "skewed")
    ry, raux = RL.moe_ffn(jnp.asarray(x), lp, r_cfg)
    ty, taux = TL.moe_ffn(torch.from_numpy(x), lm_params_from_numpy(lp, "cpu"),
                          t_cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(float(taux["lb_loss"]), float(raux["lb_loss"]),
                               rtol=1e-5)
    assert float(taux["dropped_frac"]) == float(raux["dropped_frac"])
    if case == "no_drops":
        assert float(taux["dropped_frac"]) == 0.0
    else:
        assert float(taux["dropped_frac"]) > 0.2


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("t", [1, 4, 32])
def test_moe_ffn_dropless_floor(name, t):
    """Up to 64 token-expert assignments run dropless whatever the router:
    decode at batch 1 and 4, and 32 tokens of top-2, all skewed."""
    r_cfg, t_cfg, r_p, _ = _setup(name)
    x, lp = _moe_inputs(r_cfg, r_p, t, skew=True)
    ry, raux = RL.moe_ffn(jnp.asarray(x), lp, r_cfg)
    ty, taux = TL.moe_ffn(torch.from_numpy(x), lm_params_from_numpy(lp, "cpu"),
                          t_cfg)
    assert float(taux["dropped_frac"]) == 0.0 == float(raux["dropped_frac"])
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)


def test_router_runs_through_dense_softmax(monkeypatch):
    """Each moe layer routes through dense_softmax, once per prefill and
    once per decode step: the call a CUDA tensor takes to B2."""
    _, t_cfg, _, t_p = _setup("arctic-480b")
    calls = []
    real = TL.dense_softmax

    def counting(x, w, **kw):
        calls.append(tuple(x.shape))
        return real(x, w, **kw)

    monkeypatch.setattr(TL, "dense_softmax", counting)
    toks = torch.from_numpy(_toks(t_cfg, (2, 9)))
    cache, _ = TM.prefill(t_p, t_cfg, toks, max_len=16)
    assert calls == [(18, t_cfg.d_model)] * t_cfg.n_layers
    TM.decode_step(t_p, t_cfg, toks[:, :1], cache, 9)
    assert calls[t_cfg.n_layers:] == [(2, t_cfg.d_model)] * t_cfg.n_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_passes_its_operands_as_they_are(monkeypatch, dtype):
    """The router hands dense_softmax the model's own operands (bf16 in a
    bf16 model, no cast kernels) and asks for fp32 probabilities, the
    reference's x.astype(f32) @ router.astype(f32) then softmax."""
    cfg = dataclasses.replace(reduced(ARCHS["arctic-480b"]), dtype=dtype)
    params = TM.init_params(cfg, seed=0, device="cpu")
    seen = []
    real = TL.dense_softmax

    def spy(x, w, **kw):
        out = real(x, w, **kw)
        seen.append((x.dtype, w.dtype, kw.get("out_dtype"), out.dtype))
        return out

    monkeypatch.setattr(TL, "dense_softmax", spy)
    toks = torch.from_numpy(_toks(cfg, (2, 9)))
    cache, _ = TM.prefill(params, cfg, toks, max_len=16)
    TM.decode_step(params, cfg, toks[:, :1], cache, 9)
    want = getattr(torch, dtype)
    assert seen == [(want, want, torch.float32, torch.float32)] \
        * (2 * cfg.n_layers)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_init_params_tree_matches_reference(name):
    """Same tree, shapes and types as the reference's init_params, and the
    reference's scales (its expert up-projections at 1/sqrt(E))."""
    r_cfg, t_cfg, r_p, _ = _setup(name)
    t_p = TM.init_params(t_cfg, seed=0, device="cpu")
    r_flat = {tuple(p.key for p in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(r_p)[0]}
    t_flat = dict(_walk(t_p))
    assert set(r_flat) == set(t_flat)
    for key, leaf in r_flat.items():
        assert tuple(t_flat[key].shape) == leaf.shape, key
        assert str(t_flat[key].dtype).replace("torch.", "") == \
            str(leaf.dtype), key
        if leaf.ndim >= 2 and float(np.std(leaf)) > 0:
            ratio = float(t_flat[key].std()) / float(np.std(leaf))
            assert 0.8 < ratio < 1.25, (key, ratio)
    assert sum(v.numel() for v in t_flat.values()) == \
        sum(leaf.size for leaf in r_flat.values())
    assert "moe" in t_p["layers"] and "mlp" not in t_p["layers"]


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("name", NAMES + ("qwen2-1.5b", "mamba2-130m"))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_draws_one_matrix_chunk_at_a_time(monkeypatch, name, dtype):
    """``init_params`` fills each leaf in its own type from draws of at
    most ``DRAW_ELEMS`` fp32 values, never a whole stacked leaf in fp32:
    with the limit set to one reduced expert matrix (d x moe_d_ff) no draw
    is larger, and every tree keeps its shapes and types."""
    cfg = dataclasses.replace(reduced(ARCHS[name]), dtype=dtype)
    want = {k: (tuple(v.shape), v.dtype) for k, v in
            _walk(TM.init_params(cfg, seed=0, device="cpu"))}
    limit = 64 * 96
    sizes, real = [], torch.randn

    def recording(*shape, **kw):
        out = real(*shape, **kw)
        sizes.append((out.numel(), out.dtype))
        return out

    monkeypatch.setattr(TM, "DRAW_ELEMS", limit)
    monkeypatch.setattr(torch, "randn", recording)
    got = {k: (tuple(v.shape), v.dtype) for k, v in
           _walk(TM.init_params(cfg, seed=0, device="cpu"))}
    assert got == want
    assert sizes and max(n for n, _ in sizes) <= limit
    assert {d for _, d in sizes} == {torch.float32}
    # the default bound lies below one arctic-480b expert matrix in fp32
    full = ARCHS["arctic-480b"]
    assert TM.DRAW_ELEMS < full.d_model * full.moe_d_ff


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    r_cfg, t_cfg, r_p, t_p = _setup(name)
    toks = _toks(r_cfg, (2, 21))
    want, _ = RM.forward(r_p, r_cfg, jnp.asarray(toks))
    got = TM.forward(t_p, t_cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_reference(name):
    """Prefill's last logits and K/V cache, then three decode steps."""
    r_cfg, t_cfg, r_p, t_p = _setup(name)
    toks = _toks(r_cfg, (2, 13))
    r_cache, r_lg = RM.prefill(r_p, r_cfg, jnp.asarray(toks), max_len=24)
    t_cache, t_lg = TM.prefill(t_p, t_cfg, torch.from_numpy(toks),
                               max_len=24)
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(r_lg), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(t_cache[key].numpy(),
                                   np.asarray(r_cache[key]), **TOL)
    nxt = _toks(r_cfg, (2, 3), seed=7)
    for i in range(3):
        step = nxt[:, i:i + 1]
        r_lg, r_cache = RM.decode_step(r_p, r_cfg, jnp.asarray(step),
                                       r_cache, jnp.int32(13 + i))
        t_lg, t_cache = TM.decode_step(t_p, t_cfg, torch.from_numpy(step),
                                       t_cache, 13 + i)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(r_lg), **TOL)
    np.testing.assert_allclose(t_cache["k"].numpy(), np.asarray(r_cache["k"]),
                               **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_shared_and_dense_mlps_follow_the_reference(name):
    """The reference looks for the shared (kimi-k2) and dense residual
    (arctic) MLPs at the layer level, where its tree never has them: they
    do not change its output, nor the port's (ROADMAP C)."""
    r_cfg, t_cfg, r_p, t_p = _setup(name)
    extra = "dense" if t_cfg.dense_residual else "shared"
    assert extra in t_p["layers"]["moe"]
    toks = torch.from_numpy(_toks(r_cfg, (1, 9)))
    before = TM.forward(t_p, t_cfg, toks)
    moe = t_p["layers"]["moe"]
    moe[extra] = {k: torch.zeros_like(v) for k, v in moe[extra].items()}
    assert torch.equal(TM.forward(t_p, t_cfg, toks), before)


def _margins(r_cfg, params, toks, new, max_len):
    """Top-2 margins, relative to the largest logit, along the
    reference's greedy path."""
    cache, lg = RM.prefill(params, r_cfg, jnp.asarray(toks), max_len=max_len)
    out = []
    for t in range(new):
        a = np.asarray(lg)
        top2 = np.sort(a, axis=-1)[:, -2:]
        out.append(((top2[:, 1] - top2[:, 0]) / np.abs(a).max()).min())
        nxt = jnp.argmax(lg, -1).astype(jnp.int32)
        lg, cache = RM.decode_step(params, r_cfg, nxt[:, None], cache,
                                   jnp.int32(toks.shape[1] + t))
    return out


@pytest.mark.parametrize("name,prompt_len,batch", [
    ("arctic-480b", 5, 1), ("arctic-480b", 13, 1), ("arctic-480b", 11, 2),
    ("kimi-k2-1t-a32b", 13, 1)])
def test_generate_matches_reference(name, prompt_len, batch):
    """Below buckets {8, 16} (decode only), a bucket plus catch-up, and a
    batch of 2: equal greedy tokens wherever the reference's top-2 margin
    exceeds 1e-4."""
    r_cfg = r_reduced(R_ARCHS[name])
    ref = r_compile_lm(r_cfg, max_len=32, batch=batch, seq_buckets=[8, 16],
                       seed=0)
    port = compile_lm(reduced(ARCHS[name]), max_len=32, batch=batch,
                      seq_buckets=[8, 16],
                      params=lm_params_from_numpy(ref._params, "cpu"))
    toks = _toks(r_cfg, (batch, prompt_len))
    want = ref.generate(jnp.asarray(toks), 6)
    got = port.generate(toks, 6)
    assert got.dtype == np.int32 and got.shape == (batch, 6)
    compared = 0
    for t, m in enumerate(_margins(r_cfg, ref._params, toks, 6, 32)):
        same = np.array_equal(got[:, t], want[:, t])
        if m > MARGIN:
            assert same, f"step {t} differs with a top-2 margin of {m}"
            compared += 1
        elif not same:
            break
    assert compared > 0


def test_compile_serves_the_moe_family():
    """The front door takes a moe config and an arch name, and since the
    A8 families were ported, a hybrid one too: it initialises, caches and
    generates at reduced size."""
    cfg = reduced(ARCHS["arctic-480b"])
    sess = compile(cfg, (1, 16), device="cpu")
    assert sess.cfg.family == "moe"
    out = sess.generate(_toks(cfg, (1, 10)), 3)
    assert out.shape == (1, 3)
    hybrid = reduced(ARCHS["recurrentgemma-2b"])
    out = compile(hybrid, (1, 16), device="cpu").generate(
        _toks(hybrid, (1, 10)), 3)
    assert out.shape == (1, 3) and 0 <= out.min() and out.max() < 512


def test_compile_serves_kimi_k2():
    """kimi-k2, which the family gate refused before the moe family was
    ported, now compiles and generates (on the CPU: B3 has no head_dim
    112 instantiation on the card yet)."""
    cfg = reduced(ARCHS["kimi-k2-1t-a32b"])
    sess = compile(cfg, (1, 16), device="cpu")
    assert sess.cfg.family == "moe" and sess.cfg.n_shared_experts > 0
    out = sess.generate(_toks(cfg, (1, 10)), 3)
    assert out.shape == (1, 3)
    assert ((out >= 0) & (out < cfg.vocab)).all()


# ---------------------------------------------------------------------------
# chip_smoke.py's arctic phases, rehearsed on the CPU
# ---------------------------------------------------------------------------

def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_moe_phases_run_on_cpu():
    """On CPU tensors the wrappers take the plain versions, so the main
    path counts no launches; parity of the CPU against itself is exact and
    finds no routing near-tie."""
    smoke = _smoke()
    cfg = reduced(ARCHS["arctic-480b"])
    assert smoke.lm_kernels_of(smoke.arctic_config()) == {
        "flash_attention": (2, 0), "matmul_blocked": (2, 2)}
    out = smoke.phase_lm_main("cpu", cfg, max_len=32,
                              requests=((32, 1), (16, 3), (13, 3), (5, 2)),
                              big=(2, 16, 8, 2))
    assert out["prefills"] == 4 and out["launches"] == 0
    assert [p["capacity"] for p in out["moe_prefills"]] == [
        TL.moe_capacity(t, cfg) for t in (32, 16, 8, 16)]
    assert all(len(p["dropped_frac"]) == cfg.n_layers
               for p in out["moe_prefills"])
    # the recorder wraps the router and moe_ffn, and puts them back
    r_cfg, t_cfg, r_p, _ = _setup("arctic-480b")
    x, lp = _moe_inputs(r_cfg, r_p, 64, skew=True)
    real = TL.moe_ffn, TL.dense_softmax
    with smoke.moe_recording() as calls:
        _, aux = TL.moe_ffn(torch.from_numpy(x),
                            lm_params_from_numpy(lp, "cpu"), t_cfg)
    assert (TL.moe_ffn, TL.dense_softmax) == real
    assert len(calls) == 1 and calls[0]["capacity"] == 32
    assert calls[0]["probs"].shape == (64, t_cfg.n_experts)
    assert float(calls[0]["dropped_frac"]) == float(aux["dropped_frac"]) > 0
    par = smoke.phase_lm_parity("cpu", cfg, n_layers=1, n_experts=4,
                                max_len=32, prompt=19, new=3)
    assert par["max_logit_err_rel"] == 0.0 and par["tokens_compared"] == 3
    assert par["routing_near_ties"] == 0 and par["bucket"] == 16
    # the teacher-forced forward covers prompt + new - 1 positions
    assert par["forward_positions_compared"] == 21
    assert par["forward_near_ties"] == 0


def test_chip_smoke_mm_cases_take_their_route():
    """chip_smoke.py's B2 cases name the route the wrapper picks: the bf16
    router on the tensor cores at prefill and split K at decode, its fp32
    parity copy on the FMA kernel at prefill, and every route checked on
    the reference's tails."""
    from repro_torch.kernels.matmul_blocked import _route

    smoke = _smoke()
    routes = {name: _route(m, k, n, dt)
              for name, m, k, n, _, dt in smoke.mm_cases()}
    assert routes["router_m2048_bfloat16"] == "sm90"
    assert routes["router_m1_bfloat16"] == routes["router_m4_bfloat16"] \
        == routes["router_m63_bfloat16"] == "splitk"
    assert routes["router_m64_bfloat16"] == "sm90"
    assert routes["router_m2048_float32"] == "fma"
    assert routes["kimi_k2_router_m2048_bfloat16"] == "sm90"
    assert routes["router_identity_m2048_bfloat16"] == "sm90"
    for tail in smoke.MM_SPECS:
        assert {routes[f"{tail}_{s}_bfloat16"] for s in
                ("128x128x128", "96x64x80", "40x32x200")} == {"sm90",
                                                              "splitk"}


@pytest.mark.parametrize("tie", [5, 0])
def test_chip_smoke_parity_compares_logits_before_a_prompt_tie(monkeypatch,
                                                                tie):
    """A routing near-tie inside the prompt leaves no generate step to
    compare; the teacher-forced forward still holds the logits of every
    position before it, and a tie at position 0 fails the phase rather
    than passing with nothing compared."""
    smoke = _smoke()
    monkeypatch.setattr(smoke, "routing_near_ties",
                        lambda trace, n_layers, top_k, tol=None: [tie])
    cfg = reduced(ARCHS["arctic-480b"])
    kw = dict(n_layers=1, n_experts=4, max_len=32, prompt=19, new=3)
    if tie == 0:
        with pytest.raises(RuntimeError, match="position 0"):
            smoke.phase_lm_parity("cpu", cfg, **kw)
        return
    par = smoke.phase_lm_parity("cpu", cfg, **kw)
    assert par["steps_compared"] == 0 and par["tokens_compared"] == 0
    assert par["forward_positions_compared"] == tie
    assert par["max_logit_err_rel"] == 0.0


def test_routing_near_ties_finds_positions():
    """A tie between the 2nd and 3rd expert at prompt position 3 and at
    the second decode step (position 5 of a 4-token prefill)."""
    smoke = _smoke()
    probs = torch.tensor([[0.5, 0.3, 0.2, 0.0]] * 4)
    probs[3] = torch.tensor([0.4, 0.3, 0.3, 0.0])
    step = torch.tensor([[0.6, 0.3, 0.1, 0.0]])
    trace = [{"probs": probs}, {"probs": step},
             {"probs": torch.tensor([[0.5, 0.25, 0.25 - 1e-7, 0.0]])}]
    assert smoke.routing_near_ties(trace, n_layers=1, top_k=2) == [3, 5]
    # two layers per forward: a tie in either layer counts
    clean = {"probs": torch.tensor([[0.5, 0.3, 0.2, 0.0]] * 4)}
    two = [clean, {"probs": probs}, trace[2], trace[1]]
    assert smoke.routing_near_ties(two, n_layers=2, top_k=2) == [3, 4]
