"""LM session artifacts: the port's ``LMSession.save`` / ``load`` against
itself and against the reference, on the CPU.

Reduced qwen2-1.5b, mamba2-130m and arctic-480b, in fp32 and bf16, give
the same tokens after a reload with every leaf bit for bit (a bf16 leaf
through its raw 2-byte values, never float32).  An fp32 LM artifact
crosses both ways (and a hybrid one, whose layers are a list): the
loading package's tokens equal those of its own session on the saving
package's weights (carried over by
``lm_params_from_numpy`` or ``jnp.asarray``), and its leaves are the
saver's bit for bit.  The port loads a bf16 artifact that the reference
saved but cannot load itself (ROADMAP C5).  CNN and LM artifacts refuse
the other family's loader.
"""
import dataclasses
import inspect
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.engine import LMSession as RLMSession
from repro.engine import compile_lm as r_compile_lm
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import (ArtifactCorruptError, ArtifactError,
                                InferenceSession, LMSession, compile,
                                compile_lm, lm_params_from_numpy)
from repro_torch.engine.session import ARTIFACT_VERSION

NAMES = ("qwen2-1.5b", "mamba2-130m", "arctic-480b")


def _leaves(tree, prefix=""):
    """(path, leaf) of a tree of dicts and lists, in the store's path
    spelling (``layers_list[0].attn.wq``)."""
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
        return
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, (dict, list)):
            yield from _leaves(v, path)
        else:
            yield path, v


def _bits(leaf) -> bytes:
    """A leaf's raw bytes: a torch tensor's (bf16 as its 2-byte values),
    or a JAX/numpy array's (ml_dtypes bf16 likewise)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(leaf).tobytes()


def _toks(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_lm_round_trip(tmp_path, name, dtype):
    cfg = dataclasses.replace(reduced(ARCHS[name]), dtype=dtype)
    sess = compile_lm(cfg, max_len=32, device="cpu")
    sess.traffic.add(13, 4)
    toks = _toks(cfg, (1, 13))
    want = sess.generate(toks, 4)
    sess.save(tmp_path / "lm")
    loaded = LMSession.load(tmp_path / "lm", device="cpu")
    np.testing.assert_array_equal(loaded.generate(toks, 4), want)
    assert loaded.cfg == cfg and loaded.seq_buckets == sess.seq_buckets
    assert (loaded.max_len, loaded.batch) == (32, 1)
    assert loaded.model_name == sess.model_name
    assert loaded.traffic.counts() == {13: 4}
    got = dict(_leaves(loaded._params))
    want_leaves = dict(_leaves(sess._params))
    assert got.keys() == want_leaves.keys()
    for path, t in want_leaves.items():
        assert got[path].dtype == t.dtype
        assert _bits(got[path]) == _bits(t), path
    assert got["embed"].dtype == getattr(torch, dtype)
    manifest = json.loads((tmp_path / "lm" / "manifest.json").read_text())
    assert manifest["version"] == ARTIFACT_VERSION
    assert set(manifest["lm"]) == {"config", "max_len", "batch",
                                   "seq_buckets", "traffic"}
    assert manifest["lm"]["traffic"] == {"histogram": {"13": 4}}
    step = json.loads((tmp_path / "lm" / "weights" / "step_000000" /
                       "manifest.json").read_text())
    assert step["leaves"]["embed"]["dtype"] == dtype
    assert {r["dtype"] for r in step["leaves"].values()} == {
        str(t.dtype).removeprefix("torch.") for t in want_leaves.values()}


def test_prewarmed_session_saves_and_loads(tmp_path):
    """The artifact half of what waited for A6: a prewarmed mamba2
    session saves and loads with its buckets."""
    sess = compile_lm(reduced(ARCHS["mamba2-130m"]), max_len=16,
                      device="cpu", prewarm=True)
    sess.save(tmp_path / "lm")
    loaded = LMSession.load(tmp_path / "lm", device="cpu")
    assert loaded.seq_buckets == sess.seq_buckets == [4, 8, 16]
    loaded.prewarm()


def test_lm_load_defaults_to_the_card():
    for cls in (LMSession, InferenceSession):
        assert inspect.signature(cls.load).parameters["device"].default \
            == "cuda"


@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-130m"])
def test_reference_fp32_artifact_loads_in_the_port(tmp_path, name):
    ref = r_compile_lm(r_reduced(R_ARCHS[name]), max_len=16,
                       seq_buckets=[8], seed=0)
    ref.save(tmp_path / "lm")
    port = LMSession.load(tmp_path / "lm", device="cpu")
    for path, leaf in _leaves(ref._params):
        assert _bits(dict(_leaves(port._params))[path]) == _bits(leaf)
    same = compile_lm(reduced(ARCHS[name]), max_len=16, seq_buckets=[8],
                      params=lm_params_from_numpy(ref._params, "cpu"),
                      device="cpu")
    toks = _toks(port.cfg, (1, 11))
    np.testing.assert_array_equal(port.generate(toks, 4),
                                  same.generate(toks, 4))
    assert port.seq_buckets == [8] and port.model_name == ref.model_name


@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-130m"])
def test_port_fp32_artifact_loads_in_the_reference(tmp_path, name):
    port = compile_lm(reduced(ARCHS[name]), max_len=16, seq_buckets=[8],
                      device="cpu")
    port.save(tmp_path / "lm")
    ref = RLMSession.load(tmp_path / "lm")
    for path, leaf in _leaves(port._params):
        assert _bits(dict(_leaves(ref._params))[path]) == _bits(leaf)
    same = r_compile_lm(r_reduced(R_ARCHS[name]), max_len=16,
                        seq_buckets=[8], params=_nested_np(port._params))
    toks = jnp.asarray(_toks(port.cfg, (1, 11)))
    np.testing.assert_array_equal(ref.generate(toks, 4),
                                  same.generate(toks, 4))


def _nested_np(tree):
    if isinstance(tree, list):
        return [_nested_np(v) for v in tree]
    return {k: _nested_np(v) if isinstance(v, (dict, list)) else
            jnp.asarray(v.numpy()) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "whisper-tiny"])
def test_list_shaped_trees_round_trip(tmp_path, name):
    """The hybrid and encdec trees hold lists of layers: the store writes
    their ``[i]`` paths and the load rebuilds the lists, every leaf bit for
    bit; the hybrid session generates as before."""
    cfg = reduced(ARCHS[name])
    sess = compile_lm(cfg, max_len=24, device="cpu")
    sess.save(tmp_path / "lm")
    loaded = LMSession.load(tmp_path / "lm", device="cpu")
    assert loaded.cfg == cfg
    key = "layers_list" if cfg.family == "hybrid" else "dec_layers"
    assert isinstance(loaded._params[key], list)
    want = dict(_leaves(sess._params))
    got = dict(_leaves(loaded._params))
    assert got.keys() == want.keys() and any("[1]" in p for p in got)
    for path, t in want.items():
        assert _bits(got[path]) == _bits(t), path
    if cfg.family == "hybrid":
        toks = _toks(cfg, (1, 14))
        np.testing.assert_array_equal(loaded.generate(toks, 4),
                                      sess.generate(toks, 4))


def test_hybrid_artifact_crosses_both_ways(tmp_path):
    """An fp32 hybrid artifact (lists of layers) saved by either package
    loads in the other: every leaf bit for bit, and the loader's tokens
    equal those of its own session on the saver's weights."""
    name = "recurrentgemma-2b"
    ref = r_compile_lm(r_reduced(R_ARCHS[name]), max_len=24, seed=0)
    ref.save(tmp_path / "ref")
    port = LMSession.load(tmp_path / "ref", device="cpu")
    got = dict(_leaves(port._params))
    for path, leaf in _leaves(ref._params):
        assert _bits(got[path]) == _bits(leaf), path
    same = compile_lm(reduced(ARCHS[name]), max_len=24, device="cpu",
                      params=lm_params_from_numpy(ref._params, "cpu"))
    toks = _toks(port.cfg, (1, 14))
    np.testing.assert_array_equal(port.generate(toks, 4),
                                  same.generate(toks, 4))

    mine = compile_lm(reduced(ARCHS[name]), max_len=24, seed=3, device="cpu")
    mine.save(tmp_path / "port")
    back = RLMSession.load(tmp_path / "port")
    theirs = dict(_leaves(back._params))
    for path, leaf in _leaves(mine._params):
        assert _bits(theirs[path]) == _bits(leaf), path
    same = r_compile_lm(r_reduced(R_ARCHS[name]), max_len=24,
                        params=_nested_np(mine._params))
    np.testing.assert_array_equal(back.generate(jnp.asarray(toks), 4),
                                  same.generate(jnp.asarray(toks), 4))


def _ref_bf16(tmp_path):
    cfg = dataclasses.replace(r_reduced(R_ARCHS["qwen2-1.5b"]),
                              dtype="bfloat16")
    ref = r_compile_lm(cfg, max_len=16, seq_buckets=[8], seed=0)
    ref.save(tmp_path / "lm")
    return ref


def test_port_loads_a_reference_bf16_artifact(tmp_path):
    """The reference writes a bf16 leaf as numpy's ``'<V2'`` bytes; the
    port reads every leaf back bit for bit, and generates as a port
    session on the same weights does."""
    ref = _ref_bf16(tmp_path)
    port = LMSession.load(tmp_path / "lm", device="cpu")
    got = dict(_leaves(port._params))
    n = 0
    for path, leaf in _leaves(ref._params):
        assert got[path].dtype == torch.bfloat16
        assert np.asarray(leaf).dtype == ml_dtypes.bfloat16
        assert _bits(got[path]) == _bits(leaf), path
        n += 1
    assert n == len(got) > 5
    same = compile_lm(port.cfg, max_len=16, seq_buckets=[8], device="cpu",
                      params=lm_params_from_numpy(ref._params, "cpu"))
    toks = _toks(port.cfg, (1, 11))
    np.testing.assert_array_equal(port.generate(toks, 3),
                                  same.generate(toks, 3))


def test_reference_cannot_load_its_own_bf16_artifact(tmp_path):
    """ROADMAP C5, pinned: the reference's numpy reads its bf16 leaves
    back as ``|V2`` bytes, which its jitted prefill refuses."""
    _ref_bf16(tmp_path)
    loaded = RLMSession.load(tmp_path / "lm")
    assert np.asarray(loaded._params["embed"]).dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        loaded.generate(jnp.zeros((1, 8), jnp.int32), 1)


def test_families_refuse_each_others_artifacts(tmp_path):
    lm = compile_lm(reduced(ARCHS["mamba2-130m"]), max_len=16, device="cpu")
    lm.save(tmp_path / "lm")
    cnn = compile("resnet-18", (1, 3, 32, 32), device="cpu")
    cnn.save(tmp_path / "cnn")
    with pytest.raises(ArtifactError, match="LMSession.load"):
        InferenceSession.load(tmp_path / "lm", device="cpu")
    with pytest.raises(ArtifactError, match="CNN artifact"):
        LMSession.load(tmp_path / "cnn", device="cpu")


def test_lm_artifact_integrity(tmp_path):
    lm = compile_lm(reduced(ARCHS["qwen2-1.5b"]), max_len=16, device="cpu")
    lm.save(tmp_path / "lm")
    blob = sorted((tmp_path / "lm" / "weights").rglob("leaf_*.npy"))[0]
    data = bytearray(blob.read_bytes())
    data[len(data) // 2] ^= 0xFF
    blob.write_bytes(bytes(data))
    with pytest.raises(ArtifactCorruptError, match="sha256"):
        LMSession.load(tmp_path / "lm", device="cpu")
    lm.save(tmp_path / "lm")                 # a re-save repairs it
    mf = tmp_path / "lm" / "manifest.json"
    blob = json.loads(mf.read_text())
    blob["version"] = ARTIFACT_VERSION + 1
    mf.write_text(json.dumps(blob))
    with pytest.raises(ArtifactError, match="newer"):
        LMSession.load(tmp_path / "lm", device="cpu")
