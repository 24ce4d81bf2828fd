"""CNN session artifacts: the port's ``save`` / ``load`` against itself and
against the reference, on the CPU.

Round trips on a mini net and resnet-18 at a small image, on the kernel
path (B1's plain version here), the fp32 lowerings and int8: the loaded
session predicts bit for bit with zero schedule searches, on the same
plans, and re-specializes from its packed source; a sourceless one is
frozen.  Explicit and ``"auto"`` buckets, ``release`` and
``memory_bytes``.  Artifacts cross between the packages both ways
(``use_pallas`` is the port's ``use_kernel``), predictions held to the
reference's at rtol 1e-4, atol 1e-5 (fp32 sums in another order, as in
``tests/test_torch_e2e.py``) with equal argmax.  The integrity suite
mirrors the reference's ``tests/test_artifact_integrity.py`` and
``tests/test_pipeline_session.py``: checksums, typed corruption errors,
the v1-v4 migrations, the unverified warning, atomic saves.
"""
import json
import shutil
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import local_search as rls
from repro.core.graph import Graph as RGraph
from repro.engine import InferenceSession as RSession
from repro.engine import compile as r_compile
from repro_torch.checkpoint.store import dir_checksums
from repro_torch.core import local_search as tls
from repro_torch.core.graph import Graph
from repro_torch.engine import (ArtifactCorruptError, ArtifactError,
                                InferenceSession, Session,
                                UnverifiedArtifactWarning, compile)
from repro_torch.engine import session as session_mod
from repro_torch.engine.session import ARTIFACT_VERSION, _plan_to_json
from repro_torch.engine.traffic import solve_buckets

E2E_TOL = dict(rtol=1e-4, atol=1e-5)
PATHS = {"kernel": dict(use_kernel=True),
         "lowerings": dict(use_kernel=False),
         "int8": dict(use_kernel=False, dtype="int8")}
R18 = (1, 3, 32, 32)


def _mini_net(G=Graph):
    g = G()
    g.add("in", "input")
    g.add("c1", "conv2d", ["in"], in_channels=3, out_channels=8, kh=3,
          kw=3, stride=2, pad=1)
    g.add("r1", "relu", ["c1"])
    g.add("gap", "global_avg_pool", ["r1"])
    g.add("fl", "flatten", ["gap"])
    g.add("fc", "dense", ["fl"], units=10)
    g.mark_output("fc")
    return g, {"in": (1, 3, 16, 16)}


def _session(net, path="kernel", **kw):
    if net == "mini":
        g, shapes = _mini_net()
        return compile(g, shapes, device="cpu", **PATHS[path], **kw)
    return compile("resnet-18", R18, device="cpu", **PATHS[path], **kw)


def _x(sess, batch=1, seed=1):
    (shape,) = sess.input_spec.values()
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(batch,) + shape[1:]).astype(np.float32))


def _plans(sess, batch):
    js = _plan_to_json(sess.plan_for(batch))
    js.pop("report")
    return js


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One saved mini-net artifact and its prediction, copied fresh by the
    tests that change it."""
    sess = _session("mini")
    x = _x(sess)
    y = sess.predict(x).numpy()
    art = tmp_path_factory.mktemp("integrity") / "art"
    sess.save(art)
    return art, x, y


def _copy(saved, tmp_path):
    art, x, y = saved
    dst = tmp_path / "art"
    shutil.copytree(art, dst)
    return dst, x, y


# ---------------------------------------------------------------------------
# Round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("net", ["mini", "resnet-18"])
def test_round_trip_bit_identical_and_searchless(tmp_path, net, path):
    sess = _session(net, path)
    x = _x(sess)
    y = sess.predict(x).numpy()
    sess.save(tmp_path / "art")
    n = tls.search_calls()
    loaded = InferenceSession.load(tmp_path / "art", device="cpu")
    got = loaded.predict(x).numpy()
    assert tls.search_calls() == n, "load -> predict must not search"
    assert got.tobytes() == y.tobytes()
    assert not loaded.frozen and loaded.batch_sizes == [1]
    assert (loaded.dtype, loaded.use_kernel) == (sess.dtype, sess.use_kernel)
    assert _plans(loaded, 1) == _plans(sess, 1)
    manifest = json.loads((tmp_path / "art" / "manifest.json").read_text())
    assert manifest["version"] == ARTIFACT_VERSION == 5
    assert manifest["use_pallas"] == sess.use_kernel
    assert manifest["interpret"] is True and manifest["devices"] == 1
    assert manifest["lm"] is None and manifest["model"] == sess.model_name
    assert (manifest["quantized"] is not None) == (path == "int8")
    assert (tmp_path / "art" / "quantized.json").is_file() == (
        path == "int8")
    if path == "int8" and net == "resnet-18":
        q = json.loads((tmp_path / "art" / "quantized.json").read_text())
        assert "int8" in q["schedule_dtypes"]["1"].values()
    assert Session is InferenceSession


def test_loaded_session_respecializes_from_its_source(tmp_path):
    """An unseen batch size plans from the packed source on the H100
    machine model and reproduces the saving session's output for it bit
    for bit; with the workloads in the artifact's database (measured
    entries travel) it searches nothing."""
    sess = _session("resnet-18")
    x3 = _x(sess, batch=3)
    y3 = sess.predict(x3).numpy()
    sess.release(3)
    sess.save(tmp_path / "art")
    loaded = InferenceSession.load(tmp_path / "art", device="cpu")
    n = tls.search_calls()
    assert loaded.predict(x3).numpy().tobytes() == y3.tobytes()
    assert tls.search_calls() > n               # analytical db not saved
    assert loaded.batch_sizes == [1, 3]
    assert _plans(loaded, 3) == _plans(sess, 3)
    # mark the entries measured, so the artifact's database keeps them
    for key, res in list(sess.db._mem.items()):
        sess.db._mem[key] = tls.LocalSearchResult(
            res.workload, res.ranked, measured=True, search_budget=(9, 9))
    sess.save(tmp_path / "art2")
    again = InferenceSession.load(tmp_path / "art2", device="cpu")
    n = tls.search_calls()
    assert again.predict(x3).numpy().tobytes() == y3.tobytes()
    assert tls.search_calls() == n


def test_sourceless_artifact_is_frozen(tmp_path):
    sess = _session("mini")
    x = _x(sess)
    y = sess.predict(x).numpy()
    sess.save(tmp_path / "art", include_source=False)
    assert not (tmp_path / "art" / "source").exists()
    loaded = InferenceSession.load(tmp_path / "art", device="cpu")
    assert loaded.frozen
    assert loaded.predict(x).numpy().tobytes() == y.tobytes()
    with pytest.raises(RuntimeError, match="no batch-4 specialization"):
        loaded.predict(_x(sess, batch=4))
    with pytest.raises(RuntimeError, match="frozen"):
        loaded.release(1)
    with pytest.raises(RuntimeError, match="include_source=True"):
        loaded.save(tmp_path / "art2", include_source=True)
    with pytest.raises(RuntimeError, match="cannot specialize"):
        loaded.save(tmp_path / "art2", buckets=[1, 2])
    loaded.save(tmp_path / "art2")             # re-saving frozen is fine
    assert InferenceSession.load(tmp_path / "art2", device="cpu").frozen


def test_resave_without_source_drops_the_source_dir(tmp_path):
    sess = _session("mini")
    sess.save(tmp_path / "art")
    assert (tmp_path / "art" / "source").is_dir()
    sess.save(tmp_path / "art", include_source=False)
    assert not (tmp_path / "art" / "source").exists()
    assert InferenceSession.load(tmp_path / "art", device="cpu").frozen


def test_explicit_and_auto_buckets(tmp_path):
    sess = _session("mini", eager=False)
    sess.save(tmp_path / "explicit", buckets=[4, 2, 2])
    m = json.loads((tmp_path / "explicit" / "manifest.json").read_text())
    assert sorted(m["specializations"]) == ["2", "4"]
    assert m["traffic"] == {"mode": "explicit", "buckets": [2, 4]}
    hist = {1: 40, 2: 3, 3: 25, 7: 2}
    for s, c in hist.items():
        sess.traffic.add(s, c)
    sess.save(tmp_path / "auto", buckets="auto")
    m = json.loads((tmp_path / "auto" / "manifest.json").read_text())
    want = sorted(solve_buckets(hist))
    assert sorted(int(b) for b in m["specializations"]) == want
    assert m["traffic"]["mode"] == "auto"
    assert m["traffic"]["histogram"] == {str(s): c for s, c in hist.items()}
    assert m["traffic"]["buckets"] == list(solve_buckets(hist))
    loaded = InferenceSession.load(tmp_path / "auto", device="cpu")
    assert loaded.batch_sizes == want
    sess.save(tmp_path / "given", buckets="auto", traffic={5: 3})
    m = json.loads((tmp_path / "given" / "manifest.json").read_text())
    assert list(m["specializations"]) == ["5"]
    with pytest.raises(ValueError, match="only meaningful"):
        sess.save(tmp_path / "x", traffic={1: 1})
    with pytest.raises(ValueError, match="sizes >= 1"):
        sess.save(tmp_path / "x", buckets=[0])
    with pytest.raises(ValueError, match="recorded traffic"):
        _session("mini").save(tmp_path / "x", buckets="auto")
    with pytest.raises(RuntimeError, match="nothing to save"):
        _session("mini", eager=False).save(tmp_path / "x")


def test_release_and_memory_bytes():
    sess = _session("resnet-18")
    sess.specialize(2)
    mem = sess.memory_bytes()
    want = sum(t.numel() * t.element_size() for node in
               sess.specialize(1).params.values() for t in node.values())
    assert sorted(mem) == [1, 2] and mem[1] == want and mem[2] > 0
    assert sess.release(2) is True and sess.release(2) is False
    assert sorted(sess.memory_bytes()) == [1]
    n = tls.search_calls()
    sess.specialize(2)                       # rebuilt from the database
    assert tls.search_calls() == n


def test_loaded_weights_land_on_the_requested_device(saved):
    art, _, _ = saved
    loaded = InferenceSession.load(art, device="cpu")
    assert all(t.device.type == "cpu" for node in
               loaded.specialize(1).params.values() for t in node.values())
    assert all(t.device.type == "cpu" for node in loaded._params.values()
               for t in node.values())


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **E2E_TOL)
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


CROSS = {"fp32": ("mini", dict(use_pallas=False)),
         "int8": ("resnet-18", dict(use_pallas=False, dtype="int8")),
         "pallas": ("mini", dict(use_pallas=True, interpret=True))}


def _ref_session(case):
    net, kw = CROSS[case]
    if net == "mini":
        g, shapes = _mini_net(RGraph)
        return r_compile(g, shapes, **kw), shapes["in"]
    return r_compile(net, R18, **kw), R18


@pytest.mark.parametrize("case", list(CROSS))
def test_reference_artifact_loads_in_the_port(tmp_path, case):
    ref, shape = _ref_session(case)
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = np.asarray(ref.predict(jnp.asarray(x)))
    ref.save(tmp_path / "art")
    n = tls.search_calls()
    with warnings.catch_warnings():
        warnings.simplefilter("error", UnverifiedArtifactWarning)
        port = InferenceSession.load(tmp_path / "art", device="cpu")
    got = port.predict(torch.from_numpy(x)).numpy()
    assert tls.search_calls() == n
    assert port.use_kernel == ref.use_pallas and port.dtype == ref.dtype
    assert port.frozen is False and port.model_name == ref.model_name
    _close(got, want)


@pytest.mark.parametrize("case", list(CROSS))
def test_port_artifact_loads_in_the_reference(tmp_path, case):
    net, kw = CROSS[case]
    sess = _session(net, "kernel" if kw["use_pallas"] else
                    ("int8" if kw.get("dtype") == "int8" else "lowerings"))
    x = _x(sess, seed=3)
    want = sess.predict(x).numpy()
    sess.save(tmp_path / "art")
    n = rls.search_calls()
    with warnings.catch_warnings():
        warnings.simplefilter("error", UnverifiedArtifactWarning)
        ref = RSession.load(tmp_path / "art")
    got = np.asarray(ref.predict(jnp.asarray(x.numpy())))
    assert rls.search_calls() == n
    assert ref.use_pallas == sess.use_kernel and ref.dtype == sess.dtype
    assert ref.devices == 1 and ref.tuning == sess.tuning
    _close(got, want)


def test_transform_bw_and_tuning_round_trip(tmp_path):
    g, shapes = _mini_net()
    sess = compile(g, shapes, device="cpu", tuning="cached")
    sess.transform_bw = 1.5e11
    sess.save(tmp_path / "art")
    loaded = InferenceSession.load(tmp_path / "art", device="cpu")
    assert (loaded.tuning, loaded.transform_bw) == ("cached", 1.5e11)
    assert loaded.search_budget == (6, 2, 3)
    ref = RSession.load(tmp_path / "art")
    assert (ref.tuning, ref.transform_bw) == ("cached", 1.5e11)


# ---------------------------------------------------------------------------
# Integrity
# ---------------------------------------------------------------------------

def test_manifest_checksums_cover_all_files(saved):
    art, _, _ = saved
    manifest = json.loads((art / "manifest.json").read_text())
    sums = manifest["checksums"]
    on_disk = {p.relative_to(art).as_posix()
               for p in art.rglob("*") if p.is_file()}
    assert set(sums) == on_disk - {"manifest.json"}
    assert any(rel.startswith("plans/") for rel in sums)
    assert any(rel.startswith("weights/") for rel in sums)
    assert any(rel.startswith("source/") for rel in sums)
    for ref in manifest["specializations"].values():
        assert set(ref) == {"file"} and (art / ref["file"]).is_file()
    assert sums == dir_checksums(art, exclude=("manifest.json",))


def _flip(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("kind", ["weights", "source", "plans"])
def test_corrupt_file_rejected(saved, tmp_path, kind):
    art, _, _ = _copy(saved, tmp_path)
    _flip(sorted((art / kind).rglob("*.*"))[0])
    with pytest.raises(ArtifactCorruptError, match="sha256"):
        InferenceSession.load(art, device="cpu")


def test_corrupt_manifest_rejected(saved, tmp_path):
    art, _, _ = _copy(saved, tmp_path)
    (art / "manifest.json").write_text('{"format": "neocpu-inference')
    with pytest.raises(ArtifactCorruptError, match="corrupt"):
        InferenceSession.load(art, device="cpu")


def test_missing_listed_file_rejected(saved, tmp_path):
    art, _, _ = _copy(saved, tmp_path)
    sorted((art / "plans").glob("*.json"))[0].unlink()
    with pytest.raises(ArtifactCorruptError, match="missing"):
        InferenceSession.load(art, device="cpu")


def test_missing_or_foreign_artifact_raises_artifact_error(tmp_path):
    with pytest.raises(ArtifactError, match="manifest"):
        InferenceSession.load(tmp_path / "nope", device="cpu")
    (tmp_path / "junk").mkdir()
    (tmp_path / "junk" / "manifest.json").write_text('{"format": "x"}')
    with pytest.raises(ArtifactError, match="is not a"):
        InferenceSession.load(tmp_path / "junk", device="cpu")
    assert issubclass(ArtifactError, ValueError)
    assert issubclass(ArtifactCorruptError, ArtifactError)


def test_truncated_blob_without_checksums_rejected(saved, tmp_path):
    art, _, _ = _copy(saved, tmp_path)
    manifest = json.loads((art / "manifest.json").read_text())
    manifest["checksums"] = None
    (art / "manifest.json").write_text(json.dumps(manifest))
    blob = sorted((art / "weights").rglob("*.npy"))[0]
    blob.write_bytes(blob.read_bytes()[:16])
    with pytest.warns(UnverifiedArtifactWarning):
        with pytest.raises(ArtifactCorruptError, match="corrupt"):
            InferenceSession.load(art, device="cpu")


def test_future_version_refused(saved, tmp_path):
    art, _, _ = _copy(saved, tmp_path)
    manifest = json.loads((art / "manifest.json").read_text())
    manifest["version"] = ARTIFACT_VERSION + 1
    (art / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ArtifactError, match="newer"):
        InferenceSession.load(art, device="cpu")


def test_multi_device_artifacts_wait_for_a10(saved, tmp_path):
    """Since A10b a devices=1 artifact with its source re-targets to two
    devices (re-planned at the per-device sub-batch, the predict as the
    saved session's), and a manifest's "devices" is the loaded session's
    count."""
    art, x, y = _copy(saved, tmp_path)
    two = InferenceSession.load(art, device="cpu", devices=2)
    assert two.devices == 2 and two.batch_sizes == []
    x2 = torch.cat([x, x])
    np.testing.assert_allclose(two.predict(x2).numpy(),
                               np.concatenate([y, y]), rtol=1e-5, atol=1e-5)
    manifest = json.loads((art / "manifest.json").read_text())
    manifest["devices"] = 2
    (art / "manifest.json").write_text(json.dumps(manifest))
    assert InferenceSession.load(art, device="cpu").devices == 2


def _downgrade(art, version):
    """Rewrite the artifact into an older version's on-disk shape: v2 and
    v1 inline their plans and have no checksums (v1 keeps them under
    "batches" and packs no source), v3 has no quantized section, v4 no
    lm section."""
    mf = art / "manifest.json"
    blob = json.loads(mf.read_text())
    blob.pop("lm")
    if version <= 3:
        blob.pop("quantized")
    if version <= 2:
        blob["specializations"] = {
            b: json.loads((art / ref["file"]).read_text())
            for b, ref in blob["specializations"].items()}
        blob.pop("checksums")
        shutil.rmtree(art / "plans")
    if version == 1:
        blob["batches"] = blob.pop("specializations")
        blob.pop("source")
        shutil.rmtree(art / "source")
    blob["version"] = version
    mf.write_text(json.dumps(blob))


@pytest.mark.parametrize("version", [3, 4])
def test_verified_old_versions_migrate(saved, tmp_path, version):
    art, x, y = _copy(saved, tmp_path)
    _downgrade(art, version)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UnverifiedArtifactWarning)
        loaded = InferenceSession.load(art, device="cpu")
    assert loaded.predict(x).numpy().tobytes() == y.tobytes()
    assert not loaded.frozen


@pytest.mark.parametrize("version", [1, 2])
def test_unverified_old_versions_migrate_and_warn_once(saved, tmp_path,
                                                       version):
    art, x, y = _copy(saved, tmp_path)
    _downgrade(art, version)
    with pytest.warns(UnverifiedArtifactWarning, match="UNVERIFIED") as rec:
        loaded = InferenceSession.load(art, device="cpu")
    assert len([w for w in rec if issubclass(
        w.category, UnverifiedArtifactWarning)]) == 1
    assert loaded.frozen == (version == 1)      # v1 never packed a source
    assert loaded.predict(x).numpy().tobytes() == y.tobytes()


def test_resave_backfills_checksums(saved, tmp_path):
    art, x, y = _copy(saved, tmp_path)
    _downgrade(art, 2)
    with pytest.warns(UnverifiedArtifactWarning):
        loaded = InferenceSession.load(art, device="cpu")
    loaded.save(tmp_path / "upgraded")
    manifest = json.loads((tmp_path / "upgraded" / "manifest.json")
                          .read_text())
    assert manifest["version"] == ARTIFACT_VERSION
    assert manifest["checksums"] == dir_checksums(
        tmp_path / "upgraded", exclude=("manifest.json",))
    with warnings.catch_warnings():
        warnings.simplefilter("error", UnverifiedArtifactWarning)
        again = InferenceSession.load(tmp_path / "upgraded", device="cpu")
    assert again.predict(x).numpy().tobytes() == y.tobytes()


def test_crashed_resave_leaves_previous_artifact_loadable(tmp_path,
                                                          monkeypatch):
    sess = _session("mini")
    x = _x(sess)
    y = sess.predict(x).numpy()
    art = tmp_path / "art"
    sess.save(art)

    def boom(*a, **kw):
        raise OSError("disk full mid-save")

    monkeypatch.setattr(session_mod, "dir_checksums", boom)
    with pytest.raises(OSError, match="disk full"):
        sess.save(art)                       # crashes before the swap
    monkeypatch.undo()
    got = InferenceSession.load(art, device="cpu").predict(x).numpy()
    assert got.tobytes() == y.tobytes()
    sess.save(art)                           # over the leftover temp dir
    assert InferenceSession.load(art, device="cpu").predict(
        x).numpy().tobytes() == y.tobytes()
