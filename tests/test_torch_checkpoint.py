"""The port's checkpoint store and schedule database against the
reference's.

The store (``repro_torch/checkpoint/store.py``) round-trips fp32, int8 and
bf16 leaves, blocking and async, prunes and deletes steps, and writes the
reference's on-disk format byte for byte: the same ``.npy`` files (a bf16
leaf as numpy writes an ``ml_dtypes`` bfloat16 array, descr ``'<V2'``) and
the same step manifest, so ``dir_checksums`` agree.  A corrupt leaf raises
a ``ValueError`` naming it.  The database (``core/local_search.py``) keeps
its entries in a file, merges best-measured-wins, exports the reference's
blob, and counts real searches in ``search_calls``.
"""
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as RStore
from repro.core import local_search as rls
from repro_torch.checkpoint.store import (CheckpointStore, dir_checksums,
                                          unflatten_dicts)
from repro_torch.core import local_search as tls
from repro_torch.core.schedule import ConvSchedule, ConvWorkload
from repro_torch.engine import compile as t_compile

DTYPES = ["float32", "int8", "bfloat16"]


def _array(dtype, shape, seed=0):
    """A numpy leaf for the reference (bf16 through ml_dtypes) and the
    same values as a torch tensor for the port."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        a = rng.integers(-127, 128, size=shape).astype(np.int8)
        return a, torch.from_numpy(a.copy())
    a = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return b, torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16)
    return a, torch.from_numpy(a.copy())


def _trees(dtype):
    (a, ta), (b, tb), (c, tc) = (_array(dtype, s, i) for i, s in
                                 enumerate([(3, 5), (2, 4, 6), (7,)]))
    return ({"w": a, "layers": {"x": b, "y": c}},
            {"w": ta, "layers": {"x": tb, "y": tc}})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocking", [True, False], ids=["blocking", "async"])
def test_store_round_trip(tmp_path, dtype, blocking):
    _, tree = _trees(dtype)
    store = CheckpointStore(tmp_path)
    for step in (1, 2, 3, 4):
        store.save(step, tree, meta={"step": step}, blocking=blocking)
    store.wait()
    assert store.steps() == [1, 2, 3, 4] and store.latest_step() == 4
    back, step, meta = store.restore(tree)
    assert step == 4 and meta == {"step": 4}
    for (k, v), (k2, w) in zip(_leaves(tree), _leaves(back)):
        assert k == k2 and w.dtype == v.dtype and torch.equal(w, v)
    store.delete(2)
    store.delete(7)                         # absent: a no-op
    assert store.steps() == [1, 3, 4]
    store.prune(keep_last=2)
    assert store.steps() == [3, 4]
    flat, step, _ = store.restore_flat(3)
    assert step == 3 and set(flat) == {"w", "layers.x", "layers.y"}


def test_async_save_holds_a_copy(tmp_path):
    """An async save writes the leaves as they were at the call, even if
    the caller overwrites them before the writer runs."""
    t = torch.arange(6, dtype=torch.float32)
    store = CheckpointStore(tmp_path)
    store.save(0, {"t": t}, blocking=False)
    t.zero_()
    store.wait()
    got, _, _ = store.restore_flat(0)
    assert torch.equal(got["t"], torch.arange(6, dtype=torch.float32))


def test_restore_onto_a_device_and_refuses_shardings(tmp_path):
    _, tree = _trees("float32")
    store = CheckpointStore(tmp_path)
    store.save(0, tree)
    back, _, _ = store.restore(tree, device="cpu")
    assert back["w"].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="A10"):
        store.restore(tree, shardings={"w": None})
    with pytest.raises(FileNotFoundError):
        CheckpointStore(tmp_path / "empty").restore_flat()


@pytest.mark.parametrize("dtype", DTYPES)
def test_npy_files_byte_equal_to_the_reference(tmp_path, dtype):
    """The same arrays saved by both packages' stores give byte-equal
    ``.npy`` files and step manifests, so ``dir_checksums`` agree."""
    ref_tree, tree = _trees(dtype)
    RStore(tmp_path / "ref").save(0, ref_tree)
    CheckpointStore(tmp_path / "port").save(0, tree)
    ref = dir_checksums(tmp_path / "ref")
    assert len(ref) == 4
    assert dir_checksums(tmp_path / "port") == ref
    leaf = tmp_path / "port" / "step_000000" / "leaf_00000.npy"
    head = leaf.read_bytes()[:64]
    assert (b"'<V2'" in head) == (dtype == "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
def test_each_package_restores_the_others_store(tmp_path, dtype):
    ref_tree, tree = _trees(dtype)
    RStore(tmp_path / "ref").save(0, ref_tree)
    CheckpointStore(tmp_path / "port").save(0, tree)
    got, _, _ = CheckpointStore(tmp_path / "ref").restore_flat(0)
    for path, want in _leaves(tree):
        assert got[path].dtype == want.dtype and torch.equal(got[path], want)
    ref_got, _, _ = RStore(tmp_path / "port").restore_flat(0)
    for path, want in _leaves(ref_tree):
        # numpy reads a bf16 leaf back as its raw 2-byte values
        assert ref_got[path].tobytes() == np.asarray(want).tobytes()


def test_corrupt_leaf_names_the_leaf(tmp_path):
    _, tree = _trees("float32")
    store = CheckpointStore(tmp_path)
    store.save(0, tree)
    blob = tmp_path / "step_000000" / "leaf_00001.npy"
    blob.write_bytes(blob.read_bytes()[:20])
    with pytest.raises(ValueError, match=r"leaf_00001.npy.*'layers.y'"):
        store.restore_flat(0)
    (tmp_path / "step_000000" / "manifest.json").write_text("{")
    with pytest.raises(ValueError, match="not valid JSON"):
        store.restore_flat(0)


def test_unflatten_dicts_inverts_the_dotted_paths():
    _, tree = _trees("int8")
    flat = dict(_leaves(tree))
    assert unflatten_dicts(flat).keys() == tree.keys()
    assert unflatten_dicts(flat)["layers"]["y"] is tree["layers"]["y"]
    # lists of dicts (the hybrid and encdec layer lists) come back as lists
    nested = {"a[1].w": 2, "a[0].w": 1, "a[0].b": 0, "m[0]": 3, "x": 4}
    assert unflatten_dicts(nested) == {"a": [{"w": 1, "b": 0}, {"w": 2}],
                                       "m": [3], "x": 4}
    with pytest.raises(ValueError, match="0..n-1"):
        unflatten_dicts({"a[1]": 1})
    with pytest.raises(ValueError, match="not a tree path"):
        unflatten_dicts({"a]0[": 1})


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


# ---------------------------------------------------------------------------
# The schedule database
# ---------------------------------------------------------------------------

WL = dict(batch=1, in_channels=16, out_channels=32, height=14, width=14,
          kh=3, kw=3, stride=1, pad=1)


def _entry(mod, cost, measured, ic_bn=8, **wl):
    """One hand-built entry of package ``mod`` (the reference's or the
    port's ``local_search``), best cost ``cost``."""
    wl = ConvWorkload(**{**WL, **wl}) if mod is tls else \
        _ref_workload(**{**WL, **wl})
    sched = ConvSchedule if mod is tls else _ref_schedule()
    ranked = [mod.RankedSchedule(sched(ic_bn, 16, 7, 1, False), cost),
              mod.RankedSchedule(sched(16, 16, 7, 1, True), cost * 2)]
    return wl, mod.LocalSearchResult(wl, ranked, measured=measured,
                                     search_budget=(6, 2) if measured
                                     else (0, 0))


def _ref_workload(**kw):
    from repro.core.schedule import ConvWorkload as R
    return R(**kw)


def _ref_schedule():
    from repro.core.schedule import ConvSchedule as R
    return R


def test_database_persists_in_a_file(tmp_path):
    path = tmp_path / "db.json"
    db = tls.ScheduleDatabase(path)
    wl, res = _entry(tls, 1e-5, True)
    db.put(wl, res)
    assert path.is_file()
    again = tls.ScheduleDatabase(path)
    assert len(again) == 1 and again.to_blob() == db.to_blob()
    n = tls.search_calls()
    db.search(ConvWorkload(**{**WL, "height": 7, "width": 7}))
    assert tls.search_calls() == n + 1
    assert len(tls.ScheduleDatabase(path)) == 2


def test_database_file_crosses_packages(tmp_path):
    rdb = rls.ScheduleDatabase(tmp_path / "ref.json")
    rdb.put(*_entry(rls, 2e-5, True))
    tdb = tls.ScheduleDatabase(tmp_path / "ref.json")
    assert tdb.to_blob() == json.loads((tmp_path / "ref.json").read_text())
    tdb.path = tmp_path / "port.json"
    tdb.put(*_entry(tls, 3e-5, True, height=28, width=28))
    back = rls.ScheduleDatabase(tmp_path / "port.json")
    assert len(back) == 2 and back.to_blob() == tdb.to_blob()


def test_merge_best_measured_wins():
    base = tls.ScheduleDatabase()
    wl, slow = _entry(tls, 2e-5, True)
    base.put(wl, slow)
    # an analytical entry never displaces one
    other = tls.ScheduleDatabase()
    other.put(*_entry(tls, 1e-9, False))
    assert base.merge(other) == 0 and base._mem == {
        tls._wl_key(wl): slow}
    # a tie keeps the incumbent
    tie = tls.ScheduleDatabase()
    _, tied = _entry(tls, 2e-5, True, ic_bn=16)
    tie.put(wl, tied)
    assert base.merge(tie) == 0
    assert base._mem[tls._wl_key(wl)] is slow
    # a faster measured entry replaces it; a new key is added
    fast = tls.ScheduleDatabase()
    _, quick = _entry(tls, 1e-5, True)
    fast.put(wl, quick)
    fast.put(*_entry(tls, 5e-5, False, height=7, width=7))
    assert base.merge(fast) == 2
    assert base._mem[tls._wl_key(wl)] is quick and len(base) == 2
    # merging twice is idempotent
    before = base.to_blob()
    assert base.merge(fast) == 0 and base.to_blob() == before
    # a measured entry replaces an analytical incumbent
    ana = tls.ScheduleDatabase()
    ana.put(*_entry(tls, 1e-9, False))
    assert ana.merge(fast) == 2 and ana._mem[tls._wl_key(wl)] is quick


def test_merge_persists_when_path_backed(tmp_path):
    db = tls.ScheduleDatabase(tmp_path / "db.json")
    other = tls.ScheduleDatabase()
    other.put(*_entry(tls, 1e-5, True))
    assert db.merge(other) == 1
    assert len(tls.ScheduleDatabase(tmp_path / "db.json")) == 1


def test_to_blob_measured_only_equals_the_references():
    tdb, rdb = tls.ScheduleDatabase(), rls.ScheduleDatabase()
    for (mod, db) in ((tls, tdb), (rls, rdb)):
        db.put(*_entry(mod, 1e-5, True))
        db.put(*_entry(mod, 4e-5, False, height=28, width=28))
        db.put(*_entry(mod, 3e-5, True, kh=1, kw=1, pad=0))
    for measured_only in (False, True):
        got = json.loads(json.dumps(tdb.to_blob(measured_only)))
        want = json.loads(json.dumps(rdb.to_blob(measured_only)))
        assert got == want
    assert len(tdb.to_blob(measured_only=True)) == 2


def test_search_calls_count_searches_not_memo_hits():
    db = tls.ScheduleDatabase()
    wl = ConvWorkload(**{**WL, "out_channels": 48})
    n = tls.search_calls()
    first = db.search(wl)
    assert tls.search_calls() == n + 1
    assert db.search(wl) is first and tls.search_calls() == n + 1
    tls.local_search(wl)
    assert tls.search_calls() == n + 2
    assert tls.SEARCH_COUNTERS["local_search"] >= 2


def test_compile_reads_a_database_file_as_a_snapshot(tmp_path):
    """``compile(db=<path>)`` plans from the file's entries and never
    writes it: the session persists its database in its artifact."""
    path = tmp_path / "db.json"
    seed = tls.ScheduleDatabase(path)
    seed.put(*_entry(tls, 1e-5, False))
    before = path.read_bytes()
    sess = t_compile("resnet-18", (1, 3, 32, 32), device="cpu", db=path)
    assert sess.db.path is None and len(sess.db) > 1
    assert path.read_bytes() == before
    assert tls._wl_key(ConvWorkload(**WL)) in sess.db._mem
