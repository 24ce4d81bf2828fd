"""``repro_torch.launch.cpu`` against the reference's ``repro.launch.cpu``:
the serving env preset on a dict env (equal but for the TF/XLA log level,
which the port leaves out), its tcmalloc branches (absent, found but not
preloaded, active), and the port's device check that stands in for the
reference's XLA-flag helpers."""
import warnings

import pytest

from repro.launch import cpu as rcpu
from repro_torch.launch import cpu as tcpu

LIB = "/opt/lib/libtcmalloc.so.4"


def _patch(monkeypatch, module, found, active):
    monkeypatch.setattr(module, "find_tcmalloc", lambda: found)
    monkeypatch.setattr(module, "tcmalloc_active", lambda: active)


@pytest.mark.parametrize("found,active", [(None, False), (LIB, False),
                                          (LIB, True)],
                         ids=["absent", "found", "active"])
@pytest.mark.parametrize("env", [{}, {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD":
                                      "1", "LD_PRELOAD": "/x/libfoo.so"}],
                         ids=["empty", "user-set"])
def test_apply_serving_env_matches_the_reference(monkeypatch, found, active,
                                                 env):
    _patch(monkeypatch, rcpu, found, active)
    _patch(monkeypatch, tcpu, found, active)
    ref_env, env = dict(env), dict(env)
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        ref_applied = rcpu.apply_serving_env(ref_env)
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        applied = tcpu.apply_serving_env(env)
    ref_env.pop("TF_CPP_MIN_LOG_LEVEL")
    ref_applied.pop("TF_CPP_MIN_LOG_LEVEL", None)
    assert env == ref_env and applied == ref_applied
    # warn, never fail: one warning where tcmalloc is not active, as the
    # reference gives
    assert len(got_w) == len(ref_w) == (0 if active else 1)
    assert all(w.category is RuntimeWarning for w in got_w)
    assert "TF_CPP_MIN_LOG_LEVEL" not in tcpu.SERVING_ENV_PRESET
    assert tcpu.TCMALLOC_CANDIDATES == rcpu.TCMALLOC_CANDIDATES


def test_tcmalloc_branches(monkeypatch):
    # absent: a warning, nothing preloaded
    _patch(monkeypatch, tcpu, None, False)
    env = {}
    with pytest.warns(RuntimeWarning, match="tcmalloc not found"):
        applied = tcpu.apply_serving_env(env)
    assert "LD_PRELOAD" not in env and set(applied) == set(
        tcpu.SERVING_ENV_PRESET)
    # found, not preloaded: LD_PRELOAD appended once, for child processes
    _patch(monkeypatch, tcpu, LIB, False)
    env = {"LD_PRELOAD": "/x/libfoo.so"}
    for _ in range(2):
        with pytest.warns(RuntimeWarning, match="child processes"):
            tcpu.apply_serving_env(env)
    assert env["LD_PRELOAD"] == f"/x/libfoo.so:{LIB}"
    # active: nothing to do, no warning
    _patch(monkeypatch, tcpu, LIB, True)
    env = {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "7"}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tcpu.apply_serving_env(env) == {}
    assert env == {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "7"}
    # quiet: the same settings without the warning
    _patch(monkeypatch, tcpu, None, False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tcpu.apply_serving_env({}, quiet=True)


def test_detection_reads_without_failing():
    assert tcpu.find_tcmalloc() == rcpu.find_tcmalloc()
    assert tcpu.tcmalloc_active() == rcpu.tcmalloc_active()


def test_check_devices_errors():
    with pytest.raises(ValueError, match=">= 1"):
        tcpu.check_devices(0, "cpu")
    # no card here: asking for one raises instead of running on the CPU
    with pytest.raises(RuntimeError, match="0 visible"):
        tcpu.check_devices(1, "cuda")
    with pytest.raises(RuntimeError, match="CUDA_VISIBLE_DEVICES"):
        tcpu.check_devices(2, "cuda")
    # on the CPU, the shards of a batch-sharded session run in turn
    assert tcpu.check_devices(2, "cpu") == 2
    assert tcpu.check_devices(1, "cpu") == 1
