"""Streamed decode through the port's ``AsyncServer`` on the CPU.

(b) A reduced qwen2-1.5b ``LMSession`` of the port on the weights of the
reference's (``lm_params_from_numpy``): the tokens streamed by the port's
``submit_stream`` and by the reference's agree at every step whose top-2
logit margin on the reference exceeds 1e-4 of the largest logit, up to
the first near-tie that changes a token (the rule of
``tests/test_torch_lm_session.py``), and the two servers' ``to_json()``
of one scripted fake-clock run are equal.

(c) The invariants of the reference's ``tests/test_lm_serving.py`` on the
port: streamed tokens bit-identical to ``generate`` and observable before
the request finishes, streams executing alone, a real-thread stream,
typed admission errors, queued-deadline expiry, the traffic recorder, the
``TokenStream`` dedup of replayed steps, and the serving surface
(``input_spec``, ``frozen``, ``batch_sizes``) and a reduced mamba2-130m
stream as well.
"""
import concurrent.futures as cf
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.engine import AsyncServer as RServer
from repro.engine import DynamicBatchPolicy as RPolicy
from repro.engine import compile_lm as r_compile_lm
from repro.models.lm import decode_step as r_decode, prefill as r_prefill
from repro_torch.configs import ARCHS, reduced
from repro_torch.engine import (AsyncServer, DeadlineExceededError,
                                DynamicBatchPolicy, ServerClosedError,
                                ServingError, StreamRequest, TokenStream,
                                compile_lm, lm_params_from_numpy)
from repro_torch.engine.serving import Request, RequestTooLargeError

MARGIN = 1e-4
CFG = reduced(ARCHS["qwen2-1.5b"])


@pytest.fixture(scope="module")
def pair():
    r_cfg = r_reduced(R_ARCHS["qwen2-1.5b"])
    ref = r_compile_lm(r_cfg, max_len=32, seq_buckets=[8, 16], seed=0)
    port = compile_lm(CFG, max_len=32, seq_buckets=[8, 16], device="cpu",
                      params=lm_params_from_numpy(ref._params, "cpu"))
    port.prewarm()
    return r_cfg, ref, port


@pytest.fixture(scope="module")
def lm(pair):
    return pair[2]


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


def _manual(lm, cls=AsyncServer, policy_cls=DynamicBatchPolicy, **kw):
    clock = FakeClock()
    srv = cls(lm, policy_cls(max_batch=4, max_wait_ms=10.0), clock=clock,
              autostart=False, **kw)
    return srv, clock


def _prompt(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab, size=(1, n)).astype(np.int32)


def _margins(r_cfg, params, toks, new, max_len=32):
    """Top-2 margins relative to the largest logit along the reference's
    greedy path."""
    cache, lg = r_prefill(params, r_cfg, jnp.asarray(toks), max_len=max_len)
    out = []
    for t in range(new):
        a = np.asarray(lg)
        top2 = np.sort(a, axis=-1)[:, -2:]
        out.append(((top2[:, 1] - top2[:, 0]) / np.abs(a).max()).min())
        nxt = jnp.argmax(lg, -1).astype(jnp.int32)
        lg, cache = r_decode(params, r_cfg, nxt[:, None], cache,
                             jnp.int32(toks.shape[1] + t))
    return out


# ---------------------------------------------------------------------------
# (b) against the reference's server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [11, 16])
def test_streamed_tokens_agree_with_reference(pair, n):
    r_cfg, ref, port = pair
    toks = _prompt(n, seed=n)
    streams = []
    for srv, clock in (_manual(ref, RServer, RPolicy), _manual(port)):
        s = srv.submit_stream(toks, 6)
        assert srv.step()
        streams.append(np.stack([np.asarray(t) for t in s], axis=1))
        srv.close()
    want, got = streams
    compared = 0
    for t, m in enumerate(_margins(r_cfg, ref._params, toks, 6)):
        same = np.array_equal(got[:, t], want[:, t])
        if m > MARGIN:
            assert same, f"step {t} differs with a top-2 margin of {m}"
            compared += 1
        elif not same:
            break
    assert compared > 0


def test_scripted_stream_run_same_stats_as_reference(pair):
    r_cfg, ref, port = pair

    def script(sess, cls, policy_cls):
        srv, clock = _manual(sess, cls, policy_cls, max_queue=3)
        out = []
        for i, n in enumerate((5, 9, 17, 6)):
            try:
                out.append(srv.submit_stream(
                    _prompt(n, seed=n), 3,
                    deadline_ms=5.0 if i == 2 else None,
                    priority=("interactive", "batch")[i % 2]))
            except Exception as e:    # noqa: BLE001 — compared
                out.append(type(e).__name__)
            clock.advance_ms(3.0)
        srv.step()
        clock.advance_ms(10.0)
        while srv.step():
            clock.advance_ms(2.0)
        srv.close()
        kinds = [s if isinstance(s, str) else
                 type(s.future.exception()).__name__
                 if s.future.exception() else "ok" for s in out]
        return srv.stats.to_json(), kinds

    assert script(port, AsyncServer, DynamicBatchPolicy) == \
        script(ref, RServer, RPolicy)


# ---------------------------------------------------------------------------
# (c) bit-identity and incremental delivery
# ---------------------------------------------------------------------------

def test_serving_surface(lm):
    assert lm.input_spec == {"tokens": (1, 32)}
    assert lm.frozen and lm.batch_sizes == [1]


def test_stream_tokens_bit_identical_to_generate(lm):
    toks = _prompt(11)
    want = lm.generate(toks, 6)
    srv, _ = _manual(lm)
    stream = srv.submit_stream(torch.from_numpy(toks), 6)
    assert srv.step()
    got_steps = [np.asarray(t) for t in stream]
    assert len(got_steps) == 6
    np.testing.assert_array_equal(np.stack(got_steps, axis=1), want)
    np.testing.assert_array_equal(np.asarray(stream.result(timeout=5)),
                                  want)
    srv.close()


def test_stream_arrives_incrementally(lm, monkeypatch):
    toks = _prompt(9)
    srv, _ = _manual(lm)
    seen_before_done = []
    orig = TokenStream.push

    def spy(self, step, tokens):
        seen_before_done.append(not self.future.done())
        orig(self, step, tokens)

    monkeypatch.setattr(TokenStream, "push", spy)
    stream = srv.submit_stream(toks, 4)
    assert srv.step()
    assert seen_before_done == [True] * 4
    assert len(list(stream)) == 4
    srv.close()


def test_concurrent_streams_serialize_and_match(lm):
    prompts = [_prompt(n, seed=n) for n in (5, 9, 17)]
    want = [lm.generate(p, 4) for p in prompts]
    srv, _ = _manual(lm, max_queue=8)
    streams = [srv.submit_stream(p, 4) for p in prompts]
    for _ in prompts:
        assert srv.step()
    assert not srv.step()
    for s, w in zip(streams, want):
        np.testing.assert_array_equal(np.asarray(s.result(timeout=5)), w)
    st = srv.stats
    assert st.n_completed == 3 and st.batch_hist.max_size == 1
    srv.close()


@pytest.mark.parametrize("workers", [1, 2])
def test_threaded_autostart_stream(lm, workers):
    prompts = [_prompt(n, seed=n) for n in (13, 7)]
    want = [lm.generate(p, 5) for p in prompts]
    with AsyncServer(lm, DynamicBatchPolicy(max_batch=2, max_wait_ms=2.0),
                     workers=workers) as srv:
        streams = [srv.submit_stream(p, 5) for p in prompts]
        got = [np.stack([np.asarray(t) for t in s], axis=1)
               for s in streams]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mamba2_stream_bit_identical_to_generate():
    sess = compile_lm(reduced(ARCHS["mamba2-130m"]), max_len=32,
                      seq_buckets=[8, 16], device="cpu", seed=0)
    toks = np.random.default_rng(2).integers(0, sess.cfg.vocab,
                                             size=(1, 12))
    want = sess.generate(toks, 4)
    srv, _ = _manual(sess)
    stream = srv.submit_stream(toks, 4)
    assert srv.step()
    np.testing.assert_array_equal(
        np.stack([np.asarray(t) for t in stream], axis=1), want)
    srv.close()


# ---------------------------------------------------------------------------
# (c) admission control + typed failures
# ---------------------------------------------------------------------------

def test_submit_on_lm_server_raises(lm):
    srv, _ = _manual(lm)
    with pytest.raises(ServingError, match="submit_stream"):
        srv.submit(np.zeros((1, 8), np.int32))
    srv.close()


def test_stream_validation(lm):
    srv, _ = _manual(lm)
    with pytest.raises(RequestTooLargeError):
        srv.submit_stream(_prompt(30), 8)
    with pytest.raises(ValueError):
        srv.submit_stream(_prompt(5)[0], 2)
    with pytest.raises(ValueError):
        srv.submit_stream(_prompt(5), 0)
    with pytest.raises(ValueError, match="batch"):
        srv.submit_stream(np.zeros((2, 5), np.int32), 2)
    srv.close()


def test_stream_deadline_expires_in_queue(lm):
    srv, clock = _manual(lm)
    stream = srv.submit_stream(_prompt(6), 3, deadline_ms=5.0)
    clock.advance_ms(50.0)
    srv.step()
    with pytest.raises(DeadlineExceededError):
        list(stream)
    with pytest.raises(DeadlineExceededError):
        stream.result(timeout=5)
    srv.close()


def test_stream_after_close_raises(lm):
    srv, _ = _manual(lm)
    srv.close()
    with pytest.raises(ServerClosedError):
        srv.submit_stream(_prompt(6), 2)


def test_traffic_recorded_once_per_stream(lm):
    srv, _ = _manual(lm)
    before = lm.traffic.counts()
    srv.submit_stream(_prompt(7), 2)
    assert srv.step()
    assert lm.traffic.counts().get(7, 0) == before.get(7, 0) + 1
    srv.close()


def test_cnn_server_refuses_streams():
    class Cnn:
        input_spec = {"x": (1, 4)}
        batch_sizes = [1]
        frozen = True

    srv = AsyncServer(Cnn(), autostart=False)
    with pytest.raises(ServingError, match="submit_stream needs"):
        srv.submit_stream(_prompt(4), 2)
    srv.close()


# ---------------------------------------------------------------------------
# (c) TokenStream unit behavior
# ---------------------------------------------------------------------------

def test_token_stream_dedups_replayed_steps():
    fut = cf.Future()
    ts = TokenStream(fut)
    ts.push(0, "a")
    ts.push(0, "a")
    ts.push(1, "b")
    ts.push(3, "skip")
    fut.set_result("done")
    assert list(ts) == ["a", "b"]
    assert list(ts) == []


def test_token_stream_raises_future_exception():
    fut = cf.Future()
    ts = TokenStream(fut)
    ts.push(0, "a")
    fut.set_exception(ServingError("boom"))
    it = iter(ts)
    assert next(it) == "a"
    with pytest.raises(ServingError, match="boom"):
        next(it)


def test_token_stream_consumed_from_another_thread():
    fut = cf.Future()
    ts = TokenStream(fut)
    got = []
    t = threading.Thread(target=lambda: got.extend(ts))
    t.start()
    for i in range(5):
        ts.push(i, i)
    fut.set_result(None)
    t.join(10)
    assert got == [0, 1, 2, 3, 4]


def test_stream_request_is_request():
    assert issubclass(StreamRequest, Request)
