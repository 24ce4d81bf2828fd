"""The program's spans and counters, kept in memory, and their attribution
to a CUDA trace's device operations.  A leaf: it imports nothing of the
package, so the kernels, the engine, the smoke test and the benchmark all
take it from here.

A span is a name, a kind, a start and an end on one clock (:func:`now_ns`,
monotonic), the index of the span open on its thread when it began (its
parent), the index of the ``predict`` span it belongs to, the thread's
native id (``threading.get_native_id()``, which a CUDA trace's runtime
events carry where the profiler records host activity; where it records
the device alone they carry the low 32 bits of ``threading.get_ident()``,
which the recorder keeps for each thread in ``threads``) and one integer
argument (a predict's batch, a bucket).  Columns are flat and
preallocated, so a span adds no object for Python's collector to walk;
past ``cap`` spans are dropped and counted (``dropped``).

Hot spans are recorded only while :func:`tracing` is on (off by default),
into a recorder of the window's own (so that a long run never fills the
process's): ``predict`` in
``CompiledModel.__call__``, one per graph node of its walk (a
:class:`Walk`: one clock reading a node, a node ending where the next
begins), ``pad`` around the pad of a conv's blocked input.  Cold spans
(``compile``; ``specialize`` with its ``plan``, noted with the planner's
passes, and ``bind``; ``kernel.load``, noted with ``built`` and nvcc's
``seconds``) go to the process's recorder always, as do the counters
``plans_built``, ``kernels_built`` and ``kernels_loaded``;
``nodes_walked`` counts in the recorder the walk records into.

Attribution (:func:`tie`, :func:`assign`): a trace led by empty kernels
(``torch.cuda._sleep``), the last ``CALS`` of them each launched between
two readings of :func:`now_ns` (:func:`bracketed_leads`), ties the
program's clock to the trace's; each device operation then goes to the
innermost span open on its launch's thread when its runtime call began.
"""
from __future__ import annotations

import bisect
import contextlib
import ctypes
import functools
import threading
import time
from array import array
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

now_ns = time.monotonic_ns          # the one clock of every span

SPAN_CAP = 1 << 17                  # ~8 MB of columns
PREDICT = "predict"                 # the kind interned first: id 0
COUNTERS = ("plans_built", "kernels_built", "kernels_loaded",
            "nodes_walked")
COLD = ("compile", "specialize", "plan", "bind", "kernel.load")
LEAD_KERNEL = "spin_kernel"         # torch.cuda._sleep's
CALS = 64                           # lead launches read between two clocks


class Span(NamedTuple):
    """One recorded span, as :meth:`Recorder.spans` reads it back (``end``
    0 while it is open; ``parent`` and ``predict`` -1 for none)."""

    index: int
    name: str
    kind: str
    start: int
    end: int
    parent: int
    predict: int
    tid: int
    arg: int


class _Top(threading.local):
    """``s``: [the innermost open span of this thread, the thread's
    native id]; registers the thread's ``get_ident()`` under its native id
    in ``threads``."""

    def __init__(self, threads: Dict[int, int]) -> None:
        native = threading.get_native_id()
        threads[native] = threading.get_ident()
        self.s = [-1, native]


class Recorder:
    """Spans in preallocated ``array('q')`` columns (names and kinds as
    indices into one table of strings), counters, and notes on cold spans.
    ``open``, ``close`` and ``walk`` may run on many threads at once: each
    thread nests its own spans."""

    def __init__(self, cap: int = SPAN_CAP) -> None:
        self.cap = int(cap)
        zeros = bytes(8 * self.cap)
        (self.name, self.kind, self.start, self.end, self.parent,
         self.predict, self.tid, self.arg) = (array("q", zeros)
                                              for _ in range(8))
        self._strings: List[str] = []
        self._ids: Dict[str, int] = {}
        self._next = 0                  # the next index
        self._dropped = 0               # spans refused at the cap
        self._lock = threading.Lock()
        self.threads: Dict[int, int] = {}       # native id -> get_ident()
        self._top = _Top(self.threads)
        self.notes: Dict[int, dict] = {}
        self.counters: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
        self.intern(PREDICT)

    def intern(self, s: str) -> int:
        """The id of string ``s`` in the table of names and kinds."""
        i = self._ids.get(s)
        if i is None:
            with self._lock:
                i = self._ids.get(s)
                if i is None:
                    i = len(self._strings)
                    self._strings.append(s)
                    self._ids[s] = i
        return i

    def _take(self, n: int) -> int:
        """The first of ``n`` fresh consecutive indices, or -1 (the ``n``
        spans counted dropped) where they would pass the cap."""
        with self._lock:
            i = self._next
            if i + n > self.cap:
                self._dropped += n
                return -1
            self._next = i + n
        return i

    def open(self, name: int, kind: int, arg: int = 0) -> int:
        """Begin a span (interned ``name`` and ``kind``) under this
        thread's innermost open span; its index, or -1 past the cap."""
        i = self._take(1)
        if i < 0:
            return -1
        top = self._top.s
        p = top[0]
        top[0] = i
        self.name[i] = name
        self.kind[i] = kind
        self.parent[i] = p
        self.predict[i] = i if kind == 0 else (self.predict[p] if p >= 0
                                               else -1)
        self.tid[i] = top[1]
        if arg:                         # the columns start at 0
            self.arg[i] = arg
        self.start[i] = now_ns()
        return i

    def close(self, i: int) -> None:
        """End span ``i`` (from ``open``, on the same thread)."""
        if i >= 0:
            self.end[i] = now_ns()
            self._top.s[0] = self.parent[i]

    def walk(self, names: array, kinds: array) -> Optional["Walk"]:
        """A walk of ``len(names)`` node spans (interned ``names`` and
        ``kinds``) under this thread's innermost open span, their indices
        taken at once; None past the cap (the spans counted dropped)."""
        n = len(names)
        first = self._take(n)
        if first < 0:
            return None
        top = self._top.s
        p = top[0]
        last = first + n
        self.name[first:last] = names
        self.kind[first:last] = kinds
        self.parent[first:last] = array("q", (p,)) * n
        self.predict[first:last] = array(
            "q", (self.predict[p] if p >= 0 else -1,)) * n
        self.tid[first:last] = array("q", (top[1],)) * n
        return Walk(self, first, top)

    def count(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self.counters[counter] += n

    @property
    def recorded(self) -> int:
        """Spans recorded so far: the index the next one takes."""
        return self._next

    @property
    def issued(self) -> int:
        """Spans begun so far, dropped ones included."""
        return self._next + self._dropped

    @property
    def dropped(self) -> int:
        """Spans refused at the cap (``spans_dropped``)."""
        return self._dropped

    def spans(self, first: int = 0) -> List[Span]:
        """The spans recorded from index ``first`` on."""
        s = self._strings
        return [Span(i, s[self.name[i]], s[self.kind[i]], self.start[i],
                     self.end[i], self.parent[i], self.predict[i],
                     self.tid[i], self.arg[i])
                for i in range(first, self._next)]


class Walk:
    """The node spans of one walk (``Recorder.walk``): ``step`` before each
    node takes one clock reading, which begins that node's span and ends
    the one before; ``done`` ends the last and writes the times.  While a
    node runs it is its thread's innermost span, so a ``pad`` nests in
    it."""

    __slots__ = ("rec", "first", "top", "parent", "times")

    def __init__(self, rec: Recorder, first: int, top: list) -> None:
        self.rec = rec
        self.first = first
        self.top = top
        self.parent = top[0]
        self.times: List[int] = []

    def step(self) -> None:
        t = self.times
        self.top[0] = self.first + len(t)
        t.append(now_ns())

    def done(self) -> None:
        t = self.times
        t.append(now_ns())
        self.top[0] = self.parent
        rec, n = self.rec, len(t) - 1
        first = self.first
        rec.start[first:first + n] = array("q", t[:-1])
        rec.end[first:first + n] = array("q", t[1:])
        rec.count("nodes_walked", n)


_recorder: Optional[Recorder] = None
_active: Optional[Recorder] = None     # the recorder while tracing is on
_make_lock = threading.Lock()


def recorder() -> Recorder:
    """The process's recorder, made on first use: cold spans and their
    counters."""
    global _recorder
    if _recorder is None:
        with _make_lock:
            if _recorder is None:
                _recorder = Recorder()
    return _recorder


def tracing(into: Optional[Recorder]) -> None:
    """Record the hot-path spans (``predict``, nodes, ``pad``) into
    ``into``, or, with None, no longer."""
    global _active
    _active = into


def active() -> Optional[Recorder]:
    """The recorder while tracing is on, else None: the one read of the
    switch a hot path makes."""
    return _active


@contextlib.contextmanager
def use(rec: Recorder):
    """Make ``rec`` the process's recorder while the block runs."""
    global _recorder
    old, _recorder = _recorder, rec
    try:
        yield rec
    finally:
        _recorder = old


@contextlib.contextmanager
def span(kind: str, name: Optional[str] = None, arg: int = 0):
    """A cold span, recorded whatever the switch says; yields its index."""
    rec = recorder()
    i = rec.open(rec.intern(kind if name is None else name),
                 rec.intern(kind), arg)
    try:
        yield i
    finally:
        rec.close(i)


def spanned(kind: str):
    """Decorator: each call of the function is one cold span ``kind``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(kind):
                return fn(*args, **kwargs)
        return inner
    return wrap


def note(i: int, **fields) -> None:
    """Attach ``fields`` to cold span ``i`` (a plan's passes, a build's
    seconds)."""
    if i >= 0:
        recorder().notes[i] = fields


def count(counter: str, n: int = 1) -> None:
    recorder().count(counter, n)


def setup_split(rec: Optional[Recorder] = None, first: int = 0) -> Dict:
    """What the cold spans of ``rec`` (the process's), from index
    ``first`` on, say of set-up: seconds by kind (a kind nested in another
    counted in both), each plan's passes with its bucket, each kernel
    library's load with ``built`` and nvcc's ``seconds``."""
    rec = rec or recorder()
    rows = rec.spans(first)
    by_index = {r.index: r for r in rows}
    seconds = dict.fromkeys(COLD, 0.0)
    plans, loads = [], []
    for r in rows:
        if r.kind not in seconds or not r.end:
            continue
        seconds[r.kind] += (r.end - r.start) / 1e9
        notes = rec.notes.get(r.index, {})
        if r.kind == "plan":
            up = by_index.get(r.parent)
            plans.append({"bucket": up.arg if up else None,
                          "passes": notes.get("passes", [])})
        elif r.kind == "kernel.load":
            loads.append({"kernel": r.name, "s": (r.end - r.start) / 1e9,
                          **notes})
    return {"seconds": seconds, "plans": plans, "kernel_loads": loads}


# ---------------------------------------------------------------------------
# Attribution to a CUDA trace
# ---------------------------------------------------------------------------

class Event(NamedTuple):
    name: str
    start: int
    end: int
    correlation: int
    device: bool
    thread: int                      # a runtime event's thread (32 bits)


def read_events(prof) -> List[Event]:
    """The events of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append(Event(e.name(), start, start + e.duration_ns(),
                         e.correlation_id(),
                         e.device_type() == DeviceType.CUDA,
                         e.device_resource_id()))
    return out


def thread32(ident: int) -> int:
    """A thread's ``get_ident()`` as a runtime event of a trace of the
    device alone carries it."""
    return ctypes.c_int32(ident).value


def aliases(threads: Dict[int, int]) -> Dict[int, int]:
    """Each id a runtime event may carry for a thread (its native id, the
    low 32 bits of its ``get_ident()``) -> its native id, from a
    recorder's ``threads``."""
    out = {thread32(ident): native for native, ident in threads.items()}
    out.update((native, native) for native in threads)
    return out


def bracketed_leads(n: int = CALS) -> List[Tuple[int, int]]:
    """Launch ``n`` empty kernels, each between two readings of
    :func:`now_ns`; the readings, for :func:`tie`."""
    import torch

    out = []
    for _ in range(n):
        a = now_ns()
        torch.cuda._sleep(0)
        out.append((a, now_ns()))
    return out


def lead_launches(events: Sequence[Event]) -> List[Event]:
    """The runtime calls that launched the trace's lead kernels, in
    order."""
    leads = {e.correlation for e in events
             if e.device and LEAD_KERNEL in e.name}
    return sorted((e for e in events if not e.device
                   and "LaunchKernel" in e.name and e.correlation in leads),
                  key=lambda e: e.start)


def tie(leads: Sequence[Event], cals: Sequence[Tuple[int, int]]
        ) -> Tuple[int, int]:
    """(offset, width) from the program's clock to the trace's: ``cals``
    (``bracketed_leads``) are the last of the lead launches ``leads``;
    each bounds the offset from above (launch start minus the reading
    before) and below (launch end minus the reading after), and the
    offset is the middle of the tightest bounds.  ``ValueError`` where
    launches are missing or no offset fits."""
    leads = list(leads)[-len(cals):]
    if len(leads) < len(cals):
        raise ValueError(f"{len(leads)} of {len(cals)} bracketed lead "
                         "launches in the trace")
    upper = min(e.start - a for e, (a, _b) in zip(leads, cals))
    lower = max(e.end - b for e, (_a, b) in zip(leads, cals))
    if lower > upper:
        raise ValueError(f"the program's clock does not tie to the "
                         f"trace's ({lower} > {upper} ns)")
    return (lower + upper) // 2, upper - lower


class _Threads:
    """The spans of each thread, sorted by start, on the trace's clock;
    ``at`` finds the innermost open at a time."""

    def __init__(self, rows, offset: int, ids: Dict[int, int]) -> None:
        self.by_index = {r.index: r for r in rows}
        self.offset = offset
        self.ids = ids
        threads: Dict[int, list] = {}
        for r in rows:
            threads.setdefault(r.tid, []).append(r)
        self.rows = {t: sorted(rs, key=lambda r: r.start)
                     for t, rs in threads.items()}
        self.starts = {t: [r.start + offset for r in rs]
                       for t, rs in self.rows.items()}

    def at(self, thread: int, t: int):
        """The innermost span of ``thread`` open at ``t``, or None: the
        latest begun before ``t``, else its nearest ancestor open then
        (spans of one thread nest)."""
        thread = self.ids.get(thread, thread)
        starts = self.starts.get(thread)
        if not starts:
            return None
        k = bisect.bisect_right(starts, t) - 1
        row = self.rows[thread][k] if k >= 0 else None
        while row is not None and not (row.end and row.end + self.offset
                                       >= t):
            row = self.by_index.get(row.parent)
        return row


def assign(events: Sequence[Event], rows, offset: int,
           ids: Dict[int, int]):
    """Each device operation of ``events`` (the lead kernels left out)
    with the innermost span of ``rows`` (on the program's clock, ``offset``
    from the trace's) open on its launch's thread (``ids``: ``aliases``)
    when its runtime call began, or None; and the spans by index."""
    threads = _Threads(rows, offset, ids)
    runtime = {e.correlation: e for e in events if not e.device
               and e.correlation and e.name.startswith("cu")}
    owned = []
    for e in events:
        if not e.device or LEAD_KERNEL in e.name:
            continue
        call = runtime.get(e.correlation)
        owned.append((e, threads.at(call.thread, call.start) if call
                      else None))
    return owned, threads.by_index
