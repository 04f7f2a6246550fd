"""The program's tracer: spans and counters at its layer boundaries, the
reference's TIMER/COUNTER analog (`Codec/timing.h:88-115`), with its CSV
statistics (`PrintStatistics`, `timing.h:42`) as `report()`.

Off by default.  Off, `span()` tests one module-level flag and returns a
shared no-op context; `count()` returns at once.  `enable(capacity)` turns
it on: then

- a span (`with span(name):`) records its id, its parent's id (the span
  open around it on the same thread), its request id, its name, the
  native id of its thread, its start and end on `time.perf_counter_ns()`
  (the clock of `time.perf_counter()`), and the frames it worked on (with
  their frame numbers where the caller gives them).  A span opened with
  `root=True` starts a new request; the others inherit their parent's
  request id, 0 outside any request.  While a `torch.profiler` session
  records on the span's thread, the span also opens a `record_function`
  range of its name;
- a counter increment (`count(name, n)`) is an event with its time, so a
  reader can sum it over any window; `report()` keeps the running totals;
- each thread's `threading.get_ident()` is kept once beside its native id
  (a profiler names a thread it recorded no operator on by the former);
- spans and counter events are kept in a ring of `capacity` records; the
  records it pushed out are counted in `dropped`, and `lost_until` is the
  time of the newest of them, so a reader can tell whether a window lost
  any.

`snapshot()` copies the ring out.  The tracer never synchronizes the
device or touches device memory.
"""

from __future__ import annotations

import io
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

DEFAULT_CAPACITY = 1 << 16


class SpanRecord(NamedTuple):
    id: int
    parent: int            # 0: no span was open around it
    request: int           # 0: outside any request
    name: str
    thread: int            # threading.get_native_id()
    start: int             # time.perf_counter_ns()
    end: int
    frames: int
    numbers: list | None   # the frames' numbers, where the caller gave them


class CountEvent(NamedTuple):
    name: str
    thread: int
    time: int              # time.perf_counter_ns()
    n: int


class Snapshot(NamedTuple):
    spans: list            # SpanRecord, in the order they ended
    counts: list           # CountEvent, in time order
    dropped: int           # records the ring pushed out
    lost_until: int        # the time of the newest of them; -1: none
    threads: dict          # native thread id -> threading.get_ident()


_on = False
_lock = threading.Lock()
#: span records as plain tuples in SpanRecord's order, counter events in
#: CountEvent's; `snapshot` names their fields
_ring: deque = deque(maxlen=DEFAULT_CAPACITY)
_dropped = 0
_lost_until = -1
_threads: dict[int, int] = {}
_totals: dict[str, list] = {}     # name -> [calls, total, min, max] in ns
_counters: dict[str, int] = {}
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()
_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Thread:
    """A thread's native id, entered in the thread table once, and its
    stack of open spans: (id, request id) each."""

    __slots__ = ("native", "stack")

    def __init__(self):
        self.native = threading.get_native_id()
        self.stack = []
        _threads[self.native] = threading.get_ident()


def _thread() -> _Thread:
    try:
        return _local.state
    except AttributeError:
        _local.state = state = _Thread()
        return state


def _keep(rec: tuple) -> None:
    """Under the lock: put `rec` in the ring, counting what it pushes
    out."""
    global _dropped, _lost_until
    ring = _ring
    if len(ring) == ring.maxlen:
        old = ring[0]
        _dropped += 1
        _lost_until = old[6] if len(old) == len(SpanRecord._fields) \
            else old[2]
    ring.append(rec)


class _Span:
    __slots__ = ("name", "frames", "numbers", "root", "state", "id",
                 "parent", "request", "start", "range")

    def __init__(self, name, frames, numbers, root):
        self.name, self.frames, self.numbers, self.root = \
            name, frames, numbers, root

    def __enter__(self):
        self.state = state = _thread()
        stack = state.stack
        self.id = next(_ids)
        self.parent, request = stack[-1] if stack else (0, 0)
        self.request = next(_requests) if self.root else request
        stack.append((self.id, self.request))
        self.range = None
        if _profiling():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = _clock()

    def __exit__(self, *exc):
        end = _clock()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.state.stack.pop()
        name, start = self.name, self.start
        dt = end - start
        rec = (self.id, self.parent, self.request, name, self.state.native,
               start, end, self.frames, self.numbers)
        with _lock:
            _keep(rec)
            t = _totals.get(name)
            if t is None:
                _totals[name] = [1, dt, dt, dt]
            else:
                t[0] += 1
                t[1] += dt
                if dt < t[2]:
                    t[2] = dt
                if dt > t[3]:
                    t[3] = dt
        return False


def span(name: str, frames: int = 0, numbers: list | None = None,
         root: bool = False):
    """A context that records one span of `name` while the tracer is on:
    `frames` the frames it works on, `numbers` their frame numbers,
    `root` True to start a new request."""
    if not _on:
        return _OFF
    return _Span(name, frames, numbers, root)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`: one event, with its time."""
    if not _on:
        return
    rec = (name, _thread().native, _clock(), n)
    with _lock:
        _keep(rec)
        _counters[name] = _counters.get(name, 0) + n


def active() -> bool:
    """Whether the tracer is on: a caller computes a counter's value only
    then."""
    return _on


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Turn the tracer on, with an empty ring of `capacity` records."""
    global _on, _ring
    if capacity < 1:
        raise ValueError(f"a ring of {capacity} records")
    with _lock:
        _ring = deque(maxlen=capacity)
    reset()
    _on = True


def disable() -> None:
    """Turn the tracer off; what it recorded stays until `reset`."""
    global _on
    _on = False


def reset() -> None:
    """Forget every record, the dropped count and the totals."""
    global _dropped, _lost_until
    with _lock:
        _ring.clear()
        _dropped, _lost_until = 0, -1
        _totals.clear()
        _counters.clear()


def snapshot() -> Snapshot:
    """A copy of the ring's records, the dropped count and the threads."""
    with _lock:
        records = list(_ring)
        dropped, lost_until = _dropped, _lost_until
        threads = dict(_threads)
    n = len(SpanRecord._fields)
    return Snapshot([SpanRecord._make(r) for r in records if len(r) == n],
                    [CountEvent._make(r) for r in records if len(r) != n],
                    dropped, lost_until, threads)


def report() -> str:
    """CSV: per span name its calls and total, mean, min and max ms, then
    each counter's running total (`counter:<name>,<total>`)."""
    with _lock:
        totals = {k: list(v) for k, v in _totals.items()}
        counters = dict(_counters)
    out = io.StringIO()
    out.write("span,calls,total_ms,mean_ms,min_ms,max_ms\n")
    for name, (calls, total, lo, hi) in sorted(totals.items()):
        out.write(f"{name},{calls},{total / 1e6:.3f},"
                  f"{total / calls / 1e6:.3f},{lo / 1e6:.3f},"
                  f"{hi / 1e6:.3f}\n")
    for name, v in sorted(counters.items()):
        out.write(f"counter:{name},{v}\n")
    return out.getvalue()
