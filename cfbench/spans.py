"""Spans and call records that the traced run puts around the program's
functions, from the benchmark's side: the program is not edited.

A span is (name, thread, start, end, frames): the host clock
(`time.perf_counter`) around one call of a wrapped function on the thread
that made it, and the frames the call worked on, as the span's spec
counts them.  Each wrapped call also opens a `torch.profiler.
record_function` range of the same name, so that the profiler's trace
shows it.

A spec names its target by where the program calls it: the module and
the attribute path (`IntraCodec.write_samples`, or a function's name in
the module that imported it).  A target that is gone installs nothing, and
the metrics that read its spans find none: absent, not 0.
"""

from __future__ import annotations

import importlib
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class Span:
    name: str
    thread: int           # threading.get_native_id() of the caller
    start: float          # perf_counter seconds
    end: float
    frames: int


@dataclass(frozen=True)
class Spec:
    """Wrap `module`.`attr` (a dotted path inside the module) as span
    `name`; `frames(args, kwargs)` counts the frames of a call (args with
    `self` first for a method), `nbytes(args, kwargs, result)` the bytes
    it reads and writes, where the span feeds a roofline."""

    name: str
    module: str
    attr: str
    frames: object = None
    nbytes: object = None


class Recorder:
    """Installs specs and keeps what their calls record, until `remove`."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        #: per span name, the bytes its calls counted
        self.call_bytes: list[tuple[str, int, float, float, int]] = []
        self.installed: list[str] = []
        #: native id -> `threading.get_ident()` of each thread that made a
        #: call (the profiler names some threads by the latter)
        self.threads: dict[int, int] = {}
        self._undo: list[tuple[object, str, object]] = []

    def install(self, specs) -> None:
        import torch

        seen = set()
        for spec in specs:
            if spec.name in seen:
                continue
            seen.add(spec.name)
            try:
                owner = importlib.import_module(spec.module)
            except ImportError:
                continue
            *path, leaf = spec.attr.split(".")
            for part in path:
                owner = getattr(owner, part, None)
                if owner is None:
                    break
            fn = getattr(owner, leaf, None) if owner is not None else None
            if fn is None or not callable(fn):
                continue
            self._undo.append((owner, leaf, owner.__dict__.get(leaf, fn)))
            setattr(owner, leaf, self._wrap(spec, fn, torch))
            self.installed.append(spec.name)

    def _wrap(self, spec: Spec, fn, torch):
        spans, calls, threads = self.spans, self.call_bytes, self.threads
        record = torch.profiler.record_function

        def wrapped(*args, **kwargs):
            tid = threading.get_native_id()
            threads[tid] = threading.get_ident()
            t0 = time.perf_counter()
            with record(spec.name):
                out = fn(*args, **kwargs)
            t1 = time.perf_counter()
            frames = spec.frames(args, kwargs) if spec.frames else 0
            spans.append(Span(spec.name, tid, t0, t1, frames))
            if spec.nbytes:
                calls.append((spec.name, tid, t0, t1,
                              spec.nbytes(args, kwargs, out)))
            return out

        wrapped.__wrapped__ = fn
        return wrapped

    def remove(self) -> None:
        for owner, leaf, orig in reversed(self._undo):
            setattr(owner, leaf, orig)
        self._undo.clear()


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in `objs`, nested tuples and lists included:
    each read or written once."""
    import torch

    total = 0
    stack = list(objs)
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            stack.extend(o)
    return total


def in_window(spans, start: float, end: float, name: str | None = None):
    """The spans (of `name`, where given) that lie wholly in [start, end]."""
    return [s for s in spans if (name is None or s.name == name)
            and s.start >= start and s.end <= end]


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def self_seconds(outer, inner) -> float:
    """Summed duration of the `outer` spans less the part of each that
    `inner` spans of the same thread cover."""
    by_thread: dict[int, list] = {}
    for s in inner:
        by_thread.setdefault(s.thread, []).append((s.start, s.end))
    total = 0.0
    for o in outer:
        covered = union_seconds(
            (max(a, o.start), min(b, o.end))
            for a, b in by_thread.get(o.thread, ())
            if b > o.start and a < o.end)
        total += (o.end - o.start) - covered
    return total


def host_ms_per_frame(spans, names, start: float, end: float,
                      frames_of: str) -> float | None:
    """Host milliseconds a frame in the spans of `names` that lie in [start,
    end]: per thread, the union of their intervals (a nested call counted
    once), over the frames of the `frames_of` spans; None where there are
    none."""
    inside = [s for s in spans if s.name in names
              and s.start >= start and s.end <= end]
    frames = sum(s.frames for s in inside if s.name == frames_of)
    if not frames:
        return None
    by_thread: dict[int, list] = {}
    for s in inside:
        by_thread.setdefault(s.thread, []).append((s.start, s.end))
    return 1e3 * sum(union_seconds(iv) for iv in by_thread.values()) / frames
