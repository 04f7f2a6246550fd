"""The profiler's trace of the traced run's sub-window, read into what the
per-layer metrics need: the device's busy intervals, each kernel's device
time and the host thread and moment of its launch, and the host spans put
on the trace's clock.

The trace is `torch.profiler`'s Chrome trace (kineto): device events of
the categories `kernel`, `gpu_memcpy` and `gpu_memset`, the CUDA runtime
calls that launched them (`cuda_runtime`, `cuda_driver`, tied to them by
`args.correlation`), and the `record_function` ranges (`user_annotation`).
Two ranges that the harness opens on its own thread at the sub-window's
ends, `cfbench.window_start` and `cfbench.window_end`, give the offset
between the trace's clock and the host's `perf_counter` and bound the
window.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

from cfbench.spans import union_seconds

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Kernel:
    name: str
    start: float          # host perf_counter seconds, on the host's clock
    dur: float            # seconds
    launch_thread: int | None
    launch_time: float | None


@dataclass
class Trace:
    start: float          # the sub-window on the host's clock, seconds
    end: float
    kernels: list = field(default_factory=list)   # Kernel, kernels only
    device: list = field(default_factory=list)    # (start, end, name), all
    launches_found: int = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def busy_intervals(self):
        return [(max(s, self.start), min(e, self.end))
                for s, e, _ in self.device if e > self.start and s < self.end]

    def busy_seconds(self) -> float:
        return union_seconds(self.busy_intervals())


def trace_tids(native: int, ident: int) -> set[int]:
    """The ids under which the trace may name a thread's CUDA calls: its
    native id where the profiler knows the thread (it recorded an operator
    there), else the thread's `pthread_self()` (`threading.get_ident()`)
    cut to a signed 32-bit int, written without its sign."""
    cut = ident & 0xFFFFFFFF
    signed = cut - (1 << 32) if cut >= 1 << 31 else cut
    return {native, cut, signed, abs(signed)}


def load(path: str, host_start: float,
         threads: dict | None = None) -> Trace:
    """Read the Chrome trace at `path`; `host_start` is the `perf_counter`
    reading taken inside the `cfbench.window_start` range; `threads` maps
    each native thread id of the host spans to its `threading.get_ident()`,
    so that a launch's thread is given by its native id."""
    alias = {}
    for native, ident in (threads or {}).items():
        for t in trace_tids(native, ident):
            alias[t] = native
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    marks = {e["name"]: e["ts"] for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") in ("cfbench.window_start",
                                   "cfbench.window_end")}
    if len(marks) != 2:
        raise RuntimeError("the trace lacks the harness's window ranges")
    # trace microseconds -> host seconds
    offset = marks["cfbench.window_start"] / 1e6 - host_start
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            tid = int(e.get("tid", 0))
            launches[e["args"]["correlation"]] = (
                alias.get(tid, tid), e["ts"] / 1e6 - offset)
    t = Trace(start=host_start, end=marks["cfbench.window_end"] / 1e6 - offset)
    for e in events:
        cat = e.get("cat")
        if cat not in DEVICE_CATS or "dur" not in e:
            continue
        s = e["ts"] / 1e6 - offset
        d = e["dur"] / 1e6
        t.device.append((s, s + d, e.get("name", cat)))
        if cat == "kernel":
            tid, when = launches.get(e.get("args", {}).get("correlation"),
                                     (None, None))
            t.launches_found += tid is not None
            t.kernels.append(Kernel(e.get("name", ""), s, d, tid, when))
    t.device.sort()
    return t


def _merged(intervals):
    """Sorted, disjoint (starts, ends) of the union of `intervals`."""
    starts, ends = [], []
    for a, b in sorted(intervals):
        if starts and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def launched_in(trace: Trace, spans):
    """The kernels of `trace` launched inside one of `spans` (on the span's
    thread, within its start and end)."""
    per_thread: dict[int, list] = {}
    for s in spans:
        per_thread.setdefault(s.thread, []).append((s.start, s.end))
    merged = {tid: _merged(iv) for tid, iv in per_thread.items()}
    out = []
    for k in trace.kernels:
        if k.launch_thread not in merged:
            continue
        starts, ends = merged[k.launch_thread]
        i = bisect.bisect_right(starts, k.launch_time) - 1
        if i >= 0 and ends[i] >= k.launch_time:
            out.append(k)
    return out


def top_device_ops(trace: Trace, n: int = 10):
    """[name, seconds] of the device operations that took most time in the
    sub-window, summed by name."""
    total: dict[str, float] = {}
    for s, e, name in trace.device:
        s, e = max(s, trace.start), min(e, trace.end)
        if e > s:
            total[name] = total.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, spans, n: int = 10):
    """[label, seconds] of the device's idle time in the sub-window, summed
    by what the host was doing in each gap: the innermost benchmark span
    running at the gap's middle (on any thread), else `no span`."""
    gaps, end = [], trace.start
    for s, e in sorted(trace.busy_intervals()):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if trace.end > end:
        gaps.append((end, trace.end))
    ordered = sorted(spans, key=lambda s: s.start)
    starts = [s.start for s in ordered]
    reach, far = [], float("-inf")      # the latest end among spans 0..i
    for s in ordered:
        far = max(far, s.end)
        reach.append(far)
    total: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = "no span"
        i = bisect.bisect_right(starts, mid) - 1
        # back from the latest start: the first span that covers the
        # middle is the innermost; none before i can once `reach` < mid
        while i >= 0 and reach[i] >= mid:
            if ordered[i].end >= mid:
                label = ordered[i].name
                break
            i -= 1
        total[label] = total.get(label, 0.0) + (b - a)
    return [[k, v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def device_ms_per_frame(trace: Trace | None, spans,
                        name: str) -> float | None:
    """Device milliseconds a frame of the kernels launched inside the
    `name` spans that lie wholly in the profiled sub-window, over those
    spans' frames; None without a trace, spans or kernels."""
    if trace is None:
        return None
    inside = [s for s in spans if s.name == name and s.start >= trace.start
              and s.end <= trace.end]
    frames = sum(s.frames for s in inside)
    ks = launched_in(trace, inside)
    if not frames or not ks:
        return None
    return 1e3 * sum(k.dur for k in ks) / frames


def idle_pct(trace: Trace | None) -> float | None:
    """100 less the device's busy share of the profiled sub-window; None
    without a trace or with no kernel in it (a trace that lost its
    kernels would read the copies alone)."""
    if trace is None or not trace.kernels or trace.seconds <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_seconds() / trace.seconds)
