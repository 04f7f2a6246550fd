"""The program's own spans and counters, for the per-layer metrics that read
them: `cineform_tpu_torch.utils.timing`, the port's tracer.

Importing this module turns the tracer on, with a ring of `CAPACITY`
records; only a traced run loads the metrics' readers, which import it, so
an untraced run leaves the tracer off.  A checkout whose program has no
tracer gives no records, and its metrics none.

The tracer's clock is `time.perf_counter_ns()`, the clock of the
benchmark's `perf_counter` seconds and of its `cfbench.window_start` mark,
which `trace.load` maps onto the profiler's trace: the program's spans
lie on the device trace as they are.  They become `spans.Span`s, so that
`spans.host_ms_per_frame`, `trace.device_ms_per_frame`,
`trace.launched_in` and `trace.idle_gaps` read them as they read the
benchmark's.  A window that the ring lost records of reads None.
"""

from __future__ import annotations

from dataclasses import replace

from cfbench import spans, trace

#: the ring's records: a traced run of either cell keeps well under a
#: tenth of this from the warm-up to the profile's end
CAPACITY = 1 << 18

try:
    from cineform_tpu_torch.utils import timing
except ImportError:         # a checkout without the program
    timing = None
if getattr(timing, "enable", None) is not None:
    timing.enable(CAPACITY)


def snapshot():
    """The tracer's records (`timing.Snapshot`), or None where the program
    has no tracer."""
    if getattr(timing, "snapshot", None) is None:
        return None
    return timing.snapshot()


def _sound(snap, start: float) -> bool:
    """Whether `snap` holds every record that ended from `start` (perf_counter
    seconds) on."""
    return snap is not None and (snap.dropped == 0
                                 or snap.lost_until < start * 1e9)


def program_spans(start: float):
    """The program's spans as `spans.Span`s, for a window that starts at
    `start`; None where there is no tracer or the ring lost spans of the
    window."""
    snap = snapshot()
    if not _sound(snap, start):
        return None
    return [spans.Span(s.name, s.thread, s.start / 1e9, s.end / 1e9,
                       s.frames) for s in snap.spans]


def counter_total(name: str, start: float, end: float):
    """The sum of counter `name`'s events in [start, end]; None where there
    is no tracer, the ring lost events of the window, or there are none."""
    snap = snapshot()
    if not _sound(snap, start):
        return None
    ns = [c.n for c in snap.counts
          if c.name == name and start * 1e9 <= c.time <= end * 1e9]
    return sum(ns) if ns else None


def program_trace(tr):
    """`tr` with its kernels' launch threads named as the tracer's thread
    table names them: a thread the profiler knew by its cut
    `pthread_self()` takes its native id (`trace.trace_tids`)."""
    snap = snapshot()
    if tr is None or snap is None:
        return tr
    alias = {}
    for native, ident in snap.threads.items():
        for t in trace.trace_tids(native, ident):
            alias[t] = native
    kernels = [replace(k, launch_thread=alias.get(k.launch_thread,
                                                  k.launch_thread))
               for k in tr.kernels]
    return replace(tr, kernels=kernels)


def within(inner, outer):
    """The `inner` spans that lie inside one of the `outer` spans of their
    thread."""
    return [s for s in inner if any(
        o.thread == s.thread and o.start <= s.start and s.end <= o.end
        for o in outer)]


def host_ms(ctx, name: str, frames_of: str):
    """Host ms a frame in the `name` spans of [start, quiet_end], per thread
    the union of their intervals, over the frames of the `frames_of` spans
    there; None without spans or frames."""
    ss = program_spans(ctx.start)
    if ss is None:
        return None
    inside = spans.in_window(ss, ctx.start, ctx.quiet_end)
    frames = sum(s.frames for s in inside if s.name == frames_of)
    if not frames:
        return None
    by_thread: dict[int, list] = {}
    for s in inside:
        if s.name == name:
            by_thread.setdefault(s.thread, []).append((s.start, s.end))
    return 1e3 * sum(spans.union_seconds(iv)
                     for iv in by_thread.values()) / frames


def device_ms(ctx, name: str, frames_of: str):
    """Device ms a frame of the kernels launched in the `name` spans that lie
    inside the `frames_of` spans of the profiled sub-window, over those
    spans' frames; None without a trace, spans, frames or kernels."""
    tr = program_trace(ctx.trace)
    if tr is None:
        return None
    ss = program_spans(tr.start)
    if ss is None:
        return None
    outer = spans.in_window(ss, tr.start, tr.end, frames_of)
    frames = sum(s.frames for s in outer)
    ks = trace.launched_in(tr, within(
        spans.in_window(ss, tr.start, tr.end, name), outer))
    if not frames or not ks:
        return None
    return 1e3 * sum(k.dur for k in ks) / frames


def idle_unspanned_pct(ctx):
    """100 x the profiled sub-window's device idle whose gap's middle lies
    in no program span on any thread (`trace.idle_gaps`' rule), over all
    its idle; None without a trace, kernels or spans."""
    tr = ctx.trace
    if tr is None or not tr.kernels:
        return None
    ss = program_spans(tr.start)
    if not ss:
        return None
    live = [s for s in ss if s.end >= tr.start and s.start <= tr.end]
    gaps = dict(trace.idle_gaps(tr, live, n=len(live) + 1))
    idle = sum(gaps.values())
    return 100.0 * gaps.get("no span", 0.0) / idle if idle > 0 else 0.0
