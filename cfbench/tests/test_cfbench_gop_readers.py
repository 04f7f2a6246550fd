"""The GOP playback cell's six per-layer readers (`cfbench/metrics/gop_*`,
on `cfbench/program.py`) on synthetic records of the port's tracer and a
synthetic `trace.Trace`, against values worked by hand: calls cut by
each edge of a window, a call that delivers no frame, counter events on
another thread; none where the program has no GOP spans or counters, or
its ring lost records of the window."""

from types import SimpleNamespace

import pytest

from cfbench import plugins, program, trace
from cfbench.tests.conftest import ROOT
from cineform_tpu_torch.utils import timing

NAMES = ("gop_entropy_device_ms", "gop_inverse_device_ms",
         "gop_inverse_roofline", "gop_walk_host_ms",
         "gop_group_decodes_per_frame", "gop_fallback_pct")
NS = 1_000_000_000
#: a 96x48 frame to v210 (`inverse_bytes`): coefficients of Y at 96 and
#: of U and V at 48 wide, 4 bytes each, and 48 rows of 256 bytes
V210_BYTES = 4 * (4 * 6 * 12 + 7 * 12 * 24 + 3 * 24 * 48
                  + 2 * (4 * 6 * 6 + 7 * 12 * 12 + 3 * 24 * 24)) + 48 * 256


def _span(name, start, end, frames=0, thread=7, i=[0]):
    i[0] += 1
    return timing.SpanRecord(i[0], 0, 0, name, thread, round(start * NS),
                             round(end * NS), frames, None)


def _call(start, walk_ms, frames_out=True, fallback=0, thread=7):
    """One `api.decode_sample` call of 100 ms from `start`: its GOP spans
    and counters, the walk taking `walk_ms`; without `frames_out` it
    raises after its group decode and delivers no frame."""
    walk = start + 0.01 + walk_ms / 1e3
    ss = [_span("api.decode_sample", start, start + 0.1, 1, thread),
          _span("gop.decode_batch_device_to", start + 0.01, start + 0.09,
                1, thread),
          _span("gop.decode_rows_host", start + 0.01, walk, 1, thread),
          _span("gop.upload_rows", walk, walk + 0.001, 0, thread),
          _span("gop.decode_coefficients", start + 0.03, start + 0.06, 1,
                thread),
          _span("gop.inverse_to", start + 0.06, start + 0.08, 1, thread)]
    at = round((start + 0.09) * NS)
    cs = [timing.CountEvent("gop.group_decodes", thread, at, 1),
          timing.CountEvent("gop.fallback_groups", thread, at, fallback)]
    if frames_out:
        cs.append(timing.CountEvent("gop.frames_out", thread,
                                    round((start + 0.095) * NS), 1))
    return ss, cs


def _snapshot(dropped=0, lost_until=-1, gop=True):
    """Host window [10, 11]: a call cut by its start, three calls wholly
    in it (walks of 6, 8 and 10 ms; the second falls back; the third
    delivers no frame), a call on another thread (walk 4 ms), and a call
    cut by its end.  Profiled window [20, 20.3]: a call cut by its start
    (its inverse lies in the window), two calls wholly in it, and a call
    cut by its end.  `gop` False: the
    spans of a program before the GOP spans, `api.decode_sample` alone."""
    calls = [_call(9.95, 50), _call(10.1, 6), _call(10.3, 8, fallback=1),
             _call(10.5, 10, frames_out=False), _call(10.6, 4, thread=8),
             _call(10.95, 50), _call(19.95, 0), _call(20.05, 0),
             _call(20.15, 0), _call(20.25, 0)]
    ss = [s for c, _ in calls for s in c]
    cs = sorted((e for _, c in calls for e in c), key=lambda e: e.time)
    if not gop:
        ss = [s for s in ss if s.name == "api.decode_sample"]
        cs = []
    return timing.Snapshot(ss, cs, dropped, lost_until, {})


def _trace():
    """The profiled sub-window [20.0, 20.3] and kernels launched on thread
    7 in each call's spans: in `gop.decode_coefficients` one of 20 ms, in
    `gop.inverse_to` two of 2 and 3 ms, with the cut calls' kernels too;
    a kernel of another thread inside a call's inverse."""
    k = trace.Kernel
    ks = []
    for t in (19.95, 20.05, 20.15, 20.25):
        ks += [k("decode", t + 0.035, 0.02, 7, t + 0.031),
               k("inverse_a", t + 0.062, 0.002, 7, t + 0.061),
               k("inverse_b", t + 0.065, 0.003, 7, t + 0.062)]
    ks.append(k("other", 20.07, 0.001, 9, 20.065))
    return trace.Trace(20.0, 20.3, kernels=ks, device=[])


def _ctx():
    return SimpleNamespace(start=10.0, quiet_end=11.0, trace=_trace(),
                           cfg={"width": 96, "height": 48},
                           mix={"output": "V210"})


def _read(name, ctx):
    return plugins.find(ROOT, "metrics", name).read(ctx)


#: each reader's value, worked by hand from `_snapshot` and `_trace`
WANT = {
    # the two calls wholly in [20, 20.3]: 20 ms each, over 2 frames
    "gop_entropy_device_ms": 20.0,
    # 2 + 3 ms each, over 2 frames
    "gop_inverse_device_ms": 5.0,
    # a frame's bytes at the peak over 5 ms
    "gop_inverse_roofline": 100 * V210_BYTES / 3.35e12 / 5e-3,
    # walks of 6 + 8 + 10 ms on thread 7 and 4 on thread 8, over the 4
    # calls wholly in [10, 11]
    "gop_walk_host_ms": 28 / 4,
    # 5 group decodes over 4 frames delivered: the counters of the call
    # cut by the window's start lie in it (they come at its end), those
    # of the call cut by its end do not; the fourth call delivered none,
    # and the call of thread 8 counts as any other
    "gop_group_decodes_per_frame": 5 / 4,
    # 1 of those 5 groups fell back
    "gop_fallback_pct": 20.0,
}


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_the_worked_value(monkeypatch, name):
    monkeypatch.setattr(program, "snapshot", _snapshot)
    assert _read(name, _ctx()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_none_without_gop_spans(monkeypatch, name):
    # a program with the tracer and `api.decode_sample`, but no GOP spans
    # or counters: the parent of the GOP spans
    monkeypatch.setattr(program, "snapshot", lambda: _snapshot(gop=False))
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_none_without_a_tracer(monkeypatch, name):
    monkeypatch.setattr(program, "timing", SimpleNamespace())  # older port
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_none_where_the_ring_lost_the_window(monkeypatch, name):
    # the newest record lost ended in the profiled window, after the host
    # window's start
    monkeypatch.setattr(program, "snapshot",
                        lambda: _snapshot(dropped=3, lost_until=20 * NS + 1))
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_a_window_after_what_the_ring_lost(monkeypatch, name):
    monkeypatch.setattr(program, "snapshot",
                        lambda: _snapshot(dropped=3, lost_until=9 * NS))
    assert _read(name, _ctx()) == pytest.approx(WANT[name])


def test_one_frame_a_call_reads_one_group_decode_a_frame(monkeypatch):
    # every call delivers its frame, as in the cell: B21's 1.0
    def snap():
        s = _snapshot()
        counts = s.counts + [timing.CountEvent(
            "gop.frames_out", 7, round(10.595 * NS), 1)]
        return s._replace(counts=sorted(counts, key=lambda e: e.time))
    monkeypatch.setattr(program, "snapshot", snap)
    assert _read("gop_group_decodes_per_frame", _ctx()) == 1.0
