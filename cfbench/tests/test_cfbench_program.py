"""The readers of the program's spans and counters (`cfbench/program.py`
and the seven metrics that use it) on synthetic records of the port's
tracer and a synthetic `trace.Trace`, against values worked by hand; none
where the program has no tracer or its ring lost records of the window."""

import importlib
from types import SimpleNamespace

import pytest

from cfbench import plugins, program, trace
from cfbench.tests.conftest import ROOT
from cineform_tpu_torch.utils import timing

NEW = ("encode_reencode_ms", "encode_overflow_band_pct",
       "entropy_transfers_device_ms", "entropy_scan_device_ms",
       "demosaic_host_ms", "device_idle_unspanned_pct.encode",
       "device_idle_unspanned_pct.decode")
#: a thread's `threading.get_ident()`, which the profiler may cut to 32 bits
IDENT = 0x7F00_1234_5678
NS = 1_000_000_000


def _span(name, thread, start, end, frames=0, i=[0]):
    i[0] += 1
    return timing.SpanRecord(i[0], 0, 0, name, thread, round(start * NS),
                             round(end * NS), frames, None)


def _count(name, at, n):
    return timing.CountEvent(name, 1, round(at * NS), n)


def _snapshot(dropped=0, lost_until=-1):
    """The encode's host tail on two threads and the decoder's spans on
    thread 7, with a stray `entropy.chunk_transfers` span outside any
    `intra.decode_coefficients`; the band counters, one event each a
    batch, the last after the window."""
    ss = [
        _span("intra.write_samples", 1, 10.1, 10.3, 8),
        _span("intra.reencode", 1, 10.15, 10.16),
        _span("intra.reencode", 1, 10.155, 10.165),    # overlaps: once
        _span("intra.reencode", 1, 10.2, 10.21),
        _span("intra.write_samples", 2, 11.0, 11.2, 8),
        _span("intra.reencode", 2, 11.05, 11.06),
        _span("intra.write_samples", 1, 12.5, 12.6, 8),  # after quiet_end
        _span("intra.reencode", 1, 12.51, 12.52),
        _span("intra.inverse_bayer_rgb", 7, 10.0, 10.05, 1),
        _span("intra.inverse_bayer_rgb", 7, 10.2, 10.23, 1),
        _span("intra.inverse_bayer_rgb", 7, 12.5, 12.6, 1),
        _span("api.decode_sample", 7, 19.99, 20.035, 1),
        _span("intra.decode_coefficients", 7, 20.001, 20.03, 1),
        _span("entropy.chunk_transfers", 7, 20.002, 20.01),
        _span("entropy.scan_entries_rows", 7, 20.01, 20.02),
        _span("entropy.chunk_transfers", 7, 20.092, 20.095),
    ]
    counts = [_count("intra.bands_coded", 10.3, 216),
              _count("intra.bands_overflowed", 10.3, 60),
              _count("intra.bands_coded", 11.2, 216),
              _count("intra.bands_overflowed", 11.2, 54),
              _count("intra.bands_coded", 12.6, 216),
              _count("intra.bands_overflowed", 12.6, 100)]
    return timing.Snapshot(ss, counts, dropped, lost_until, {7: IDENT})


def _trace():
    """The profiled sub-window [20.0, 20.1]: busy [20.00, 20.01], [20.03,
    20.04] and [20.09, 20.1]; kernels launched on thread 7, one of them
    named by the thread's cut `pthread_self()`."""
    k = trace.Kernel
    return trace.Trace(20.0, 20.1, kernels=[
        k("transfers_a", 20.004, 0.003, 7, 20.003),
        k("transfers_b", 20.007, 0.002, IDENT & 0xFFFFFFFF, 20.005),
        k("scan", 20.03, 0.004, 7, 20.015),
        k("stray", 20.095, 0.001, 7, 20.093),
        k("other", 20.0, 0.001, 9, 20.003),
    ], device=[(20.0, 20.01, "a"), (20.03, 20.04, "b"), (20.09, 20.1, "c")])


def _ctx():
    return SimpleNamespace(start=10.0, quiet_end=12.0, trace=_trace())


def _read(name, ctx):
    return plugins.find(ROOT, "metrics", name).read(ctx)


#: each reader's value, worked by hand from `_snapshot` and `_trace`
WANT = {
    # thread 1: [10.15, 10.165] + [10.2, 10.21] = 25 ms, thread 2 10 ms;
    # 16 frames of write_samples in [10, 12]
    "encode_reencode_ms": 35 / 16,
    # (60 + 54) of (216 + 216) bands
    "encode_overflow_band_pct": 100 * 114 / 432,
    # 3 + 2 ms launched in the transfers span inside decode_coefficients
    # (the stray span's kernel is not), over its one frame
    "entropy_transfers_device_ms": 5.0,
    "entropy_scan_device_ms": 4.0,
    # (50 + 30) ms over 2 frames
    "demosaic_host_ms": 40.0,
    # idle gaps [20.01, 20.03] (its middle in api.decode_sample) and
    # [20.04, 20.09] (in no span): 50 of 70 ms
    "device_idle_unspanned_pct.encode": 100 * 50 / 70,
    "device_idle_unspanned_pct.decode": 100 * 50 / 70,
}


def test_importing_turns_the_tracer_on():
    timing.disable()
    importlib.reload(program)
    assert timing.active()


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_the_worked_value(monkeypatch, name):
    monkeypatch.setattr(program, "snapshot", _snapshot)
    assert _read(name, _ctx()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_none_without_a_tracer(monkeypatch, name):
    monkeypatch.setattr(program, "timing", SimpleNamespace())  # older port
    assert program.snapshot() is None
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_none_where_the_ring_lost_the_window(monkeypatch, name):
    # the newest record lost ended in the window: the host windows start
    # at 10 s, the profiled one at 20 s
    monkeypatch.setattr(program, "snapshot",
                        lambda: _snapshot(dropped=3, lost_until=20 * NS + 1))
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_a_window_after_what_the_ring_lost(monkeypatch, name):
    monkeypatch.setattr(program, "snapshot",
                        lambda: _snapshot(dropped=3, lost_until=9 * NS))
    assert _read(name, _ctx()) == pytest.approx(WANT[name])


def test_kernels_take_the_native_id_of_a_cut_thread_id(monkeypatch):
    monkeypatch.setattr(program, "snapshot", _snapshot)
    tr = _trace()
    got = program.program_trace(tr)
    assert [k.launch_thread for k in got.kernels] == [7, 7, 7, 7, 9]
    assert tr.kernels[1].launch_thread == IDENT & 0xFFFFFFFF   # a copy


def test_readers_without_a_trace_or_spans(monkeypatch):
    monkeypatch.setattr(program, "snapshot", _snapshot)
    ctx = SimpleNamespace(start=30.0, quiet_end=31.0, trace=None)
    for name in NEW:
        assert _read(name, ctx) is None
