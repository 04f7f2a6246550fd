"""The benchmark's arithmetic: percentiles, the device's busy
union, the attribution of kernels to the spans that launched them, the
idle gaps' labels and the roofline share."""

import json
import math

import pytest

from cfbench import roofline, spans, stats, trace


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 100) == 100
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    # a failed call lies beyond any limit
    assert math.isinf(stats.percentile([1.0] * 19 + [math.inf] * 2, 95))
    assert stats.percentile([1.0] * 19 + [math.inf], 95) == 1.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_and_self_time():
    assert spans.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert spans.union_seconds([]) == 0
    outer = [spans.Span("api", 1, 0.0, 10.0, 1)]
    inner = [spans.Span("intra", 1, 1.0, 4.0, 1),
             spans.Span("intra", 1, 3.0, 6.0, 1),
             spans.Span("intra", 2, 0.0, 10.0, 1)]     # another thread
    assert spans.self_seconds(outer, inner) == pytest.approx(5.0)


def test_host_ms_per_frame_counts_nested_calls_once():
    ss = [spans.Span("rows", 1, 1.0, 1.010, 4),
          spans.Span("walk", 1, 1.001, 1.002, 1),       # inside rows
          spans.Span("walk", 2, 2.0, 2.002, 1)]
    got = spans.host_ms_per_frame(ss, ("rows", "walk"), 0, 5, "rows")
    assert got == pytest.approx((10 + 2) / 4)
    assert spans.host_ms_per_frame(ss, ("rows",), 3, 5, "rows") is None


def _trace_file(tmp_path, start_ts=1_000_000.0):
    """A Chrome trace: window marks 100 ms apart; two kernels launched on
    thread 7, one on thread 8, a copy, and an idle gap."""
    ev = [
        {"cat": "user_annotation", "name": "cfbench.window_start",
         "ts": start_ts, "dur": 1},
        {"cat": "user_annotation", "name": "cfbench.window_end",
         "ts": start_ts + 100_000, "dur": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 7,
         "ts": start_ts + 1_000, "dur": 5, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "void place_tgt_kernel(int)",
         "ts": start_ts + 2_000, "dur": 10_000, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 8,
         "ts": start_ts + 30_000, "dur": 5, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "void other(int)",
         "ts": start_ts + 30_000, "dur": 20_000, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 7,
         "ts": start_ts + 60_000, "dur": 5, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "void guarded_network_kernel<true>(int)",
         "ts": start_ts + 60_000, "dur": 5_000, "args": {"correlation": 3}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": start_ts + 40_000, "dur": 20_000},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_trace_busy_attribution_and_gaps(tmp_path):
    host0 = 50.0
    tr = trace.load(_trace_file(tmp_path), host0)
    assert tr.seconds == pytest.approx(0.1)
    # busy: [2, 12] ms, [30, 60] ms (kernel and copy), [60, 65] ms
    assert tr.busy_seconds() == pytest.approx(0.045)
    assert trace.idle_pct(tr) == pytest.approx(55.0)
    assert tr.launches_found == 3
    sp = [spans.Span("merge.tgt", 7, host0 + 0.0005, host0 + 0.0015, 2),
          spans.Span("merge.tgt", 7, host0 + 0.059, host0 + 0.061, 2),
          spans.Span("other", 8, host0 + 0.025, host0 + 0.035, 1)]
    got = trace.launched_in(tr, [s for s in sp if s.name == "merge.tgt"])
    assert [k.name for k in got] == ["void place_tgt_kernel(int)",
                                     "void guarded_network_kernel<true>(int)"]
    # 15 ms of kernels over 4 frames
    assert trace.device_ms_per_frame(tr, sp, "merge.tgt") == \
        pytest.approx(15 / 4)
    ops = dict(trace.top_device_ops(tr))
    assert ops["void other(int)"] == pytest.approx(0.02)
    gaps = dict(trace.idle_gaps(tr, sp))
    # idle [0, 2] ms (middle 1 ms, inside the first merge.tgt span),
    # [12, 30] (middle 21 ms, before "other" begins) and [65, 100]
    assert gaps == pytest.approx({"merge.tgt": 0.002, "no span": 0.053})


def test_roofline_share(tmp_path):
    tr = trace.load(_trace_file(tmp_path), 0.0)

    class Ctx:
        pass

    ctx = Ctx()
    ctx.trace = tr
    # two calls in the sub-window, each of placement and network: one
    # call's kernels are in the trace (10 ms and 5 ms); 7.5 ms a call at
    # the peak
    nbytes = int(roofline.PEAK_BYTES_PER_S * 0.0075)
    ctx.call_bytes = [("merge.tgt", 7, 0.0005, 0.0015, nbytes),
                      ("merge.tgt", 7, 0.059, 0.061, nbytes),
                      ("merge.tgt", 7, 0.2, 0.3, nbytes)]   # past the end
    got = roofline.kernel_share(ctx, ("merge.tgt",), (
        "place_tgt_kernel", "guarded_network"), 2)
    assert got == pytest.approx(100 * 7.5 / 15, rel=1e-6)
    assert roofline.kernel_share(ctx, ("merge.tgt",), ("nothing",), 2) is None
    ctx.call_bytes = []
    assert roofline.kernel_share(ctx, ("merge.tgt",), ("place",), 2) is None
    assert roofline.share_pct(0, 1.0) is None
    assert roofline.share_pct(10, 0.0) is None


def test_trace_names_a_thread_it_does_not_know_by_its_cut_pthread_id():
    # as seen on the card: a worker thread, native id 131, whose
    # threading.get_ident() is 140191624853184, launches under tid
    # 402655552 in the trace
    assert 402655552 in trace.trace_tids(131, 140191624853184)
    assert 131 in trace.trace_tids(131, 140191624853184)


def test_check_covers_every_client_and_slot():
    from cfbench import check
    from cfbench.drive import Record

    recs = [Record(c, k, k, 0.0, 1.0, True, output=b"x")
            for c in range(3) for k in range(0, 200, 3)]
    got = check.choose(recs, 0.0, 2.0, 24, 2**31 + 7, slots=8)
    assert len(got) == 24
    assert {(r.client, r.k % 8) for r in got} == \
        {(c, s) for c in range(3) for s in range(8)}
    assert got == check.choose(recs, 0.0, 2.0, 24, 2**31 + 7, slots=8)
    # fewer than the classes: each taken from another class
    few = check.choose(recs, 0.0, 2.0, 5, 3, slots=8)
    assert len({(r.client, r.k % 8) for r in few}) == 5
    # outside the window: not chosen
    assert check.choose(recs, 1.5, 2.0, 5, 3) == []


def test_kept_requests_take_every_slot():
    """One kept request in each block of `keep_every`, at a seeded place:
    over a run's blocks the kept ones fall in every batch slot."""
    import torch

    from cfbench import drive

    class Idle(drive.Load):
        pass

    load = Idle({}, {"keep_every": 16, "clients": 2}, [0] * 4, None,
                torch.device("cpu"), 2**31 + 1)
    for c in range(2):
        kept = [k for k in range(16 * 64) if load.kept(c, k)]
        assert len(kept) == 64
        assert all(kept[i] // 16 == i for i in range(64))
        assert {k % 8 for k in kept} == set(range(8))
