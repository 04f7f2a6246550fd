"""The port's tracer (`cineform_tpu_torch.utils.timing`) on the CPU: off by
default and recording nothing; on, the spans of a small YUY2 batch encode
and of BYR4 decodes and a GOP group's GROUP and FRAME samples through
`api.Decoder`, nested by parent id under one request id a call; the band
counters against `forward_packed`'s overflow flags; the GOP counters; the
ring's bound and its `dropped` count; and the same samples and frames
with the tracer on and off."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from cineform_tpu_torch import api, testframes
from cineform_tpu_torch.models import gop_host
from cineform_tpu_torch.models.gop import GopCodec
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.utils import timing

CPU = torch.device("cpu")
#: cap_bits 4 overflows some of the pattern's bands, so the host re-encodes
CAP_BITS = 4


@pytest.fixture
def tracer():
    """The tracer, on with an empty ring; off and empty afterwards."""
    timing.enable()
    try:
        yield timing
    finally:
        timing.disable()
        timing.reset()


def _yuy2(w=128, h=64, n=2) -> np.ndarray:
    base = np.frombuffer(testframes.yuy2_frame(w, h, 1), np.uint8).reshape(
        h, 2 * w)
    return np.stack([np.roll(base, i, axis=0) for i in range(n)])


def _byr4_samples(w=96, h=48, n=2) -> list[bytes]:
    codec = api.intra_codec(w, h, 4, "BYR4", CPU)
    base = np.frombuffer(testframes.byr4_frame(w, h, 1), np.uint8).reshape(
        h, -1)
    frames = np.stack([np.roll(base, 2 * i, axis=0) for i in range(n)])
    return codec.encode_batch_device(frames)


def _decode_rg48(samples, w=96, h=48) -> list[bytes]:
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(w, h, api.PixelFormat.RG48)
    return [dec.decode_sample(s).tobytes() for s in samples]


def _encode(frames):
    return IntraCodec(frames.shape[2] // 2, frames.shape[1], 4,
                      device=CPU).encode_batch_device(frames,
                                                      cap_bits=CAP_BITS)


def _parents(snap) -> dict:
    """span name -> the set of its parents' names (None: no parent)."""
    by_id = {s.id: s for s in snap.spans}
    out: dict = {}
    for s in snap.spans:
        parent = by_id[s.parent].name if s.parent else None
        out.setdefault(s.name, set()).add(parent)
    return out


def test_off_by_default():
    code = ("from cineform_tpu_torch.utils import timing; "
            "assert not timing.active()")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_off_records_nothing_and_shares_one_context():
    timing.disable()
    timing.reset()
    a, b = timing.span("intra.fetch"), timing.span("api.decode_sample", 1,
                                                   root=True)
    assert a is b
    with a as inside:
        assert inside is None
    timing.count("intra.bands_coded", 27)
    _encode(_yuy2(n=1))
    snap = timing.snapshot()
    assert snap.spans == [] and snap.counts == [] and snap.dropped == 0
    assert timing.report().splitlines() == [
        "span,calls,total_ms,mean_ms,min_ms,max_ms"]


ENCODE_NESTING = {
    "intra.encode_batch": {None},
    "intra.upload": {"intra.encode_batch"},
    "intra.forward_packed": {"intra.encode_batch"},
    "intra.write_samples": {"intra.encode_batch"},
    "intra.fetch": {"intra.write_samples"},
    "intra.write_frame": {"intra.write_samples"},
    "intra.reencode": {"intra.write_frame"},
}


def test_encode_spans_nest_and_count_the_overflow_flags(tracer):
    frames = _yuy2()
    codec = IntraCodec(128, 64, 4, device=CPU)
    packed = codec.forward_packed(torch.from_numpy(frames), CAP_BITS)
    flags = [o.numpy() for _, levels in packed for _, _, o, _ in levels]
    tracer.reset()
    codec.encode_batch_device(frames, cap_bits=CAP_BITS)
    snap = tracer.snapshot()
    assert _parents(snap) == ENCODE_NESTING
    names = [s.name for s in snap.spans]
    overflowed = sum(int(f.sum()) for f in flags)
    assert 0 < overflowed < sum(f.size for f in flags)
    assert names.count("intra.reencode") == overflowed
    assert names.count("intra.write_frame") == len(frames)
    assert {s.request for s in snap.spans} == {0}
    batch = next(s for s in snap.spans if s.name == "intra.encode_batch")
    assert batch.frames == len(frames)
    for s in snap.spans:
        assert batch.start <= s.start <= s.end <= batch.end
    counts = {c.name: c.n for c in snap.counts}
    assert len(snap.counts) == 2
    assert counts == {"intra.bands_coded": sum(f.size for f in flags),
                      "intra.bands_overflowed": overflowed}
    report = tracer.report().splitlines()
    assert report[0] == "span,calls,total_ms,mean_ms,min_ms,max_ms"
    assert any(line.startswith(f"intra.reencode,{overflowed},")
               for line in report)
    assert f"counter:intra.bands_overflowed,{overflowed}" in report


def test_pool_batch_carries_its_frame_numbers(tracer):
    frames = _yuy2(n=3)
    pool = api.CFHD_CreateEncoderPool(1, 8, device=CPU)
    pool.prepare_to_encode(128, 64, api.PixelFormat.YUY2,
                           quality=api.EncodingQuality(4))
    pool.start()
    try:
        for i, f in enumerate(frames):
            pool.encode_async_sample(10 + i, f)
        for _ in frames:
            pool.wait_for_sample(timeout=120)
    finally:
        pool.stop()
    snap = tracer.snapshot()
    batches = [s for s in snap.spans if s.name == "pool.batch"]
    assert sorted(n for s in batches for n in s.numbers) == [10, 11, 12]
    assert sum(s.frames for s in batches) == 3
    assert len({s.request for s in batches}) == len(batches) and \
        all(s.request for s in batches)
    parents = _parents(snap)
    assert parents["pool.stack"] == {"pool.batch"}
    assert parents["intra.encode_batch"] == {"pool.batch"}
    by_id = {s.id: s for s in snap.spans}
    for s in snap.spans:          # children inherit the batch's request
        if s.parent:
            assert s.request == by_id[s.parent].request


DECODE_NESTING = {
    "api.decode_sample": {None},
    "api.parse": {"api.decode_sample"},
    "intra.screen": {"api.decode_sample"},
    "intra.decode_batch_device": {"api.decode_sample"},
    "intra.decode_rows_host": {"intra.decode_batch_device"},
    "fastwalk.walk": {"intra.decode_rows_host"},
    "intra.upload_rows": {"intra.decode_batch_device"},
    "intra.decode_coefficients": {"intra.decode_batch_device"},
    **{f"entropy.{stage}": {"intra.decode_coefficients"} for stage in (
        "classify", "chunk_transfers", "scan_entries_rows", "final_walk",
        "emit_slots", "compact_rows", "spread_rows")},
    "intra.inverse_bayer_rgb": {"intra.decode_batch_device"},
    "intra.row16u_planes": {"intra.inverse_bayer_rgb"},
    "demosaic.to_bayer": {"intra.inverse_bayer_rgb"},
    "demosaic.debayer": {"intra.inverse_bayer_rgb"},
    "demosaic.sharpen": {"intra.inverse_bayer_rgb"},
    "intra.download": {"intra.decode_batch_device"},
    "intra.overflow_read": {"intra.decode_batch_device"},
}


def test_byr4_decode_spans_nest_under_one_request_a_call(tracer):
    samples = _byr4_samples()
    tracer.reset()
    _decode_rg48(samples)
    snap = tracer.snapshot()
    assert _parents(snap) == DECODE_NESTING
    roots = [s for s in snap.spans if s.name == "api.decode_sample"]
    assert len(roots) == len(samples)
    assert len({r.request for r in roots}) == len(samples) and \
        all(r.request for r in roots)
    for r in roots:
        inside = [s for s in snap.spans if s.request == r.request]
        assert {s.name for s in inside} == set(DECODE_NESTING)
        assert all(r.start <= s.start <= s.end <= r.end for s in inside)
        # the band decoder's three row classes, each through every stage
        assert sum(s.name == "entropy.chunk_transfers" for s in inside) == 3
    coeffs = [s for s in snap.spans if s.name == "intra.decode_coefficients"]
    assert [s.frames for s in coeffs] == [1, 1]
    assert snap.threads[threading.get_native_id()] == threading.get_ident()
    assert {s.thread for s in snap.spans} == {threading.get_native_id()}


@pytest.mark.parametrize("capacity,spans", [(4, 10), (4, 4), (1, 3)])
def test_ring_keeps_the_newest_and_counts_what_it_dropped(capacity, spans):
    timing.enable(capacity)
    try:
        for i in range(spans):
            with timing.span(f"s{i}", i):
                pass
        timing.count("c", 2)
        snap = timing.snapshot()
        report = timing.report()
    finally:
        timing.disable()
        timing.reset()
    kept = capacity - 1           # the counter event took the last place
    assert [s.name for s in snap.spans] == \
        [f"s{i}" for i in range(spans - kept, spans)]
    assert len(snap.counts) == 1 and snap.counts[0].n == 2
    assert snap.dropped == spans - kept
    lost = [s for s in snap.spans]  # the newest dropped ended before these
    assert snap.lost_until > 0 and all(snap.lost_until <= s.end
                                       for s in lost)
    # the running totals keep what the ring dropped
    assert all(f"s{i},1," in report for i in range(spans))
    assert "counter:c,2" in report


def test_enable_refuses_an_empty_ring():
    with pytest.raises(ValueError, match="ring"):
        timing.enable(0)
    assert not timing.active()


def test_samples_and_frames_equal_with_the_tracer_on_and_off():
    frames = _yuy2()
    off = _encode(frames)
    byr4 = _byr4_samples()
    off_rg48 = _decode_rg48(byr4)
    timing.enable()
    try:
        on = _encode(frames)
        on_rg48 = _decode_rg48(byr4)
        assert timing.snapshot().spans
    finally:
        timing.disable()
        timing.reset()
    assert on == off
    assert on_rg48 == off_rg48


def _gop_group(w=96, h=48) -> tuple[bytes, bytes]:
    """A GROUP sample of two rolled frames and its 24-byte FRAME sample."""
    f = _yuy2(w, h)
    group = api.gop_codec(w, h, 4, CPU).encode_batch(
        f[None, 0], f[None, 1], frame_numbers=[1])[0]
    return group, gop_host.frame_header_sample(w, h, 1)


def _play(samples, fmt=api.PixelFormat.V210, w=96, h=48) -> list[bytes]:
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(w, h, fmt)
    return [dec.decode_sample(s).tobytes() for s in samples]


def _totals(snap) -> dict:
    out: dict = {}
    for c in snap.counts:
        out[c.name] = out.get(c.name, 0) + c.n
    return out


GOP_NESTING = {
    "api.decode_sample": {None},
    "api.parse": {"api.decode_sample"},
    "gop.decode": {"api.decode_sample"},
    "gop.held_frame": {"api.decode_sample"},
    "gop.decode_rows_host": {"gop.decode"},
    "gop.upload_rows": {"gop.decode"},
    "gop.decode_coefficients": {"gop.decode"},
    **{f"entropy.{stage}": {"gop.decode_coefficients"}
       for stage in ("classify", "chunk_transfers", "scan_entries_rows",
                     "final_walk", "emit_slots", "compact_rows",
                     "spread_rows")},
    "gop.inverse_to": {"gop.decode", "gop.held_frame"},
    "intra.download": {"gop.decode", "gop.held_frame"},
}


def test_gop_playback_spans_nest_and_count_a_group_a_frame(tracer):
    """A group's GROUP then FRAME sample to v210: each call one request.
    The GROUP call's `gop.decode` span (a frame) holds the
    walk, the upload, the band decoder at the 6 row classes and the
    inverse; the FRAME call's `gop.held_frame` span (a frame) holds only
    the inverse of the held coefficients and the download.  One group
    decode, two frames out, one of them from the held coefficients."""
    samples = _gop_group()
    tracer.reset()
    _play(samples)
    snap = tracer.snapshot()
    assert _parents(snap) == GOP_NESTING
    roots = [s for s in snap.spans if s.name == "api.decode_sample"]
    assert len(roots) == 2 and len({r.request for r in roots}) == 2
    group, frame = ([s for s in snap.spans if s.request == r.request]
                    for r in roots)
    for r, inside in zip(roots, (group, frame)):
        assert all(r.start <= s.start <= s.end <= r.end for s in inside)
    gop = [s for s in group if s.name.startswith("gop.")]
    assert sorted(s.name for s in gop) == [
        "gop.decode", "gop.decode_coefficients",
        "gop.decode_rows_host", "gop.inverse_to", "gop.upload_rows"]
    assert all(s.frames == 1 for s in gop if s.name != "gop.upload_rows")
    assert sum(s.name == "entropy.chunk_transfers" for s in group) == 6
    assert sorted(s.name for s in frame) == [
        "api.decode_sample", "api.parse", "gop.held_frame", "gop.inverse_to",
        "intra.download"]
    assert all(s.frames == 1 for s in frame if s.name.startswith("gop."))
    # the band decoder's rows, one event each a row class, none by the
    # kernels on the CPU
    rows = sum(len(planes) * len(GopCodec._LEVEL_ENTRIES[lvl])
               for lvl, planes in GopCodec._DECODE_CLASSES)
    assert _totals(snap) == {"gop.group_decodes": 1, "gop.frames_out": 2,
                             "gop.held_frames": 1, "gop.fallback_groups": 0,
                             "entropy.band_rows": rows,
                             "entropy.band_rows_kernel": 0}
    assert [c.name for c in snap.counts].count("entropy.band_rows") == 6
    for c in snap.counts:
        assert any(r.start <= c.time <= r.end and r.thread == c.thread
                   for r in roots)


def test_gop_group_that_falls_back_counts_it(tracer):
    """The interlaced group, whose bands carry peaks, goes to the host
    route: one group decoded, one fallen back, one frame out, made by the
    inverse of the host route's coefficients."""
    path = os.path.join(os.path.dirname(__file__), "golden", "samples",
                        "ilace_320x240_q4_p1.cfhd.f1")
    with open(path, "rb") as f:
        sample = f.read()
    tracer.reset()
    _play([sample], api.PixelFormat.YU64, 320, 240)
    snap = tracer.snapshot()
    assert _totals(snap) == {"gop.group_decodes": 1, "gop.frames_out": 1,
                             "gop.fallback_groups": 1}
    assert [s.frames for s in snap.spans
            if s.name == "gop.decode"] == [1]
    assert [s.frames for s in snap.spans
            if s.name == "gop.inverse_to"] == [1]


def test_off_records_no_gop_span_or_counter():
    samples = _gop_group()
    timing.disable()
    timing.reset()
    off = _play(samples)
    snap = timing.snapshot()
    assert snap.spans == [] and snap.counts == []
    timing.enable()
    try:
        on = _play(samples)
    finally:
        timing.disable()
        timing.reset()
    assert on == off
