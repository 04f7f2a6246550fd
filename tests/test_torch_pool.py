"""The port's pools (`cineform_tpu_torch.pool`) on the CPU: in-order
delivery, and samples and frames equal to the port's synchronous API
(which `tests/test_torch_api.py` holds against the JAX API), byte for
byte; the argument errors of the JAX pool; and the thread safety of the
first library build.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from cineform_tpu.models import intra_host as jhost
from cineform_tpu.ref import intra as jref
from cineform_tpu.spec import tags as jtags
from cineform_tpu.spec.production import IntraParams as JParams
from cineform_tpu_torch import api, native, pool
from cineform_tpu_torch.bitstream import fastwalk, parse_sample
from cineform_tpu_torch import testframes as tframes
from cineform_tpu_torch.models.intra import IntraCodec

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 64, 48
FORMATS = list(api.Encoder.CODEC_FORMATS.values())


def overflow_sample(w: int = W, h: int = H) -> bytes:
    """A YUY2 sample whose coarsest luma band holds four times the band's
    coefficients: the device decoder's overflow flag sends it to the
    host-entropy route."""
    frame = tframes.yuy2_frame(w, h, 1)
    params = JParams(width=w, height=h, quality=4)
    planes = jref.unpack_yuy2(frame, w, h, params.precision)
    chans = [jhost.transform_channel(p, params, c)
             for c, p in enumerate(planes)]
    coarse = chans[0].bands[2][0]
    oversize = np.ones((coarse.shape[0] * 4, coarse.shape[1]), np.int32)
    chans[0].payloads = [None, None,
                         (jhost.encode_band_payload(oversize), None, None)]
    return jhost.write_sample(chans, params, 1, jhost.EncoderMetadata(),
                              input_format=jtags.COLOR_FORMAT_YUYV)


def _frames(fmt: str, n: int) -> list[bytes]:
    """n seeded frames of `fmt` at W x H."""
    rb = IntraCodec(W, H, 4, device=CPU, input_format=fmt).row_bytes
    rng = np.random.default_rng(len(fmt) * 7 + n)
    return [rng.integers(0, 256, H * rb, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _sync(fmt: str, frames, flags=0) -> list[bytes]:
    enc = api.Encoder("cpu")
    enc.prepare_to_encode(W, H, api.PixelFormat[fmt],
                          encoding_flags=api.EncodingFlags(flags))
    out = []
    for f in frames:
        enc.encode_sample(f)
        out.append(enc.get_sample_data())
    return out


def _pool_encode(fmt, frames, queue_length=8, flags=0, harvest_every=3):
    """Submit the frames, harvesting one in every `harvest_every`; ->
    (the harvested buffers in order, the pool)."""
    p = api.CFHD_CreateEncoderPool(2, queue_length, device="cpu")
    p.prepare_to_encode(W, H, api.PixelFormat[fmt],
                        encoding_flags=api.EncodingFlags(flags))
    p.start()
    out = []
    for i, f in enumerate(frames):
        p.encode_async_sample(i + 1, f)
        if i % harvest_every == harvest_every - 1:
            out.append(p.wait_for_sample(timeout=120))
    while len(out) < len(frames):
        buf = p.test_for_sample()
        out.append(buf if buf is not None else p.wait_for_sample(timeout=120))
    p.stop()
    return out, p


class _HoldFirstCall:
    """A pool's codec whose first call of `name` waits for `release`;
    `entered` is set when that call has begun."""

    def __init__(self, codec, name: str) -> None:
        self._codec, self._name = codec, name
        self.entered, self.release = threading.Event(), threading.Event()

    def __getattr__(self, attr):
        real = getattr(self._codec, attr)
        if attr != self._name:
            return real

        def held(*args, **kw):
            if not self.entered.is_set():
                self.entered.set()
                self.release.wait(timeout=120)
            return real(*args, **kw)
        return held


def _held_encode(fmt, frames, lead=1, flags=0):
    """Submit the first `lead` frames, hold the batch they start, queue
    the rest behind it, then release and harvest; -> (the buffers in
    order, the pool)."""
    gop = bool(flags & api.EncodingFlags.YUV_2FRAME_GOP)
    p = api.CFHD_CreateEncoderPool(1, len(frames), device="cpu")
    p.prepare_to_encode(W, H, api.PixelFormat[fmt],
                        encoding_flags=api.EncodingFlags(flags))
    p._codec = held = _HoldFirstCall(
        p._codec, "encode_batch" if gop else "encode_batch_device")
    p.start()
    for i, f in enumerate(frames):
        if i == lead:
            assert held.entered.wait(timeout=120)
        p.encode_async_sample(i + 1, f)
    held.release.set()
    out = [p.wait_for_sample(timeout=120) for _ in frames]
    p.stop()
    return out, p


# ---------------------------------------------------------------------------
# EncoderPool
# ---------------------------------------------------------------------------

def test_encoder_pool_in_order_and_equal_to_sync():
    """12 frames through a queue of 6, harvested as they go: in
    submission order, each the sync Encoder's sample (frame numbers and
    metadata advanced per frame)."""
    frames = [tframes.yuy2_frame(W, H, p) for p in range(12)]
    out, p = _pool_encode("YUY2", frames, queue_length=6)
    assert [b.frame_number for b in out] == list(range(1, 13))
    assert [b.get_encoded_sample() for b in out] == _sync("YUY2", frames)


def test_encoder_pool_batches_of_eight():
    """The batcher takes what is queued, up to 8 jobs: a frame submitted
    alone goes as a batch of 1, and the 32 queued behind that batch go as
    4 batches of 8."""
    frames = _frames("YUY2", 33)
    out, p = _held_encode("YUY2", frames)
    assert [b.get_encoded_sample() for b in out] == _sync("YUY2", frames)
    assert p.batches == [1, 8, 8, 8, 8]


@pytest.mark.parametrize("fmt", FORMATS)
def test_encoder_pool_formats_equal_sync(fmt):
    frames = _frames(fmt, 3)
    out, _ = _pool_encode(fmt, frames)
    assert [b.get_encoded_sample() for b in out] == _sync(fmt, frames)


@pytest.mark.parametrize("fmt", FORMATS)
def test_encoder_pool_formats_batch_behind_a_running_one(fmt):
    """Every format's frames stack into one codec call: two frames queued
    behind a running batch of one go as a batch of 2, each sample the
    sync Encoder's."""
    frames = _frames(fmt, 3)
    out, p = _held_encode(fmt, frames)
    assert [b.get_encoded_sample() for b in out] == _sync(fmt, frames)
    assert p.batches == [1, 2]


def test_encoder_pool_gop_pairs_equal_sync():
    """2-frame GOP: the batcher pairs consecutive submissions; the header
    samples come at once, the first pair's GROUP sample alone and the two
    pairs queued behind it in one batch."""
    frames = [tframes.yuy2_frame(W, H, p) for p in range(6)]
    gop = int(api.EncodingFlags.YUV_2FRAME_GOP)
    out, p = _held_encode("YUY2", frames, lead=2, flags=gop)
    assert [b.frame_number for b in out] == list(range(1, 7))
    assert [b.get_encoded_sample() for b in out] == _sync("YUY2", frames,
                                                          gop)
    assert p.batches == [1, 2]


def test_encoder_pool_host_workers_not_ported():
    """The JAX pool's host worker pool (`use_device=False`) raises."""
    p = api.CFHD_CreateEncoderPool(2, 2, device="cpu")
    with pytest.raises(api.CFHDError) as e:
        p.prepare_to_encode(W, H, api.PixelFormat.YUY2, use_device=False)
    assert e.value.code == api.ErrorCode.BADFORMAT
    assert "not ported yet" in str(e.value)


def test_encoder_pool_wait_blocks_for_the_next_submission():
    p = api.CFHD_CreateEncoderPool(1, 2, device="cpu")
    p.prepare_to_encode(W, H, api.PixelFormat.YUY2)
    p.start()
    result = []
    waiter = threading.Thread(
        target=lambda: result.append(p.wait_for_sample(timeout=120)))
    waiter.start()
    time.sleep(0.2)
    p.encode_async_sample(1, tframes.yuy2_frame(W, H, 1))
    waiter.join(timeout=120)
    assert result and result[0].frame_number == 1
    with pytest.raises(api.CFHDError) as e:
        p.wait_for_sample(timeout=0.1)
    assert e.value.code == api.ErrorCode.THREAD_WAIT_FAILED
    p.stop()


ARGUMENT_ERRORS = {
    "no-threads": lambda: api.CFHD_CreateEncoderPool(0, 4, device="cpu"),
    "no-queue": lambda: api.CFHD_CreateEncoderPool(2, 0, device="cpu"),
    "start-unprepared": lambda: api.CFHD_CreateEncoderPool(
        2, 2, device="cpu").start(),
    "submit-unstarted": lambda: api.CFHD_CreateEncoderPool(
        2, 2, device="cpu").encode_async_sample(1, b""),
    "gop-workers": lambda: api.CFHD_CreateEncoderPool(
        2, 2, device="cpu").prepare_to_encode(
            W, H, api.PixelFormat.YUY2,
            encoding_flags=api.EncodingFlags.YUV_2FRAME_GOP,
            use_device=False),
    "decoder-no-queue": lambda: pool.DecoderPool(2, 0, device="cpu"),
    "decoder-start-unprepared": lambda: pool.DecoderPool(
        device="cpu").start(),
    "decoder-submit-unstarted": lambda: pool.DecoderPool(
        device="cpu").decode_async_sample(1, b""),
    "decoder-output": lambda: pool.DecoderPool(
        device="cpu").prepare_to_decode(W, H, api.PixelFormat.RG48),
}


@pytest.mark.parametrize("case", list(ARGUMENT_ERRORS))
def test_pool_argument_validation(case):
    with pytest.raises(api.CFHDError):
        ARGUMENT_ERRORS[case]()


# ---------------------------------------------------------------------------
# DecoderPool
# ---------------------------------------------------------------------------

def _pool_decode(samples, output, queue_length=4):
    p = pool.DecoderPool(2, queue_length, device="cpu")
    p.prepare_to_decode(W, H, api.PixelFormat[output])
    p.start()
    out = []
    for i, s in enumerate(samples):
        p.decode_async_sample(i + 1, s)
        if i % 3 == 2:
            out.append(p.wait_for_frame(timeout=120))
    while len(out) < len(samples):
        buf = p.test_for_frame()
        out.append(buf if buf is not None else p.wait_for_frame(timeout=120))
    p.stop()
    return out, p


@pytest.mark.parametrize("output", ["YUY2", "BGRA"])
def test_decoder_pool_in_order_and_equal_to_sync(output):
    """11 samples, two of them overflowing the device decoder, through a
    queue of 4: in order, each the sync route's frame (YUY2: the sync
    Decoder's; BGRA: `decode_batch_device(output="BGRA")`), the two
    counted as fallback frames."""
    samples = _sync("YUY2", _frames("YUY2", 11))
    samples[4] = samples[9] = overflow_sample()
    out, p = _pool_decode(samples, output)
    assert [b.frame_number for b in out] == list(range(1, 12))
    assert p.fallback_frames == 2
    if output == "YUY2":
        dec = api.Decoder("cpu")
        dec.prepare_to_decode(W, H)
        want = [dec.decode_sample(s) for s in samples]
    else:
        want, fallback = IntraCodec(W, H, 4, device=CPU).decode_batch_device(
            samples, output="BGRA")
        assert fallback == (4, 9)
    for b, w in zip(out, want):
        assert b.data.tobytes() == w.tobytes()


def test_decoder_pool_batches_of_eight():
    """A sample submitted alone goes as a batch of 1, the 16 queued behind
    its parse as 2 batches of 8."""
    samples = _sync("YUY2", _frames("YUY2", 17))
    p = pool.DecoderPool(2, 17, device="cpu")
    p.prepare_to_decode(W, H)
    p._codec = held = _HoldFirstCall(p._codec, "_decode_rows_host")
    p.start()
    p.decode_async_sample(0, samples[0])
    assert held.entered.wait(timeout=120)
    for i, s in enumerate(samples[1:], 1):
        p.decode_async_sample(i, s)
    held.release.set()
    got = [p.wait_for_frame(timeout=120) for _ in samples]
    p.stop()
    want, fallback = IntraCodec(W, H, 4, device=CPU).decode_batch_device(
        samples)
    assert fallback == () and p.fallback_frames == 0
    assert [b.data.tobytes() for b in got] == [w.tobytes() for w in want]
    assert p.batches == [1, 8, 8]


def test_decoder_pool_refuses_the_bgra_samples_the_decoder_refuses():
    """Two 144x48 UYVY frames (chroma lowpass width 9, odd): `api.Decoder`
    refuses them to BGRA, and so does the pool, each job with BADFORMAT
    from its future; the same samples to YUY2 decode, equal to the sync
    Decoder.  In a batch that mixes such a sample with a 64-wide one, only
    the first job fails."""
    frames = np.random.default_rng(144).integers(0, 256, (2, 48, 288))
    samples = IntraCodec(144, 48, 4, device=CPU,
                         input_format="UYVY").encode_batch(
        frames.astype(np.uint8))
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(144, 48, api.PixelFormat.BGRA)
    with pytest.raises(api.CFHDError) as e:
        dec.decode_sample(samples[0])
    assert e.value.code == api.ErrorCode.BADFORMAT
    for output in ("BGRA", "YUY2"):
        p = pool.DecoderPool(2, 4, device="cpu")
        p.prepare_to_decode(144, 48, api.PixelFormat[output])
        p.start()
        for i, s in enumerate(samples):
            p.decode_async_sample(i + 1, s)
        for s in samples:
            if output == "BGRA":
                with pytest.raises(api.CFHDError) as e:
                    p.wait_for_frame(timeout=120)
                assert e.value.code == api.ErrorCode.BADFORMAT
            else:
                dec = api.Decoder("cpu")
                dec.prepare_to_decode(144, 48)
                assert p.wait_for_frame(timeout=120).data.tobytes() == \
                    dec.decode_sample(s).tobytes()
        p.stop()
        assert p.fallback_frames == 0
    jobs = [pool._Job(1, (samples[0],), None, pool.Future()),
            pool._Job(2, (_sync("YUY2", _frames("YUY2", 1))[0],), None,
                      pool.Future())]
    walks = [fastwalk.walk(j.frames[0]) for j in jobs]
    assert walks[0].lowpass_w[-1] == parse_sample(
        samples[0]).channels[-1].lowpass_width == 9
    assert pool.DecoderPool._refuse_bgra(jobs, walks) == (jobs[1:],
                                                          walks[1:])
    assert isinstance(jobs[0].future.exception(), api.CFHDError)
    assert not jobs[1].future.done()


# ---------------------------------------------------------------------------
# The first build from two threads
# ---------------------------------------------------------------------------

def test_library_built_once_from_two_threads(tmp_path, monkeypatch):
    """Two threads that need the same host library at once: one g++ run,
    one library, the same path for both."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    runs = []
    real_run = native.subprocess.run

    def counting_run(*args, **kw):
        runs.append(args)
        time.sleep(0.5)             # hold the build open for the other
        return real_run(*args, **kw)

    monkeypatch.setattr(native.subprocess, "run", counting_run)
    start = threading.Barrier(2)
    paths = []

    def build():
        start.wait()
        paths.append(native.library_path("entropy"))

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(runs) == 1
    assert len(set(paths)) == 1 and len(paths) == 2
    assert [f for f in os.listdir(tmp_path) if f.endswith(".so")] == \
        [os.path.basename(paths[0])]
