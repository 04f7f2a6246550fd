"""Asynchronous encoder and decoder pools on a torch device: the port of
`cineform_tpu.pool`.

Behavioral contract: `EncoderSDK/EncoderPool.cpp:59-449` — submit frames,
harvest samples strictly in submission order through
WaitForSample/TestForSample, with a per-frame metadata snapshot and a
bounded number of jobs in flight.

The reference parallelises frames over CPU threads (SURVEY §2.4).  Here a
batcher thread drains the submission queue and encodes whole batches of
up to `DEVICE_BATCH` frames through the port's codecs on the card
(`IntraCodec.encode_batch_device`, every input format of `api.Encoder`;
progressive 2-frame GOP pairs through `GopCodec.encode_batch`); the host
writes the samples.  Interlaced GOP pairs are refused, as the JAX pool
refuses them.  A batcher takes
whatever is queued, up to `DEVICE_BATCH` jobs, as the JAX pool does; only
the real frames are encoded: a batch of any size is one call of the codec.
The JAX pool's host worker pool (`use_device=False`) is not ported.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from cineform_tpu_torch import api
from cineform_tpu_torch.bitstream import fastwalk, parse_sample
from cineform_tpu_torch.models import gop_host


@dataclass
class SampleBuffer:
    """CFHD_SampleBufferRef equivalent (`EncoderSDK/VideoBuffers.h`)."""

    frame_number: int
    data: bytes

    def get_encoded_sample(self) -> bytes:  # CFHD_GetEncodedSample
        return self.data


@dataclass
class _Job:
    """A queued batch job: `frames` one frame's rows, or a GOP pair's."""

    frame_number: int
    frames: tuple
    metadata: object
    future: Future


class _Batches:
    """The submission bookkeeping both pools share: jobs in flight under a
    bound, harvest in submission order, and the batch queue."""

    DEVICE_BATCH = 8

    def __init__(self, job_queue_length: int) -> None:
        if job_queue_length < 1:
            raise api.CFHDError(api.ErrorCode.INVALID_ARGUMENT)
        self.queue_length = job_queue_length
        self._lock = threading.Condition()
        self._pending: deque[tuple[int, Future]] = deque()
        self._batch_queue: deque[_Job] = deque()
        self._in_flight = 0
        self._stopping = False
        #: the size of each batch taken from the queue, in order
        self.batches: list[int] = []

    def _reserve(self) -> None:
        """Under the lock: wait for room under the queue bound."""
        while self._in_flight >= self.queue_length:
            self._lock.wait()
        self._in_flight += 1

    def _queue(self, frame_number: int, frames: tuple, metadata,
               future: Future) -> None:
        """Under the lock: append a job to the batch queue."""
        self._batch_queue.append(_Job(frame_number, frames, metadata,
                                      future))

    def _job_done(self, _fut: Future) -> None:
        with self._lock:
            self._in_flight -= 1
            self._lock.notify_all()

    def _next_batch(self) -> list[_Job] | None:
        """Block until a job is queued, then take up to `DEVICE_BATCH`;
        None once stopping and drained."""
        with self._lock:
            while not self._batch_queue and not self._stopping:
                self._lock.wait()
            if not self._batch_queue:
                return None
            jobs = [self._batch_queue.popleft() for _ in range(
                min(len(self._batch_queue), self.DEVICE_BATCH))]
            self.batches.append(len(jobs))
            return jobs

    @staticmethod
    def _fail(jobs: list[_Job], exc: BaseException) -> None:
        for j in jobs:
            if not j.future.done():
                j.future.set_exception(exc)

    def _harvest(self, timeout: float | None, block: bool):
        """The next pending (frame_number, future) in submission order;
        None where `block` is False and it is not done."""
        with self._lock:
            while not self._pending:
                if not block:
                    return None
                if not self._lock.wait(timeout=timeout):
                    raise api.CFHDError(api.ErrorCode.THREAD_WAIT_FAILED,
                                        "timed out waiting")
            if not block and not self._pending[0][1].done():
                return None
            head = self._pending.popleft()
            self._lock.notify_all()
            return head


class EncoderPool(_Batches):
    """CFHD_CreateEncoderPool .. CFHD_ReleaseEncoderPool on `device`."""

    def __init__(self, thread_count: int, job_queue_length: int,
                 device: torch.device | str = "cuda") -> None:
        if thread_count < 1:
            raise api.CFHDError(api.ErrorCode.INVALID_ARGUMENT)
        super().__init__(job_queue_length)
        self.device = torch.device(device)
        self._prepared = False
        self._metadata = None
        self._codec = None
        self._batcher: threading.Thread | None = None
        self._gop_first = None
        self._gop_groups = 0

    # CFHD_GetAsyncInputFormats
    def get_input_formats(self) -> tuple[api.PixelFormat, ...]:
        return api.Encoder.INPUT_FORMATS

    # CFHD_PrepareEncoderPool
    def prepare_to_encode(self, width: int, height: int,
                          pixel_format: api.PixelFormat,
                          encoded_format=api.EncodedFormat.YUV_422,
                          encoding_flags=api.EncodingFlags.NONE,
                          quality=api.EncodingQuality.FILMSCAN1,
                          use_device: bool = True) -> None:
        probe = api.Encoder(self.device)  # validates arguments
        probe.prepare_to_encode(width, height, pixel_format, encoded_format,
                                encoding_flags, quality)
        if encoding_flags & api.EncodingFlags.YUV_INTERLACED:
            # the JAX pool refuses it, though its sync Encoder encodes it
            # (`cineform_tpu/pool.py:91-93`)
            raise api.CFHDError(api.ErrorCode.BADFORMAT,
                                "interlaced GOP is not supported in the pool")
        if not use_device:
            # the JAX pool's host worker pool of api.Encoders
            # (`cineform_tpu/pool.py:217-238`)
            raise api.CFHDError(api.ErrorCode.BADFORMAT,
                                "the host worker pool (use_device=False) "
                                "is not ported yet")
        self.gop = bool(encoding_flags & api.EncodingFlags.YUV_2FRAME_GOP)
        self.width, self.height = width, height
        self.row_bytes = probe.row_bytes
        if self.gop:
            self._codec = api.gop_codec(width, height, int(probe.quality),
                                        self.device)
        else:
            self._codec = api.intra_codec(
                width, height, int(probe.quality),
                api.Encoder.CODEC_FORMATS[pixel_format], self.device)
        self._prepared = True

    # CFHD_AttachEncoderPoolMetadata
    def attach_metadata(self, metadata) -> None:
        self._metadata = metadata

    # CFHD_StartEncoderPool
    def start(self) -> None:
        if not self._prepared:
            raise api.CFHDError(api.ErrorCode.ENCODING_NOT_STARTED)
        if self._batcher is None:
            self._stopping = False
            self._batcher = threading.Thread(
                target=self._batch_loop, name="cfhd-device-batcher",
                daemon=True)
            self._batcher.start()

    # CFHD_StopEncoderPool
    def stop(self) -> None:
        if self._batcher is not None:
            with self._lock:
                self._stopping = True
                self._lock.notify_all()
            self._batcher.join()
            self._batcher = None

    # --- device batch path --------------------------------------------------

    def _batch_loop(self) -> None:
        """Drain submissions and encode whole batches on the device."""
        while (jobs := self._next_batch()) is not None:
            try:
                frames = [np.stack(f) for f in zip(*(j.frames for j in jobs))]
                samples = (self._codec.encode_batch if self.gop
                           else self._codec.encode_batch_device)(
                    *frames, frame_numbers=[j.frame_number for j in jobs],
                    metadata=[j.metadata for j in jobs])
                for j, s in zip(jobs, samples):
                    j.future.set_result(s)
            except BaseException as exc:  # propagate to the harvesters
                self._fail(jobs, exc)

    # CFHD_EncodeAsyncSample
    def encode_async_sample(self, frame_number: int,
                            frame: bytes | np.ndarray,
                            metadata=None) -> None:
        if self._batcher is None:
            raise api.CFHDError(api.ErrorCode.ENCODING_NOT_STARTED)
        meta = metadata or self._metadata
        buf = (np.frombuffer(frame, dtype=np.uint8)
               if isinstance(frame, (bytes, bytearray))
               else np.ascontiguousarray(frame).view(np.uint8).reshape(-1))
        if buf.size != self.height * self.row_bytes:
            raise api.CFHDError(api.ErrorCode.INVALID_ARGUMENT,
                                "bad frame size")
        # The queue bound limits jobs in flight (unfinished encodes), not
        # unharvested results (`EncoderSDK/EncoderQueue.h:45-51` job
        # states).  Submit and enqueue under one lock acquisition so the
        # pending order always matches submission order.
        with self._lock:
            self._reserve()
            fut = self._queue_device(
                frame_number, buf.reshape(self.height, self.row_bytes), meta)
            fut.add_done_callback(self._job_done)
            self._pending.append((frame_number, fut))
            self._lock.notify_all()

    def _queue_device(self, frame_number: int, rows: np.ndarray,
                      meta) -> Future:
        """Under the lock: a submission's job for the batcher."""
        fut = Future()
        if not self.gop:
            self._queue(frame_number, (rows,), meta, fut)
        elif self._gop_first is None:
            # first of the pair: deliver the tiny header sample at once
            # (sync Encoder parity) — the sequence header for the stream's
            # first group, a SAMPLE_TYPE_FRAME header for every later one
            # (`EncodeFirstSample` runs once, encoder.c:3226)
            self._gop_first = rows
            fut.set_result(
                gop_host.frame_header_sample(self.width, self.height,
                                             2 * self._gop_groups - 1)
                if self._gop_groups else
                gop_host.sequence_header(self.width, self.height))
        else:
            self._gop_groups += 1
            # the group's FRAME_NUMBER is the display number of its first
            # frame (1, 3, 5, ...)
            self._queue(2 * self._gop_groups - 1, (self._gop_first, rows),
                        meta, fut)
            self._gop_first = None
        return fut

    # CFHD_WaitForSample
    def wait_for_sample(self, timeout: float | None = None) -> SampleBuffer:
        """Blocks until the next in-order sample is ready, like
        `CFHD_WaitForSample` (`EncoderPool.cpp:297`): an empty queue waits
        for the next submission rather than raising."""
        frame_number, fut = self._harvest(timeout, block=True)
        return SampleBuffer(frame_number=frame_number,
                            data=fut.result(timeout=timeout))

    # CFHD_TestForSample
    def test_for_sample(self) -> SampleBuffer | None:
        head = self._harvest(None, block=False)
        if head is None:
            return None
        return SampleBuffer(frame_number=head[0], data=head[1].result())

    # CFHD_ReleaseSampleBuffer is a no-op (GC owns the buffers)
    def release_sample_buffer(self, buffer: SampleBuffer) -> None:
        pass

    # CFHD_ReleaseEncoderPool
    def release(self) -> None:
        self.stop()


@dataclass
class FrameBuffer:
    """A decoded frame with its submission number."""

    frame_number: int
    data: np.ndarray  # (H, row_bytes) uint8, or (H, W, 4) BGRA


class DecoderPool(_Batches):
    """Asynchronous batch decoder on `device`: submit intra samples /
    harvest frames in order.

    The decode-side counterpart of the EncoderPool batcher.  The reference
    pipelines its header parse with the threaded band decode inside one
    DecodeSample (`Codec/entropy_threading.c:139`); here the same overlap
    happens across batches: a parse thread walks the sample headers,
    copies the band payloads into pinned row buffers and queues their
    upload (`IntraCodec._decode_rows_args`) for batch N+1 while the device
    thread runs the decode (`IntraCodec.decode_checked`: band entropy
    decode, inverse DWT, dither and output pack) of batch N.  Both
    threads queue their work on the device's default stream, so the
    decode of a batch runs after its uploads; the batch keeps its pinned
    rows until its decode has been fetched.  Samples the device route does
    not take (a band with peaks or an unaligned payload, other dimensions,
    a device overflow) take the host entropy decode there, as in
    `decode_batch_device`, and are counted in `fallback_frames`.  A BGRA
    job whose sample `api.Decoder` refuses (`api.check_bgra_source`) fails
    with the same error from the parse thread; the rest of its batch
    decodes.
    """

    def __init__(self, thread_count: int = 2, job_queue_length: int = 32,
                 device: torch.device | str = "cuda") -> None:
        if thread_count < 1:
            raise api.CFHDError(api.ErrorCode.INVALID_ARGUMENT)
        super().__init__(job_queue_length)
        self.device = torch.device(device)
        self._device_queue: deque = deque()
        self._threads: list[threading.Thread] = []
        self._parse_busy = False
        self._prepared = False
        self.fallback_frames = 0

    def prepare_to_decode(self, width: int, height: int,
                          output_format=api.PixelFormat.YUY2) -> None:
        if output_format == api.PixelFormat.YUY2:
            self._output = "YUY2"
        elif output_format == api.PixelFormat.BGRA:
            self._output = "BGRA"
        else:
            raise api.CFHDError(
                api.ErrorCode.BADFORMAT,
                "device decode pool outputs YUY2 or BGRA; other formats "
                "go through api.Decoder")
        self.width, self.height = width, height
        self._codec = api.intra_codec(width, height, api.DECODE_QUALITY,
                                      "YUY2", self.device)
        self._prepared = True

    def start(self) -> None:
        if not self._prepared:
            raise api.CFHDError(api.ErrorCode.UNEXPECTED,
                                "prepare_to_decode first")
        if self._threads:
            return
        self._stopping = False
        self._parse_busy = True
        for name, target in (("cfhd-decode-parse", self._parse_loop),
                             ("cfhd-decode-device", self._device_loop)):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        if not self._threads:
            return
        with self._lock:
            self._stopping = True
            self._lock.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []

    # --- pipeline stages -----------------------------------------------------

    @staticmethod
    def _refuse_bgra(jobs: list[_Job], walks: list) -> tuple[list, list]:
        """Fail the jobs whose samples `api.check_bgra_source` refuses,
        each reading its chroma lowpass width from its header walk
        (`fastwalk.walk`; a sample the walker does not read is parsed
        whole, and fails its job if it does not parse); returns the other
        jobs and their walks."""
        kept = []
        for j, r in zip(jobs, walks):
            try:
                if r is None:
                    info = parse_sample(j.frames[0])
                    api.check_bgra_source(info.width,
                                          info.channels[-1].lowpass_width)
                else:
                    api.check_bgra_source(r.width, r.lowpass_w[-1])
            except Exception as exc:
                j.future.set_exception(exc)
                continue
            kept.append((j, r))
        return [j for j, _ in kept], [r for _, r in kept]

    def _parse_loop(self) -> None:
        """Stage 1: host header walk, pinned row fill and upload."""
        while (jobs := self._next_batch()) is not None:
            try:
                walks = [fastwalk.walk(j.frames[0]) for j in jobs]
                if self._output == "BGRA":
                    jobs, walks = self._refuse_bgra(jobs, walks)
                    if not jobs:
                        continue
                samples = [j.frames[0] for j in jobs]
                rows = self._codec._decode_rows_host(samples, walks)
                item = (jobs, samples, rows, self._codec._upload_rows(rows))
            except BaseException as exc:
                self._fail(jobs, exc)
                continue
            with self._lock:
                self._device_queue.append(item)
                self._lock.notify_all()
        with self._lock:
            self._parse_busy = False
            self._lock.notify_all()

    def _device_loop(self) -> None:
        """Stage 2: device decode, per-frame fallback and delivery."""
        codec = self._codec
        while True:
            with self._lock:
                while not self._device_queue and self._parse_busy:
                    self._lock.wait()
                if not self._device_queue:
                    return  # the parse thread stopped and all is drained
                jobs, samples, rows, args = self._device_queue.popleft()
            try:
                out, fallback = codec.decode_checked(
                    samples, lambda coeffs, frames: codec.inverse_output(
                        coeffs, 0, self._output), rows=args)
                del rows        # the uploads are done: the fetch synced
                with self._lock:
                    self.fallback_frames += len(fallback)
                for j, frame in zip(jobs, out):
                    j.future.set_result(frame)
            except BaseException as exc:
                self._fail(jobs, exc)

    # --- API -----------------------------------------------------------------

    def decode_async_sample(self, frame_number: int, sample: bytes) -> None:
        if not self._threads:
            raise api.CFHDError(api.ErrorCode.UNEXPECTED,
                                "pool not started")
        with self._lock:
            self._reserve()
            fut = Future()
            fut.add_done_callback(self._job_done)
            self._queue(frame_number, (sample,), None, fut)
            self._pending.append((frame_number, fut))
            self._lock.notify_all()

    def wait_for_frame(self, timeout: float | None = None) -> FrameBuffer:
        frame_number, fut = self._harvest(timeout, block=True)
        return FrameBuffer(frame_number=frame_number,
                           data=fut.result(timeout=timeout))

    def test_for_frame(self) -> FrameBuffer | None:
        head = self._harvest(None, block=False)
        if head is None:
            return None
        return FrameBuffer(frame_number=head[0], data=head[1].result())

    def release(self) -> None:
        self.stop()
