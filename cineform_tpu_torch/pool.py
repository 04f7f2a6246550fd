"""Asynchronous encoder and decoder pools on a torch device: the port of
`cineform_tpu.pool`.

Behavioral contract: `EncoderSDK/EncoderPool.cpp:59-449` — submit frames,
harvest samples strictly in submission order through
WaitForSample/TestForSample, with a per-frame metadata snapshot and a
bounded number of jobs in flight.

The encoder pool routes a configuration as the JAX pool does.  The
formats of `_DEVICE_POOL_FORMATS` (V210 only at a width that is a
multiple of 48) go to a batcher thread, which drains the submission queue
and encodes whole batches of up to `DEVICE_BATCH` frames through the
port's codecs on the card (`IntraCodec.encode_batch_device`; progressive
2-frame GOP pairs through `GopCodec.encode_batch`); where more than one
card is visible, the batch's frames are sharded over a `parallel.mesh`
frame mesh.  A batcher takes whatever is queued, up to `DEVICE_BATCH`
jobs; only the real frames are encoded.  The other formats, and any with
`use_device=False`, go to `thread_count` worker threads, each owning one
`api.Encoder` on the same device, one frame a job, as the reference's
CAsyncEncoder workers do; each worker keeps its own FILMSCAN2/3 rate
control.  The reference parallelises frames over CPU threads (SURVEY
§2.4); there is no host codec here: every route encodes on the device.
Interlaced GOP pairs, and GOP pairs off the YUY2 batcher, are refused, as
the JAX pool refuses them.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from cineform_tpu_torch import api
from cineform_tpu_torch.bitstream import fastwalk, parse_sample
from cineform_tpu_torch.entropy import device_decode as ddec
from cineform_tpu_torch.models import gop_host
from cineform_tpu_torch.parallel import mesh as frame_meshes
from cineform_tpu_torch.utils import timing


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


#: the input formats the JAX pool's batcher takes (`cineform_tpu/pool.py:
#: 40-49`): 4:2:2 YUY2, UYVY, V210 (at a width that is a multiple of 48)
#: and YU64, the RGB 4:4:4 and RGBA 4:4:4:4 RG48, B64A and RG64, and Bayer
_DEVICE_POOL_FORMATS = frozenset((
    api.PixelFormat.YUY2, api.PixelFormat.UYVY, api.PixelFormat.V210,
    api.PixelFormat.YU64, api.PixelFormat.RG48, api.PixelFormat.B64A,
    api.PixelFormat.RG64, api.PixelFormat.BYR4, api.PixelFormat.BYR5))


class EncoderPool(_Batches):
    """CFHD_CreateEncoderPool .. CFHD_ReleaseEncoderPool on `device`."""

    def __init__(self, thread_count: int, job_queue_length: int,
                 device: torch.device | str = "cuda") -> None:
        if thread_count < 1:
            raise api.CFHDError(api.ErrorCode.INVALID_ARGUMENT)
        super().__init__(job_queue_length)
        self.thread_count = thread_count
        self.device = torch.device(device)
        self._prepared = False
        self._metadata = None
        self._codec = None
        self._sharding = None
        self._batcher: threading.Thread | None = None
        self._executor: ThreadPoolExecutor | None = None
        self._tls = threading.local()
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
                          use_device: bool | None = None) -> None:
        """`use_device`: None takes the batcher for the formats of
        `_DEVICE_POOL_FORMATS` and the workers for the others; True the
        batcher (BADFORMAT for a format it does not take); False the
        workers."""
        probe = api.Encoder(self.device)  # validates arguments
        probe.prepare_to_encode(width, height, pixel_format, encoded_format,
                                encoding_flags, quality)
        gop = bool(encoding_flags & api.EncodingFlags.YUV_2FRAME_GOP)
        if encoding_flags & api.EncodingFlags.YUV_INTERLACED:
            # the JAX pool refuses it, though its sync Encoder encodes it
            # (`cineform_tpu/pool.py:91-93`)
            raise api.CFHDError(api.ErrorCode.BADFORMAT,
                                "interlaced GOP is not supported in the pool")
        batched = pixel_format in _DEVICE_POOL_FORMATS and not (
            pixel_format == api.PixelFormat.V210 and width % 48)
        if use_device is None:
            use_device = batched
        if use_device and not batched:
            raise api.CFHDError(api.ErrorCode.BADFORMAT,
                                f"no device path for {pixel_format!r}")
        if gop and not (use_device and pixel_format == api.PixelFormat.YUY2):
            # GOP pairing is stateful across submissions: the workers
            # encode each job independently, the batcher pairs
            # consecutive submissions
            raise api.CFHDError(api.ErrorCode.BADFORMAT,
                                "2-frame GOP needs the device path (YUY2)")
        self.gop, self.use_device = gop, use_device
        self.width, self.height = width, height
        self.pixel_format, self.encoded_format = pixel_format, encoded_format
        # the workers' encoders take the quality's low byte, as the JAX
        # pool's do: the V210 passthrough bits are dropped
        self.quality = probe.quality
        self.row_bytes = probe.row_bytes
        self._codec = self._sharding = None
        if use_device and gop:
            self._codec = api.gop_codec(width, height, int(probe.quality),
                                        self.device)
        elif use_device:
            self._codec = api.intra_codec(
                width, height, int(probe.quality),
                api.Encoder.CODEC_FORMATS[pixel_format], self.device)
            # more than one card: the batch's frames sharded over them
            # (`cineform_tpu/pool.py:114-131`)
            ndev = len(frame_meshes.frame_mesh(device=self.device))
            if ndev > 1:
                self._sharding = frame_meshes.batch_sharding(
                    frame_meshes.frame_mesh(min(ndev, self.DEVICE_BATCH),
                                            device=self.device))
        self._prepared = True

    # CFHD_AttachEncoderPoolMetadata
    def attach_metadata(self, metadata) -> None:
        self._metadata = metadata

    # CFHD_StartEncoderPool
    def start(self) -> None:
        if not self._prepared:
            raise api.CFHDError(api.ErrorCode.ENCODING_NOT_STARTED)
        if not self.use_device:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.thread_count,
                    thread_name_prefix="cfhd-encoder")
        elif self._batcher is None:
            self._stopping = False
            self._batcher = threading.Thread(
                target=self._batch_loop, name="cfhd-device-batcher",
                daemon=True)
            self._batcher.start()

    # CFHD_StopEncoderPool
    def stop(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
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
            numbers = [j.frame_number for j in jobs]
            try:
                with timing.span("pool.batch", len(jobs), numbers, root=True):
                    with timing.span("pool.stack"):
                        frames = [np.stack(f)
                                  for f in zip(*(j.frames for j in jobs))]
                    meta = [j.metadata for j in jobs]
                    if self.gop:
                        samples = self._codec.encode_batch(
                            *frames, frame_numbers=numbers, metadata=meta)
                    else:
                        samples = self._codec.encode_batch_device(
                            *frames, frame_numbers=numbers, metadata=meta,
                            sharding=self._sharding)
                    for j, s in zip(jobs, samples):
                        j.future.set_result(s)
            except BaseException as exc:  # propagate to the harvesters
                self._fail(jobs, exc)

    # --- worker path --------------------------------------------------------

    def _worker_encoder(self) -> api.Encoder:
        """The worker thread's own sample encoder, as the reference's
        CAsyncEncoder owns a CSampleEncoder (`AsyncEncoder.h:30-41`), so
        each worker advances its own FILMSCAN2/3 rate control."""
        enc = getattr(self._tls, "encoder", None)
        if enc is None:
            enc = api.Encoder(self.device)
            enc.prepare_to_encode(self.width, self.height, self.pixel_format,
                                  self.encoded_format, api.EncodingFlags.NONE,
                                  self.quality)
            self._tls.encoder = enc
        return enc

    def _encode_job(self, frame_number: int, frame: bytes,
                    metadata) -> bytes:
        enc = self._worker_encoder()
        # per-frame metadata snapshot + explicit frame numbering
        # (`EncoderPool.cpp:389-449`)
        enc._metadata = metadata
        enc._frame_number = frame_number - 1
        enc.encode_sample(frame)
        return enc.get_sample_data()

    # CFHD_EncodeAsyncSample
    def encode_async_sample(self, frame_number: int,
                            frame: bytes | np.ndarray,
                            metadata=None) -> None:
        if self._batcher is None and self._executor is None:
            raise api.CFHDError(api.ErrorCode.ENCODING_NOT_STARTED)
        meta = metadata or self._metadata
        if self._executor is not None:
            # a worker's encoder checks the frame's size
            frame = (np.ascontiguousarray(frame).tobytes()
                     if isinstance(frame, np.ndarray) else frame)
        else:
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
            if self._executor is not None:
                fut = self._executor.submit(self._encode_job, frame_number,
                                            frame, meta)
            else:
                fut = self._queue_device(
                    frame_number, buf.reshape(self.height, self.row_bytes),
                    meta)
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
    a device overflow, bands that the JAX API's rules read otherwise than
    the device route) take the host entropy decode there, as in
    `decode_batch_device`, and are counted in `fallback_frames`.  Each job
    gets what `api.Decoder` gives its sample: a job whose sample the API
    refuses (`_screen`: a corrupt sample the JAX API rejects, or a BGRA
    output `api.check_bgra_source` refuses) fails with the same
    CFHDError(BADSAMPLE), and the rest of its batch decodes.  (The JAX
    pool checks no band of the frames its device program decodes, and a
    frame that its host route cannot decode fails the whole batch.)
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

    def _screen(self, jobs: list[_Job]):
        """The sync API's checks of each job's sample before any device
        work: its parse, `api.screen` (the JAX API's accept/reject rules)
        and, for a BGRA output, `api.check_bgra_source`.  A job whose
        sample fails them fails with the API's CFHDError(BADSAMPLE); the
        rest of its batch decodes.  Returns the other jobs, their header
        walks, and the indices among them of the frames that take the host
        route (`IntraCodec.decode_checked`'s `host`)."""
        kept, walks, host = [], [], []
        for j in jobs:
            sample = j.frames[0]
            try:
                try:
                    info = parse_sample(sample)
                    if self._output == "BGRA":
                        api.check_bgra_source(
                            info.width, info.channels[-1].lowpass_width)
                except api.CFHDError:
                    raise
                except Exception as exc:
                    raise api.CFHDError(api.ErrorCode.BADSAMPLE,
                                        str(exc)) from exc
                to_host = api.screen(self._codec, info)
            except api.CFHDError as exc:
                j.future.set_exception(exc)
                continue
            if to_host:
                host.append(len(kept))
            kept.append(j)
            walks.append(fastwalk.walk(sample))
        return kept, walks, host

    def _parse_loop(self) -> None:
        """Stage 1: the checks, host header walk, pinned row fill and
        upload."""
        while (jobs := self._next_batch()) is not None:
            try:
                with timing.span("pool.parse_batch", len(jobs), root=True):
                    jobs, walks, host = self._screen(jobs)
                    if not jobs:
                        continue
                    samples = [j.frames[0] for j in jobs]
                    rows = self._codec._decode_rows_host(samples, walks,
                                                         host=host)
                    with timing.span("intra.upload_rows"):
                        item = (jobs, samples, rows, ddec.upload_rows(
                            rows, self._codec.device))
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
                with timing.span("pool.decode_batch", len(jobs), root=True):
                    errors: dict = {}
                    out, fallback = codec.decode_checked(
                        samples, lambda coeffs, frames: codec.inverse_output(
                            coeffs, 0, self._output), rows=args,
                        errors=errors)
                    del rows    # the uploads are done: the fetch synced
                    with self._lock:
                        self.fallback_frames += len(fallback) - len(errors)
                    for i, j in enumerate(jobs):
                        if i in errors:
                            exc = api.CFHDError(api.ErrorCode.BADSAMPLE,
                                                str(errors[i]))
                            exc.__cause__ = errors[i]
                            j.future.set_exception(exc)
                        else:
                            j.future.set_result(out[i])
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
