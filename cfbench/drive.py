"""What every traffic driver shares: the records of requests, the
program's batch encoder for the decoders' samples, and the clients'
threads.

A mix (`traffic/<mix>.json`) names its driver by `entry`,
`drivers/<entry>.py`, which holds one closed or open loop into one of the
program's entry points and the reference's answer to each request:

- `prepare(cfg, mix, frames, device, log)`: the inputs the loop needs
  besides the frames (the decoders' samples, encoded here by the program),
  made in set-up;
- `Load`, a subclass of `drive.Load`: `open` makes the program's objects,
  `client(c)` runs client c until `stopping`, `close` stops what `open`
  made; `slots`, the batch slots a request may take in the program;
- `expected(ref, cfg, mix, frame, rec, lossy)`: the reference's answer
  to the request `rec` for `frame`, from the configuration's reference
  format module `ref`.

The parameters every driver reads from its mix:

- `clients`: client threads, each with its own stream;
  `stream_offset`: client c's stream starts at item c * stream_offset of
  the configuration's frames and cycles through them;
- `warmup_items`, `warmup_seconds`: what set-up runs of the loop before
  the window, so that every shape and every library is built and the
  pools are full;
- `keep_every`: of each block of this many consecutive requests of a
  client, one, at a place drawn from the seed for each block, keeps its
  output for the check; `check`: how many kept outputs of the window the
  check compares, drawn from the seed to cover every client and every
  batch slot.

The program gets only the generated inputs: the frames, and for the
decoders the samples that set-up encodes from them with the program's own
encoder (`encode_samples`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from cfbench import content

#: blocks of `keep_every` requests whose kept place is drawn ahead; a
#: client's later blocks reuse them in turn
KEEP_BLOCKS = 4096


@dataclass
class Record:
    client: int
    k: int                # the client's k-th request
    item: int             # index into the configuration's frames
    start: float          # perf_counter seconds: submitted or called
    end: float            # harvested or returned
    ok: bool
    output: object = None  # kept outputs only
    error: str = ""


def encode_samples(cfg: dict, frames: np.ndarray, device) -> tuple[list, int]:
    """The frames' CFHD samples from the program's batch encoder on
    `device`, frame numbers 1.. in order, and the count of bands that
    overflowed the device coder's capacity (re-encoded on the host), read
    from `IntraCodec.write_samples`' inputs."""
    from cineform_tpu_torch import api
    from cineform_tpu_torch.models.intra import IntraCodec

    codec = api.intra_codec(cfg["width"], cfg["height"], cfg["quality"],
                            cfg["format"], device)
    overflowed = [0]
    orig = IntraCodec.write_samples

    def counting(self, batch, packed, *args, **kwargs):
        overflowed[0] += sum(int(o.sum()) for _, levels in packed
                             for _, _, o, _ in levels)
        return orig(self, batch, packed, *args, **kwargs)

    IntraCodec.write_samples = counting
    try:
        samples = []
        for i in range(0, len(frames), 8):
            batch = frames[i:i + 8]
            samples += codec.encode_batch_device(
                batch, frame_numbers=list(range(i + 1, i + 1 + len(batch))))
    finally:
        IntraCodec.write_samples = orig
    return samples, overflowed[0]


def log_samples(cfg: dict, frames: np.ndarray, samples: list,
                overflowed: int, log) -> None:
    """The compression ratio and the overflowed bands the content gives."""
    ratio = frames.nbytes / sum(len(s) for s in samples)
    log(f"{cfg['name']}: the program's samples of {len(frames)} frames of "
        f"{cfg['width']}x{cfg['height']} {cfg['format']}, quality "
        f"{cfg['quality']}: compression ratio {ratio:.4f}, overflowed bands "
        f"{overflowed} ({overflowed / len(frames):.3f} a frame)")


def copy(out):
    """A kept output on its own: a decoded frame may be a view of its
    whole batch's array."""
    return np.array(out) if isinstance(out, np.ndarray) else out


class Load:
    """The clients of one run: `start` them, read `completed`, `stop` them
    (each finishes what it has submitted), then read `records`."""

    #: the batch slots a request may take in the program (1: no batches)
    slots = 1

    def __init__(self, cfg: dict, mix: dict, frames: np.ndarray, inputs,
                 device, seed: int) -> None:
        from cineform_tpu_torch import api

        self.api, self.cfg, self.mix = api, cfg, mix
        self.frames, self.inputs, self.device = frames, inputs, device
        self.records: list[Record] = []
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._done = 0
        self._count_lock = threading.Lock()
        self.clients = mix.get("clients", 1)
        self._every = mix.get("keep_every", 1)
        self._keep = [content.rng(seed, 1, c).integers(
            0, self._every, KEEP_BLOCKS) for c in range(self.clients)]
        self.pool = None
        self.open()

    # --- what a driver gives ----------------------------------------------

    def open(self) -> None:
        """Make the program's objects (a pool)."""

    def client(self, c: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Stop what `open` made."""
        if self.pool is not None:
            self.pool.stop()

    # --- what a driver uses -----------------------------------------------

    @property
    def stopping(self) -> bool:
        return self._stop.is_set()

    def item(self, client: int, k: int) -> int:
        return (client * self.mix.get("stream_offset", 0) + k) \
            % len(self.frames)

    def kept(self, client: int, k: int) -> bool:
        block = (k // self._every) % KEEP_BLOCKS
        return k % self._every == self._keep[client][block]

    def record(self, client: int, k: int, item: int, start: float, ok: bool,
               out=None, error: str = "") -> None:
        """Request k of `client` ended now; its output is kept if it is
        one of the client's kept requests."""
        self.records.append(Record(
            client, k, item, start, time.perf_counter(), ok,
            copy(out) if ok and self.kept(client, k) else None, error))
        with self._count_lock:
            self._done += 1

    def pool_loop(self, client: int, submit, harvest) -> None:
        """A closed loop into a pool: keep `in_flight` jobs submitted and
        unharvested, harvest them in order, and submit the next one as each
        is harvested.  `submit(k, item)` queues request k; `harvest()` ->
        (frame number, output) of the oldest."""
        outstanding: deque = deque()
        k = 0
        while True:
            while len(outstanding) < self.mix["in_flight"] \
                    and not self.stopping:
                item = self.item(client, k)
                t = time.perf_counter()
                submit(k, item)
                outstanding.append((k, item, t))
                k += 1
            if not outstanding:
                return
            kk, item, t0 = outstanding.popleft()
            try:
                number, out = harvest()
                ok = number == kk + 1
                err = "" if ok else f"frame {number} for {kk + 1}"
            except self.api.CFHDError as exc:
                ok, out, err = False, None, repr(exc)
            self.record(client, kk, item, t0, ok, out, err)

    # --- the harness's side ----------------------------------------------

    def _run(self, client: int) -> None:
        try:
            self.client(client)
        except Exception as exc:    # a client that dies records why
            self.record(client, -1, -1, time.perf_counter(), False,
                        error=repr(exc))

    def start(self) -> None:
        if self.pool is not None:
            self.pool.start()
        for c in range(self.clients):
            t = threading.Thread(target=self._run, args=(c,),
                                 name=f"cfbench-client-{c}", daemon=True)
            t.start()
            self._threads.append(t)

    @property
    def completed(self) -> int:
        return self._done

    def stop(self, timeout: float = 900) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError(f"{t.name} did not finish")
        self.close()

    def counters(self) -> dict:
        """The program's own counters now: the pool's batches so far and,
        for the decoder pool, its fallback frames."""
        out = {}
        if self.pool is not None:
            out["batches"] = len(self.pool.batches)
            out["fallback_frames"] = getattr(self.pool, "fallback_frames",
                                             None)
        return out

    def batches_between(self, c0: dict, c1: dict) -> list[int]:
        return list(self.pool.batches[c0["batches"]:c1["batches"]]) \
            if self.pool is not None else []
