"""A 2-frame-GOP clip played in frame order through one
`api.Decoder.decode_sample` (CFHD_DecodeSample): each group's GROUP
sample, then its 24-byte FRAME sample, one call at a time, in the mix's
`output` pixel format.

An item is a group, frames[item] its (2, H, row bytes) pair.  Request k
of a client is frame k % 2 of its group: the GROUP sample's call returns
frame 0, the FRAME sample's call the group's true second frame, so the
requests' two batch slots (`slots`) are the two frames, and the check
takes one of each before a second of either.  It is also the k-th frame
the client's decoder emits, whose dither a YUY2 output draws.  Each block
of `keep_every` (an even number) requests keeps one output at a place
drawn from the seed, on frame 0 in even blocks and frame 1 in odd ones."""

import time

import numpy as np

from cfbench import drive

#: groups a set-up batch encodes
BATCH = 8


def prepare(cfg, mix, frames, device, log):
    """Each group's (GROUP sample, FRAME sample), encoded by the program
    as `api.Encoder` does under `EncodingFlags.YUV_2FRAME_GOP`: the group
    with FRAME_NUMBER 2g + 1, the display number of its first frame, then
    `gop_host.frame_header_sample` with the same number.  Each GROUP
    sample is then played once through a decoder as the loop plays it, to
    log the groups the device route gives to the host."""
    from cineform_tpu_torch import api
    from cineform_tpu_torch.bitstream import parse_sample
    from cineform_tpu_torch.models import gop_host

    w, h = cfg["width"], cfg["height"]
    codec = api.gop_codec(w, h, cfg["quality"], device)
    groups = []
    for i in range(0, len(frames), BATCH):
        batch = frames[i:i + BATCH]
        numbers = [2 * g + 1 for g in range(i, i + len(batch))]
        groups += codec.encode_batch(batch[:, 0], batch[:, 1],
                                     frame_numbers=numbers)
    inputs = [(s, gop_host.frame_header_sample(w, h, 2 * g + 1))
              for g, s in enumerate(groups)]
    dec = api.Decoder(device)
    dec.prepare_to_decode(w, h, api.PixelFormat[mix["output"]])
    fallback = []
    for g, s in enumerate(groups):
        before = dec.fallback_frames
        dec.decode_sample(s)
        if dec.fallback_frames > before:
            fallback.append(g)
    peaks = [g for g, s in enumerate(groups)
             if any(b.peaks is not None
                    for c in parse_sample(s).channels for b in c.bands)]
    ratio = frames.nbytes / sum(len(a) + len(b) for a, b in inputs)
    log(f"{cfg['name']}: the program's {len(groups)} GROUP samples and "
        f"their FRAME samples of {2 * len(groups)} frames of {w}x{h} "
        f"YUY2, quality {cfg['quality']}: compression ratio {ratio:.4f}, "
        f"groups with a peak table {peaks} ({len(peaks)}), groups the "
        f"device route gives to the host {fallback} ({len(fallback)})")
    return inputs


class Load(drive.Load):
    slots = 2

    def item(self, client: int, k: int) -> int:
        return (client * self.mix.get("stream_offset", 0) + k // 2) \
            % len(self.frames)

    def kept(self, client: int, k: int) -> bool:
        block = (k // self._every) % drive.KEEP_BLOCKS
        at = int(self._keep[client][block])
        return k % self._every == (at & ~1) | (block & 1)

    def client(self, c):
        api = self.api
        dec = api.Decoder(self.device)
        dec.prepare_to_decode(self.cfg["width"], self.cfg["height"],
                              api.PixelFormat[self.mix["output"]])
        k = 0
        while not self.stopping:
            item = self.item(c, k)
            t0 = time.perf_counter()
            try:
                out, ok, err = dec.decode_sample(self.inputs[item][k % 2]), \
                    True, ""
            except api.CFHDError as exc:
                out, ok, err = None, False, repr(exc)
            self.record(c, k, item, t0, ok, out, err)
            k += 1


def expected(ref, cfg, mix, pair, rec, lossy):
    return ref.decode_output(cfg, np.asarray(pair), mix["output"], lossy,
                             frame=rec.k % 2, window=rec.k)
