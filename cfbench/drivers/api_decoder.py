"""The program's samples through `api.Decoder.decode_sample`
(CFHD_DecodeSample): each client its own decoder, one call at a time, in
the mix's `output` pixel format; each frame against the reference's
decode of its frame."""

import time

from cfbench import drive


def prepare(cfg, mix, frames, device, log):
    """The frames' samples, encoded by the program."""
    samples, overflowed = drive.encode_samples(cfg, frames, device)
    drive.log_samples(cfg, frames, samples, overflowed, log)
    return samples


class Load(drive.Load):
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
                out, ok, err = dec.decode_sample(self.inputs[item]), True, ""
            except api.CFHDError as exc:
                out, ok, err = None, False, repr(exc)
            self.record(c, k, item, t0, ok, out, err)
            k += 1


def expected(ref, cfg, mix, frame, rec, lossy):
    return ref.decode_output(cfg, frame, mix["output"], lossy)
