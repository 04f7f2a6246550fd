"""Frames into `pool.EncoderPool` (`api.CFHD_CreateEncoderPool`), one
thread, `in_flight` jobs, in a closed loop (`drive.Load.pool_loop`);
samples harvested in order, each against the reference encoder's sample
of its frame."""

from cfbench import drive


def prepare(cfg, mix, frames, device, log):
    """Nothing the loop needs; the program's samples of 8 frames are
    encoded once for the log's compression ratio and overflowed bands."""
    samples, overflowed = drive.encode_samples(cfg, frames[:8], device)
    drive.log_samples(cfg, frames[:8], samples, overflowed, log)
    return None


class Load(drive.Load):
    def open(self):
        api, cfg = self.api, self.cfg
        self.pool = api.CFHD_CreateEncoderPool(1, self.mix["in_flight"],
                                               device=self.device)
        self.pool.prepare_to_encode(
            cfg["width"], cfg["height"], api.PixelFormat[cfg["format"]],
            quality=api.EncodingQuality(cfg["quality"]))
        self.slots = self.pool.DEVICE_BATCH

    def client(self, c):
        pool = self.pool

        def harvest():
            buf = pool.wait_for_sample(timeout=600)
            return buf.frame_number, buf.get_encoded_sample()

        self.pool_loop(c, lambda k, item: pool.encode_async_sample(
            k + 1, self.frames[item]), harvest)


def expected(ref, cfg, mix, frame, rec, lossy):
    """The sample of the frame with frame number k + 1, as the client
    submitted it."""
    return ref.encode_sample(cfg, frame, rec.k + 1, lossy)
