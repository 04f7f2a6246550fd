"""The program's samples into `pool.DecoderPool`, `in_flight` jobs, in a
closed loop (`drive.Load.pool_loop`); frames harvested in order, in the
mix's `output` pixel format, each against the reference's decode of its
frame."""

from cfbench import drive


def prepare(cfg, mix, frames, device, log):
    """The frames' samples, encoded by the program."""
    samples, overflowed = drive.encode_samples(cfg, frames, device)
    drive.log_samples(cfg, frames, samples, overflowed, log)
    return samples


class Load(drive.Load):
    def open(self):
        from cineform_tpu_torch import pool

        self.pool = pool.DecoderPool(job_queue_length=self.mix["in_flight"],
                                     device=self.device)
        self.pool.prepare_to_decode(self.cfg["width"], self.cfg["height"],
                                    self.api.PixelFormat[self.mix["output"]])
        self.slots = self.pool.DEVICE_BATCH

    def client(self, c):
        pool = self.pool

        def harvest():
            buf = pool.wait_for_frame(timeout=600)
            return buf.frame_number, buf.data

        self.pool_loop(c, lambda k, item: pool.decode_async_sample(
            k + 1, self.inputs[item]), harvest)


def expected(ref, cfg, mix, frame, rec, lossy):
    return ref.decode_output(cfg, frame, mix["output"], lossy)
