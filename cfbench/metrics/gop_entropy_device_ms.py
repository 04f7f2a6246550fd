"""gop_entropy_device_ms: device milliseconds a frame of the kernels
launched in the program's `gop.decode_coefficients` spans (the band
entropy decoder, `entropy/device_decode`, at the GOP's 6 row classes) in
the profiled sub-window, over the frames of the `api.decode_sample` calls
around them: one a call, and each call of the cell delivers one frame."""

from cfbench import program


def read(ctx):
    return program.device_ms(ctx, "gop.decode_coefficients",
                             "api.decode_sample")
