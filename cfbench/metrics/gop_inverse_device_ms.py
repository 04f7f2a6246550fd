"""gop_inverse_device_ms: device milliseconds a frame of the kernels
launched in the program's `gop.inverse_to` spans (the FIELDPLUS pyramid,
the temporal combine, the final level to Row16u and the output pack,
`GopCodec.inverse_to`) in the profiled sub-window, over the frames of the
`api.decode_sample` calls around them."""

from cfbench import program


def read(ctx):
    return program.device_ms(ctx, "gop.inverse_to", "api.decode_sample")
