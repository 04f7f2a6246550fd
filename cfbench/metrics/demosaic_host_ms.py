"""demosaic_host_ms: host milliseconds a frame in the program's
`intra.inverse_bayer_rgb` spans (the Row16u planes, the demosaic and
develop of `ops/demosaic`, a frame at a time) in the window before the
profiler starts: the launch side, beside `demosaic_device_ms`."""

from cfbench import program


def read(ctx):
    return program.host_ms(ctx, "intra.inverse_bayer_rgb",
                           "intra.inverse_bayer_rgb")
