"""gop_walk_host_ms: host milliseconds a frame in the program's
`gop.decode_rows_host` spans (`GopCodec._decode_rows_host`: the Python
header walk of a GROUP sample and the pinned row fill) in the window
before the profiler starts, over the frames of the `api.decode_sample`
calls there; None where the program counts no GOP frame there."""

from cfbench import program


def read(ctx):
    if program.counter_total("gop.frames_out", ctx.start,
                             ctx.quiet_end) is None:
        return None
    return program.host_ms(ctx, "gop.decode_rows_host", "api.decode_sample")
