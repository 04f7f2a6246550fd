"""encode_reencode_ms: host milliseconds a frame in the program's
`intra.reencode` spans (`intra_host.write_sample`'s C++ re-encode of a band
that overflowed the device coder, one span a band) in the window before
the profiler starts: per thread the union of their intervals, over the
frames of the program's `intra.write_samples` spans there."""

from cfbench import program


def read(ctx):
    return program.host_ms(ctx, "intra.reencode", "intra.write_samples")
