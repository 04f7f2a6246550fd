"""entropy_scan_device_ms: device milliseconds a frame of the kernels
launched in the program's `entropy.scan_entries_rows` spans (stage 3 of
the band decoder, `entropy/device_decode.scan_entries_rows`: the scan
composing the chunk transfers along each row) in the profiled sub-window,
over the frames of the `intra.decode_coefficients` spans around them."""

from cfbench import program


def read(ctx):
    return program.device_ms(ctx, "entropy.scan_entries_rows",
                             "intra.decode_coefficients")
