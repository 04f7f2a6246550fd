"""entropy_transfers_device_ms: device milliseconds a frame of the kernels
launched in the program's `entropy.chunk_transfers` spans (stage 2 of the
band decoder, `entropy/device_decode.chunk_transfers`: every 32-bit
chunk's exit for each of the 27 entry phases) in the profiled sub-window,
over the frames of the `intra.decode_coefficients` spans around them."""

from cfbench import program


def read(ctx):
    return program.device_ms(ctx, "entropy.chunk_transfers",
                             "intra.decode_coefficients")
