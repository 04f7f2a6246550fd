"""pool_batch_frames.decode: the mean size, in frames, of the batches that
`pool.DecoderPool`'s parse thread took from its queue in the window (the
pool's own `batches` counter)."""


def read(ctx):
    if ctx.mix["entry"] != "decoder_pool" or not ctx.batches:
        return None
    return sum(ctx.batches) / len(ctx.batches)
