"""pool_batch_frames.encode: the mean size, in frames, of the batches that
`pool.EncoderPool`'s batcher took from its queue in the window (the pool's
own `batches` counter)."""


def read(ctx):
    if ctx.mix["entry"] != "encoder_pool" or not ctx.batches:
        return None
    return sum(ctx.batches) / len(ctx.batches)
