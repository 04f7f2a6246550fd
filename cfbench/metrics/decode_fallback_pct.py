"""decode_fallback_pct: the share of the window's decoded frames that
`pool.DecoderPool` sent to the host entropy decoder
(`IntraCodec.decode_checked`'s fallback; the pool's own `fallback_frames`
counter), in percent."""


def read(ctx):
    done = len(ctx.finished())
    if ctx.fallback_frames is None or not done:
        return None
    return 100.0 * ctx.fallback_frames / done
