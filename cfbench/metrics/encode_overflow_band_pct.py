"""encode_overflow_band_pct: the share of the bands the device coder coded
that overflowed its capacity and were re-encoded on the host, in percent:
the program's counters `intra.bands_overflowed` over `intra.bands_coded`
(one event each a batch, from `IntraCodec.write_samples`), summed over
the window before the profiler starts."""

from cfbench import program


def read(ctx):
    coded = program.counter_total("intra.bands_coded", ctx.start,
                                  ctx.quiet_end)
    overflowed = program.counter_total("intra.bands_overflowed", ctx.start,
                                       ctx.quiet_end)
    if not coded or overflowed is None:
        return None
    return 100.0 * overflowed / coded
