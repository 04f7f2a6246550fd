"""gop_fallback_pct: the share of the groups the program decoded that its
device route gave to the host entropy decoder (`decode_batch_to`), in
percent, in the window before the profiler starts: its counters
`gop.fallback_groups` over `gop.group_decodes` (one event each of a
call, at 0 too)."""

from cfbench import program


def read(ctx):
    groups = program.counter_total("gop.group_decodes", ctx.start,
                                   ctx.quiet_end)
    fallback = program.counter_total("gop.fallback_groups", ctx.start,
                                     ctx.quiet_end)
    if not groups or fallback is None:
        return None
    return 100.0 * fallback / groups
