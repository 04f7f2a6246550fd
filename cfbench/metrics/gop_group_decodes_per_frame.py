"""gop_group_decodes_per_frame: the groups the program decoded a frame it
delivered, in the window before the profiler starts: its counters
`gop.group_decodes` (one a group a device-route call decodes) over
`gop.frames_out` (one a frame `api.Decoder` returns from a group).  1.0
while each FRAME sample decodes its group again."""

from cfbench import program


def read(ctx):
    groups = program.counter_total("gop.group_decodes", ctx.start,
                                   ctx.quiet_end)
    frames = program.counter_total("gop.frames_out", ctx.start,
                                   ctx.quiet_end)
    if not frames or groups is None:
        return None
    return groups / frames
