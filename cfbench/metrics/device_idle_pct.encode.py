"""device_idle_pct.encode: 100 less the device's busy share (the union of
its kernel, copy and memset intervals) of the profiled sub-window."""

from cfbench.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
