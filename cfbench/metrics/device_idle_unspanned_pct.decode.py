"""device_idle_unspanned_pct.decode: the share of the device's idle time in
the profiled sub-window, in percent, whose gap's middle lies in no span of
the program on any thread (the rule of `trace.idle_gaps`): the idle that
no layer of the program accounts for."""

from cfbench import program


def read(ctx):
    return program.idle_unspanned_pct(ctx)
