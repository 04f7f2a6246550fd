"""setup_s: seconds from the process's start to the window's: imports, the
frames, the decoders' samples, the warm-up, and in a checkout's first run
the builds of the program's libraries."""


def read(ctx):
    return ctx.setup_s
