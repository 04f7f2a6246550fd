"""decode_fps: frames delivered in the window, over its seconds, all
clients together."""


def read(ctx):
    return len(ctx.finished()) / ctx.seconds
