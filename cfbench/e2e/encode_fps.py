"""encode_fps: samples harvested in the window, over its seconds."""


def read(ctx):
    return len(ctx.finished()) / ctx.seconds
