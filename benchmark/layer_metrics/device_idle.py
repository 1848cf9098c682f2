"""Share (%) of the profiled sub-window in which no kernel, copy or memset ran on the device."""


def read(ctx):
    return ctx.idle_share()
