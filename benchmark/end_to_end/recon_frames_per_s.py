"""Views reconstructed in the calls completed in the window, over the window's seconds."""


def read(ctx):
    return ctx.work("views") / ctx.window_s if ctx.samples else None
