"""Set-up: from the start of the process to the first timed request."""


def read(ctx):
    return ctx.setup_s
