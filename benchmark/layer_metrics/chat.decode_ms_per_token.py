"""The decode spans of every request over the tokens they emitted, in ms."""


def read(ctx):
    t = ctx.info_sum("t_decode_s")
    n = ctx.work("tokens")
    return None if t is None or not n else t / n * 1e3
