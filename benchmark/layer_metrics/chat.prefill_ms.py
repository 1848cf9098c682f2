"""Mean per request of the pipeline's upload, prefill forward and cache-build spans, in ms."""


def read(ctx):
    t = ctx.info_sum("t_upload_s", "t_forward_s", "t_cache_s")
    return None if t is None else t / len(ctx.samples) * 1e3
