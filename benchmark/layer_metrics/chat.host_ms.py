"""Mean per request of the wall time outside the pipeline's stage spans
(upload, forward, cache build, decode): the host PIL and ViT preprocess and
the glue, in ms."""


def read(ctx):
    stages = ctx.info_sum("t_upload_s", "t_forward_s", "t_cache_s", "t_decode_s")
    if stages is None:
        return None
    return (sum(ctx.latencies()) - stages) / len(ctx.samples) * 1e3
