"""The share of the decode steps that ran on the fused decode kernels, in %: 100 times the
program's `decode.fused_steps` counter over its `decode.steps` counter (both counted by the
decode loop, a replayed step as an eager one), read from g2vlm_tpu_torch.utils.tracing over the
requests that the other chat.* metrics read (outside the profiled sub-window, by `return_info`'s
request_id). None where the program counts no steps."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    ids = [s["info"]["request_id"] for s in ctx.samples if s.get("info")]
    counters = tracing.summary(ids)["counters"]
    steps = counters.get(("chat", "decode.steps"))
    if not steps:
        return None
    return 100.0 * counters.get(("chat", "decode.fused_steps"), 0.0) / steps
