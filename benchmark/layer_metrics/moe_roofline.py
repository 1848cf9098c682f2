"""The expert products' bound (benchmark/work/kimivl.py `moe_bound_s`: the routed and shared
SwiGLU products of every MoE layer) over the device time of the program's `moe.experts` spans, per
recon call of the profiled sub-window, in %. None without the recorder or the span."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    ms = tracing.summary()["spans"].get(("recon", "moe.experts"), {}).get("device_ms")
    n = len(ctx.traced)
    bound = ctx.work("moe_bound_s", traced=True)
    return 100.0 * bound / n / (ms * 1e-3) if ms and n and bound > 0 else None
