"""Mean device time (ms) a recon call of the program's `moe.route` span on the Kimi-VL
decoder's configuration: the router, top-k, sort by expert and combine, summed over the 26 MoE layers. Read from g2vlm_tpu_torch.utils.tracing, which records the
profiled calls of a traced run; None without the recorder, without the span, or without a CUDA
device."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    return tracing.summary()["spans"].get(("recon", "moe.route"), {}).get("device_ms")
