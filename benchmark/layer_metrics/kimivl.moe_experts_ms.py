"""Mean device time (ms) a recon call of the program's `moe.experts` span on the Kimi-VL
decoder's configuration: the routed experts' grouped products and the shared expert, summed over the 26 MoE layers. Read from g2vlm_tpu_torch.utils.tracing, which records the
profiled calls of a traced run; None without the recorder, without the span, or without a CUDA
device."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    return tracing.summary()["spans"].get(("recon", "moe.experts"), {}).get("device_ms")
