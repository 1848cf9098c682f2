"""Mean device time (ms) a recon call of the program's `decoder` span on the Kimi-VL
decoder's configuration: the 27-layer MLA + MoE prefill (attention, router, experts). Read from g2vlm_tpu_torch.utils.tracing, which records the
profiled calls of a traced run; None without the recorder, without the span, or without a CUDA
device."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    return tracing.summary()["spans"].get(("recon", "decoder"), {}).get("device_ms")
