"""Mean device time (ms) a recon call of the program's `decoder` span: the 28-layer GEO_MAIN
MoT prefill. Read from g2vlm_tpu_torch.utils.tracing, which records the profiled calls of
a traced run; None without the recorder, or without a CUDA device."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    return tracing.summary()["spans"].get(("recon", "decoder"), {}).get("device_ms")
