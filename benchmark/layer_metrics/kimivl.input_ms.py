"""Mean device time (ms) a recon call of the program's `input` span on the Kimi-VL decoder's
configuration: the frames' upload and the preprocess on the card. Read from g2vlm_tpu_torch.utils.tracing, which records the profiled
calls of a traced run; None without the recorder, or without a CUDA device."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    return tracing.summary()["spans"].get(("recon", "input"), {}).get("device_ms")
