"""Mean device time (ms) a recon call of the program's `dino` span on the Kimi-VL decoder's
configuration: DINOv2 and the dino2llm projection. Read from g2vlm_tpu_torch.utils.tracing, which records the profiled
calls of a traced run; None without the recorder, or without a CUDA device."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    return tracing.summary()["spans"].get(("recon", "dino"), {}).get("device_ms")
