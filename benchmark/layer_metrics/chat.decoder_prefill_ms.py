"""Mean device time (ms) a chat request of the program's `decoder` span: the SPLIT MoT
prefill. Read from g2vlm_tpu_torch.utils.tracing over the requests that the other chat.*
metrics read (outside the profiled sub-window, by `return_info`'s request_id); None
without the recorder, or without a CUDA device."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    ids = [s["info"]["request_id"] for s in ctx.samples if s.get("info")]
    return tracing.summary(ids)["spans"].get(("chat", "decoder"), {}).get("device_ms")
