"""Mean host time (ms) a chat request of the program's `decode.first` span: the decode loop's
eager first step and its CUDA-graph capture. Read from g2vlm_tpu_torch.utils.tracing over
the requests that the other chat.* metrics read (outside the profiled sub-window, by
`return_info`'s request_id); None without the recorder."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    ids = [s["info"]["request_id"] for s in ctx.samples if s.get("info")]
    return tracing.summary(ids)["spans"].get(("chat", "decode.first"), {}).get("host_ms")
