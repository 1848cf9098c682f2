"""Mean megabytes (1e6 bytes) a chat request of the program's `upload.bytes` counter: the
request's images sent from host memory to the device, at the dtype they are sent in. Read
from g2vlm_tpu_torch.utils.tracing over the requests that the other chat.* metrics read
(outside the profiled sub-window, by `return_info`'s request_id); None without the
recorder."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    ids = [s["info"]["request_id"] for s in ctx.samples if s.get("info")]
    n = tracing.summary(ids)["counters"].get(("chat", "upload.bytes"))
    return None if n is None else n / 1e6
