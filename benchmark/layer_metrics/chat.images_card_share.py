"""The share of a chat request's images whose resample ran on the card, in %: 100 times the
program's `images.card_frames` counter (frames resized by the resample kernels) over its
`images.frames` counter (every frame of the default chat path), read from
g2vlm_tpu_torch.utils.tracing over the requests that the other chat.* metrics read (outside
the profiled sub-window, by `return_info`'s request_id). None where the program counts no
frames (a program that resizes them on the host)."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    ids = [s["info"]["request_id"] for s in ctx.samples if s.get("info")]
    counters = tracing.summary(ids)["counters"]
    frames = counters.get(("chat", "images.frames"))
    if not frames:
        return None
    return 100.0 * counters.get(("chat", "images.card_frames"), 0.0) / frames
