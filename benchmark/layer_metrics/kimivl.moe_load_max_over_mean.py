"""The busiest expert's routed tokens over the mean expert's, averaged over the MoE layers of a
recon call on the Kimi-VL decoder's configuration: 1 where the router spreads the tokens evenly,
up to 64 / 6 where every token of a layer picks the same six. Read from the program's counters
`moe.tokens.l<layer>.max` and `moe.tokens.l<layer>.mean` (g2vlm_tpu_torch/ops/moe.py), which count
only while the recorder records (the profiled calls of a traced run); None without them."""


def read(ctx):
    try:
        from g2vlm_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    counters = tracing.summary()["counters"]
    ratios = [n / counters[("recon", name[:-len("max")] + "mean")] for (top, name), n in counters.items()
              if top == "recon" and name.startswith("moe.tokens.l") and name.endswith(".max")
              and counters.get(("recon", name[:-len("max")] + "mean"))]
    return sum(ratios) / len(ratios) if ratios else None
