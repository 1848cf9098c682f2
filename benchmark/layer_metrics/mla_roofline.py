"""The MLA forward (`mla_fwd_kernel<T, 192, 128>`, g2vlm_tpu_torch/csrc/attention_segment.cu) over
the profiled sub-window: the sum of its launches' bounds (benchmark/work/kimivl.py) over the sum
of their device time, in %. None where the trace holds no such launch."""

MLA = r"mla_fwd_kernel<"


def read(ctx):
    return ctx.roofline(MLA, "mla_bound_s")
