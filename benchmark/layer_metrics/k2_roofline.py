"""K2, the segment forward without lse (`segment_fwd_kernel<T, D, false,
false, false>`, at every head dim), over the profiled sub-window: the sum of
its launches' bounds (benchmark/work/counts.py) over the sum of their device
time, in %."""

K2 = r"segment_fwd_kernel<[^,]+, \d+, false, false, false>"


def read(ctx):
    return ctx.roofline(K2, "k2_bound_s")
