"""Model FLOPs of the work completed in the window (benchmark/work/counts.py)
over the window's seconds and the bf16 peak of one H100 (989 TFLOP/s), in %."""


def read(ctx):
    return ctx.mfu()
