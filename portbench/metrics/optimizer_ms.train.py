"""Device ms a train step under Adam's `step()` (the optimizer's step
hooks)."""

from portbench.readers import range_ms


def read(ctx):
    return range_ms(ctx, "optimizer")
