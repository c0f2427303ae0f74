"""% of the card's bf16 peak: the FLOPs a served query needs (work.py's
count from the configuration) times the queries served a second over the
traced stretch."""

from portbench import work
from portbench.readers import traced_rate


def read(ctx):
    rate = traced_rate(ctx)
    if not rate:
        return None
    flops = work.serve_flops_per_query(ctx["config"], ctx["traffic"])
    return 100.0 * flops * rate / work.PEAK_BF16
