"""% of the card's bf16 peak: the FLOPs a trained graph needs, forward and
backward (work.py's count from the configuration), times the graphs
trained a second over the traced stretch."""

from portbench import work
from portbench.readers import traced_rate


def read(ctx):
    rate = traced_rate(ctx)
    if not rate:
        return None
    flops = work.train_flops_per_graph(ctx["config"], ctx["traffic"])
    return 100.0 * flops * rate / work.PEAK_BF16
