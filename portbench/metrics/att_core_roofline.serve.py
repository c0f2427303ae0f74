"""% of its roofline that kernel #1, the attention core, reaches: its
bound a call (work.py, from E and C) over its mean device time a call,
from the trace by kernel name."""

from portbench import work

KERNEL = "att_core_kernel"


def read(ctx):
    tr = ctx.get("trace")
    calls = [] if tr is None else tr.kernel_calls(KERNEL)
    if not calls:
        return None
    c = ctx["config"]["model"]["node_dim"] // 8
    bound = work.att_core_bound_s(ctx["edges_per_batch"], c,
                                  ctx["att_core_in_bytes"])
    return 100.0 * bound * len(calls) / sum(calls)
