"""What the readers of the program's own spans share.

The program marks its stages with profiler ranges named `relpose.<stage>`
(`relpose_gnn_tpu_torch/utils/profiling.py::span`, which lists them).
They land in the traced stretch (`trace.Trace`) as host events beside the
device's kernels and copies, on the same clock.  A device op belongs to a
span when the host call that launched it (matched by correlation id) fell
inside the span's time, on whatever thread: the backward's kernels launch
from autograd's thread inside `train.backward`.

Each reader gives a value per instance of its span, or None where the
stretch holds no such span (a program without spans reads nothing) or, for
device time, no device op launched inside one.
"""

from __future__ import annotations

import bisect

from portbench.trace import _clip, _union

PREFIX = "relpose."


def instances(tr, name: str) -> list:
    """[(start, end)] of every instance of span `name`, in start order."""
    full = PREFIX + name
    return sorted((s, e) for n, s, e, c in tr.host
                  if c == "user_annotation" and n == full)


def device_s(tr, names) -> float | None:
    """Device seconds of the ops launched inside any instance of spans
    `names`; None where none of them is in the stretch."""
    inside = _union(iv for n in names for iv in instances(tr, n))
    if not inside:
        return None
    starts = [s for s, _ in inside]
    total = 0.0
    for _, _, s, e, corr in tr.device:
        t = tr.launch.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= inside[i][1]:
            total += e - s
    return total


def device_ms(ctx: dict, names, per: str):
    """Device ms of the ops launched inside spans `names`, per instance of
    span `per`; None where there is nothing to read."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    n = len(instances(tr, per))
    total = device_s(tr, names)
    if not n or not total:
        return None
    return 1e3 * total / n


def host_ms(tr, name: str) -> float:
    """Host seconds inside every instance of span `name`, summed."""
    return sum(e - s for s, e in instances(tr, name))


def host_idle_share(ctx: dict, name: str):
    """% of the traced stretch with no kernel running on the device while
    the host is inside span `name` (None where the stretch ran no kernel,
    as `readers.idle_share`)."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.kernels():
        return None
    spans = _union(instances(tr, name))
    if not spans:
        return None
    busy = sum(_clip(spans, s, e)
               for s, e in _union((d[2], d[3]) for d in tr.kernels()))
    return 100.0 * (_clip(spans, *tr.window) - busy) / tr.window_s


def contained(tr, outer: str, name: str) -> list:
    """The instances of span `name` that lie inside an instance of span
    `outer`."""
    outers = instances(tr, outer)
    return [(s, e) for s, e in instances(tr, name)
            if any(a <= s and e <= b for a, b in outers)]
