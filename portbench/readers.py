"""What the per-layer metric readers under `metrics/` share.  A reader
returns None where it finds nothing to read, never 0."""

from __future__ import annotations


def idle_share(ctx: dict):
    """% of the traced stretch in which no kernel ran on the device
    (copies and memsets count as idle)."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.kernels():
        return None
    return 100.0 * (1.0 - tr.busy_s(kernels_only=True) / tr.window_s)


def traced_rate(ctx: dict):
    """Queries or graphs a second over the traced stretch: its steps'
    work over its length (the profiler's cost stays in the rest of a
    traced window, so the window's own rate reads low)."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or not ctx.get("steps_traced"):
        return None
    return ctx["per_step"] * ctx["steps_traced"] / tr.window_s


def range_ms(ctx: dict, name: str):
    """Device ms of the kernels launched inside the harness's range
    `name`, per instance of the range."""
    tr = ctx.get("trace")
    got = None if tr is None else tr.range_device_s(name)
    if not got or got[1] == 0 or got[0] <= 0:
        return None
    return 1e3 * got[0] / got[1]
