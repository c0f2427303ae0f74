"""The 95th percentile of a request's host-clock time over every request
handed in the traced run's window (the driver's `request_p95_ms`), as a
per-layer reading: in a cell whose runs spread too widely for it to carry
a bound end to end."""


def read(ctx):
    return ctx.get("request_p95_ms")
