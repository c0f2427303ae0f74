"""Host ms a batch spent blocked on the device: inside the program's spans
`service.upload` (per upload), `select.window_read` (per
`service.select`; none in deterministic mode) and `stream.fetch` (per
fetch)."""

from portbench.spans import host_ms, instances

# (span, the span that counts one a batch)
BLOCKING = (("service.upload", "service.upload"),
            ("select.window_read", "service.select"),
            ("stream.fetch", "stream.fetch"))


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    total, found = 0.0, False
    for name, per in BLOCKING:
        n = len(instances(tr, per))
        if n:
            total += host_ms(tr, name) / n
            found = True
    return 1e3 * total if found else None
