"""Host ms a batch inside the program's span `service.query` outside its
child spans `service.upload` and `select.window_read`: the Python and
launch cost of enqueuing a batch."""

from portbench.spans import contained, host_ms, instances


def read(ctx):
    tr = ctx.get("trace")
    queries = [] if tr is None else instances(tr, "service.query")
    if not queries:
        return None
    blocked = sum(e - s for name in ("service.upload", "select.window_read")
                  for s, e in contained(tr, "service.query", name))
    return 1e3 * (host_ms(tr, "service.query") - blocked) / len(queries)
