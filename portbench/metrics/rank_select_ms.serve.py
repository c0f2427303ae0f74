"""Device ms a batch launched inside the program's spans `service.rank`
(the similarities against the table) and `service.select` (the windowed
or full selection), per instance of `service.rank`."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, ["service.rank", "service.select"],
                     "service.rank")
