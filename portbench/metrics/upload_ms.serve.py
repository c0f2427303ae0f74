"""Device ms a batch of the copies launched inside the program's span
`service.upload` (the pageable host-to-device copy of the query batch)."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, ["service.upload"], "service.upload")
