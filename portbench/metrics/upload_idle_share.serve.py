"""% of the traced stretch in which no kernel runs on the device while the
host is inside the program's span `service.upload`: how far the upload
serialises the depth-2 pipeline."""

from portbench.spans import host_idle_share


def read(ctx):
    return host_idle_share(ctx, "service.upload")
