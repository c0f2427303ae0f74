"""Device ms a step launched inside the program's span `train.backward`
(by launch time: autograd launches from its own thread)."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, ["train.backward"], "train.backward")
