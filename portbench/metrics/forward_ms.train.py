"""Device ms a step launched inside the program's span `train.forward`
(the model in train mode and the loss)."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, ["train.forward"], "train.forward")
