"""Device ms a batch launched inside the program's span `service.gnn`
(`anchored_pose_step`: the GNN, kernel #1 and the anchored pose)."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, ["service.gnn"], "service.gnn")
