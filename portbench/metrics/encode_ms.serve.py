"""Device ms a batch under the node encoder's forward (its module's
forward hooks: `model.feature_extractor`, or `model.encoder` for the
ViT)."""

from portbench.readers import range_ms


def read(ctx):
    return range_ms(ctx, "encode")
