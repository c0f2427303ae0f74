"""Device ms a batch under the NetVLAD encoder's forward (VGG16 +
NetVLAD, `service.netvlad`'s forward hooks)."""

from portbench.readers import range_ms


def read(ctx):
    return range_ms(ctx, "retrieval_trunk")
