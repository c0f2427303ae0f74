"""Device ms a step launched inside the program's span `feed.gather`
(`DeviceCachedFeed`: the batch's index_select and normalisation)."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, ["feed.gather"], "feed.gather")
