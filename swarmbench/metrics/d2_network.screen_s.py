"""d2_network.screen_s: seconds a run in the program's span
d2_network.screen: the network engine's chunk loop (tile-index uploads,
screen launches, each chunk's scan and the readback of its total, the
extraction)."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("d2_network.screen",)


def read(ctx):
    return span_seconds(ctx, SPANS)
