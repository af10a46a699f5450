"""d1_network.build_s: seconds a run in the program's span
d1_network.build: NeighborIndex.build_network, from the key count's
readback to the directed edges sorted on the host (the native builder's
whole network where it takes the corpus)."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("d1_network.build",)


def read(ctx):
    return span_seconds(ctx, SPANS)
