"""d1_network.finish_s: seconds a run in the program's span
d1_network.finish: the host's finish of the d = 1 network
(_native.d1_finish_edges: both directions of every verified pair, the
abundance rule, the edges sorted by source and target)."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("d1_network.finish",)


def read(ctx):
    return span_seconds(ctx, SPANS)
