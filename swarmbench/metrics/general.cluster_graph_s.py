"""general.cluster_graph_s: seconds a run in the program's span
general.cluster_graph: the graph replay (_native.algo_cluster_graph)
after the network engine."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("general.cluster_graph",)


def read(ctx):
    return span_seconds(ctx, SPANS)
