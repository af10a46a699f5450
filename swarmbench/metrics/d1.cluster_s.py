"""d1.cluster_s: seconds a run in the progress phase "Clustering": the
breadth-first growth of the swarms over the network
(_native.bfs_cluster)."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("Clustering:",)


def read(ctx):
    return span_seconds(ctx, SPANS)
