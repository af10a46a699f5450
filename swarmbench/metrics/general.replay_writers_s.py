"""general.replay_writers_s: seconds a run from the return of the
network engine's build_adjacency (the harness's wrapper) to the run's
end: the graph replay (algo_cluster_graph) and the writers."""


def read(ctx):
    runs = [r for r in ctx["runs"] if r.engine]
    if not runs:
        return None
    return sum(r.end - r.engine[1] for r in runs) / len(runs)
