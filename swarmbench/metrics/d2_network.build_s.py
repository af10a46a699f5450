"""d2_network.build_s: seconds a run in D2NetworkEngine.build_adjacency
(the harness's wrapper): screen chunks, extraction and readbacks, the
pairs' copy to the host, exact diffs, the edge sort."""


def read(ctx):
    runs = [r for r in ctx["runs"] if r.engine]
    if not runs:
        return None
    return sum(r.engine[1] - r.engine[0] for r in runs) / len(runs)
