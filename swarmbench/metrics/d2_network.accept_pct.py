"""d2_network.accept_pct: the share of the exact diffs' directed
alignments that became an edge, in percent: 100 x the program's counter
d2_network.edges over d2_network.alignments, read in process from the
record (swarm_tpu_torch.metrics) of the window's last run. Every run of
a window clusters the same records, so the counts are those of every
run. None where the program keeps no such counters, or the last run
failed."""

import sys

RECORD = "swarm_tpu_torch.metrics"


def read(ctx):
    record = sys.modules.get(RECORD)
    if record is None or not ctx["attempted"] or ctx["attempted"][-1].failed:
        return None
    counters = getattr(record, "last_run", {})
    alignments = counters.get("d2_network.alignments")
    edges = counters.get("d2_network.edges")
    if not alignments or edges is None:
        return None
    return 100.0 * edges / alignments
