"""d1_network.verified_pct: the share of the d = 1 key join's candidates
that the verify kept as pairs at distance 1, in percent: 100 x the
program's counter d1_network.pairs over d1_join_comparisons, read in
process from the record (swarm_tpu_torch.metrics) of the window's last
run; what the join lets through in vain is the rest. Every run of a
window clusters the same records, so the counts are those of every run.
None where the program keeps no such counters, or the last run failed."""

import sys

RECORD = "swarm_tpu_torch.metrics"


def read(ctx):
    record = sys.modules.get(RECORD)
    if record is None or not ctx["attempted"] or ctx["attempted"][-1].failed:
        return None
    counters = getattr(record, "last_run", {})
    candidates = counters.get("d1_join_comparisons")
    pairs = counters.get("d1_network.pairs")
    if not candidates or pairs is None:
        return None
    return 100.0 * pairs / candidates
