"""db.read_s: seconds a run in the database read: the program's phase
spans (SWARM_TPU_TRACE) of reading, indexing and the abundance sort."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("Reading sequences:", "Indexing database:", "Abundance sorting:")


def read(ctx):
    return span_seconds(ctx, SPANS)
