"""d1.writers_s: seconds a run in the progress phases of the d = 1 writers,
summed: "Writing swarms", "Writing seeds", "Writing structure", "Writing
UCLUST" and "Writing stats", each where its option is given."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("Writing swarms:", "Writing seeds:", "Writing structure:",
         "Writing UCLUST:", "Writing stats:")


def read(ctx):
    return span_seconds(ctx, SPANS)
