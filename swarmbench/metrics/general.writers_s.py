"""general.writers_s: seconds a run in the program's spans of the
d>=2 writers, summed: -i, -u, -s, -o and -w (from collecting the seeds
to the end of writing them), each where its option is given."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("general.write_structure", "general.write_uclust",
         "general.write_stats", "general.write_swarms",
         "general.write_seeds")


def read(ctx):
    return span_seconds(ctx, SPANS)
