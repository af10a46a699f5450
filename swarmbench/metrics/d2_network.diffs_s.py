"""d2_network.diffs_s: seconds a run in the program's span
d2_network.diffs: the exact diffs of the candidate pairs (directions, the
tasks' upload, the kernel or the native diffs, the readback, the
scatter into both directions)."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("d2_network.diffs",)


def read(ctx):
    return span_seconds(ctx, SPANS)
