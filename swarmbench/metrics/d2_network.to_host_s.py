"""d2_network.to_host_s: seconds a run in the program's span
d2_network.to_host: the candidate pairs' concatenation on the card, their
copy to the host, their widening to int64 and the range check."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("d2_network.to_host",)


def read(ctx):
    return span_seconds(ctx, SPANS)
