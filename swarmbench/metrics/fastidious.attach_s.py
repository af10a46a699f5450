"""fastidious.attach_s: seconds a run in the progress phase "Grafting light
swarms on heavy swarms": the host's grafting loop (the pairs sorted,
each light swarm's members appended to its heavy swarm once)."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("Grafting light swarms on heavy swarms",)


def read(ctx):
    return span_seconds(ctx, SPANS)
