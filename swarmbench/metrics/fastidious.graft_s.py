"""fastidious.graft_s: seconds a run in the program's span
fastidious.graft: the graft candidate of every light amplicon, by
whichever engine takes them (the card's GraftEngine in a run on the
card)."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("fastidious.graft",)


def read(ctx):
    return span_seconds(ctx, SPANS)
