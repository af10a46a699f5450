"""d1.dup_check_s: seconds a run in the progress phase "Hashing sequences":
the duplicate check (the native scan of the arena), while the card
counts the keys and packs the rows."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("Hashing sequences:",)


def read(ctx):
    return span_seconds(ctx, SPANS)
