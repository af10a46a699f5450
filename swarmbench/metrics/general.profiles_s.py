"""general.profiles_s: seconds a run in the program's phase span of the
q-gram profiles: the host's profiles and the network engine's
construction (padding, copies of profiles and lengths to the card)."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("Find qgram vects:",)


def read(ctx):
    return span_seconds(ctx, SPANS)
