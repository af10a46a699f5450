"""amplicons_per_s: all amplicons clustered by the window's runs over the
sum of those runs' wall times (each from main.run called to its return),
failed runs' time included and their amplicons not."""


def read(ctx):
    seconds = sum(r.seconds for r in ctx["attempted"])
    if not seconds:
        return None
    return ctx["corpus"].n * len(ctx["runs"]) / seconds
