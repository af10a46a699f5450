"""device.idle_pct: the share of the traced window (the program's runs)
in which no kernel, copy or memset ran on the card, in percent."""

from swarmbench import trace


def read(ctx):
    if ctx["events"] is None:
        return None
    ops = trace.device_intervals(ctx["events"], ctx["window"])
    if not ops:
        return None
    busy = trace.busy_seconds(trace.union(ops))
    return 100.0 * (1.0 - busy / trace.span_seconds(ctx["window"]))
