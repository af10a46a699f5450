"""Shared arithmetic of the per-layer readers: program spans a run and
device time by kernel name inside the traced window."""

from swarmbench import trace


def span_seconds(ctx, names):
    """Mean seconds a run in the program's phase spans `names`, or None
    where no run recorded one of them."""
    runs = [r for r in ctx["runs"] if r.phases]
    if not runs:
        return None
    hits = [t - s for r in runs for name, s, t in r.phases if name in names]
    if not hits:
        return None
    return sum(hits) / len(runs)


def kernel_seconds(ctx, substring):
    """Device seconds of the kernels whose name holds `substring` in the
    traced window, or None where there is no trace or no such kernel."""
    if ctx["events"] is None:
        return None
    total = sum(t - s for name, s, t in trace.device_intervals(
        ctx["events"], ctx["window"]) if substring in name)
    return total / 1e6 if total > 0 else None
