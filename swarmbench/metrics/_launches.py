"""Device time of the kernels that the program launched inside some of
its spans, in the traced window.

Each kernel event of the trace carries the correlation id of the host
call that launched it (cudaLaunchKernel and its kin, on the host's
clock); a kernel counts where that call lies inside one of the spans'
ranges, which the trace holds because every program span is a
torch.profiler record_function range while the profiler runs. The
kernel's name does not decide: one kernel (d1_partition_*) serves both
the d = 1 network and the graft."""

import bisect

from swarmbench import trace

#: categories of the host calls that launch device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _correlation(event):
    return (event.get("args") or {}).get("correlation")


def span_ranges(events, names):
    """Merged [(start, end)] of the program spans named one of `names`."""
    return trace.union(
        (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and e.get("name") in names)


def launched_kernel_seconds(ctx, names):
    """Device seconds of the kernels launched inside the spans `names`
    in the traced window, or None where there is no trace, no such span
    or no such kernel."""
    events = ctx["events"]
    if events is None:
        return None
    ranges = span_ranges(events, names)
    if not ranges:
        return None
    launched = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = _correlation(e)
            if corr is not None:
                launched[corr] = float(e["ts"])
    starts = [s for s, _ in ranges]
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        at = launched.get(_correlation(e))
        if at is None:
            continue
        k = bisect.bisect_right(starts, at) - 1
        if k >= 0 and at <= ranges[k][1]:
            total += float(e.get("dur", 0.0))
    return total / 1e6 if total > 0 else None


def launched_kernel_ms(ctx, names):
    """launched_kernel_seconds in milliseconds a run of the window."""
    seconds = launched_kernel_seconds(ctx, names)
    if seconds is None or not ctx["runs"]:
        return None
    return 1e3 * seconds / len(ctx["runs"])
