"""d2_diffs.kernel_ms: device milliseconds a run of the exact-diffs
kernels (d2_diffs_kernel, every band variant) in the traced window."""

from swarmbench.metrics._spans import kernel_seconds

KERNEL = "d2_diffs_kernel"


def read(ctx):
    seconds = kernel_seconds(ctx, KERNEL)
    if seconds is None or not ctx["runs"]:
        return None
    return 1e3 * seconds / len(ctx["runs"])
