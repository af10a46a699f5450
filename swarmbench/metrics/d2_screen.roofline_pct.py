"""d2_screen.roofline_pct: the q-gram screen's least time over its
device time in the traced window, in percent.

Least time: the operations the corpus needs, 2 x 1,024 int8 products a
pair (the +-1 dot of two 1,024-bit profiles), for each unordered pair
whose lengths differ by at most d (no other pair can lie within d
differences), over the card's int8 tensor-core peak. The count depends
on n, d and the lengths alone, whatever computes the screen."""

import torch

from swarmbench.metrics._spans import kernel_seconds

KERNEL = "d2_screen_kernel"
OPS_PER_PAIR = 2 * 1024
PEAK = "int8_ops_per_s"


def pairs_within(lengths, d):
    """Unordered pairs of rows whose lengths differ by at most d."""
    hist = torch.bincount(lengths.to(torch.int64)).to(torch.float64)
    pairs = float((hist * (hist - 1) / 2).sum())
    for delta in range(1, d + 1):
        pairs += float((hist[:-delta] * hist[delta:]).sum())
    return pairs


def read(ctx):
    seconds = kernel_seconds(ctx, KERNEL)
    if seconds is None or not ctx["runs"]:
        return None
    ops = OPS_PER_PAIR * pairs_within(ctx["corpus"].lengths, ctx["d"])
    least = len(ctx["runs"]) * ops / ctx["peaks"][PEAK]
    return 100.0 * least / seconds
