"""fastidious.kernel_ms: device milliseconds a run of the kernels the
program launched inside its span fastidious.graft (the graft's keygen,
partition, join and verify), in the traced window, each kernel tied to
its launch by the trace's correlation ids."""

from swarmbench.metrics._launches import launched_kernel_ms

SPANS = ("fastidious.graft",)


def read(ctx):
    return launched_kernel_ms(ctx, SPANS)
