"""d1_network.kernel_ms: device milliseconds a run of the kernels the
program launched inside its spans d1_network.start and d1_network.build
(the d = 1 network: keygen, partition, join, dedup, verify), in the
traced window, each kernel tied to its launch by the trace's
correlation ids."""

from swarmbench.metrics._launches import launched_kernel_ms

SPANS = ("d1_network.start", "d1_network.build")


def read(ctx):
    return launched_kernel_ms(ctx, SPANS)
