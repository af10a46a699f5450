"""d2_network.csr_s: seconds a run in the program's span
d2_network.csr: the accepted directed edges kept, concatenated, sorted
(np.lexsort) and gathered, and the CSR counts and starts, on the host."""

from swarmbench.metrics._spans import span_seconds

SPANS = ("d2_network.csr",)


def read(ctx):
    return span_seconds(ctx, SPANS)
