"""5-mer qgram parity profiles and popcount distances.

Reference: src/qgram.cc — each sequence gets a 1024-bit vector where bit
b is the XOR-parity of occurrences of 5-mers whose low 10 bits equal b;
half the Hamming distance between two vectors, divided by the qgram
length (ceil), lower-bounds the edit distance:
mindiff = (diffbits + 2*5 - 1) / (2*5).

Profiles are stored bit-packed ([n, 16] uint64) and distances computed
with XOR + popcount (np.bitwise_count) — the same memory layout the
reference's SIMD loop uses (src/qgram.cc:104-236). The per-seed screen
stays on the host: the d>=2 engine's data dependence makes each screen
a latency-bound matvec, which the CPU wins; the expensive survivors go
to the device alignment screen instead (models/general.py).
"""

import numpy as np

QGRAM_LENGTH = 5
VECTOR_BITS = 1024
WORDS = VECTOR_BITS // 64


def qgram_profiles(padded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """[n, 16] uint64 bit-packed parity profiles."""
    from .. import _native

    n, max_len = padded.shape
    if n == 0 or max_len < QGRAM_LENGTH:
        return np.zeros((n, WORDS), dtype=np.uint64)
    if _native.available():
        return _native.qgram_profiles_native(padded, lengths)
    codes = padded.astype(np.int64)
    # value at position p (p >= 4): low 10 bits of the rolling 5-mer
    vals = np.zeros((n, max_len), dtype=np.int64)
    for k in range(QGRAM_LENGTH):
        shifted = np.zeros_like(codes)
        shifted[:, k:] = codes[:, : max_len - k] << (2 * k)
        vals += shifted
    vals &= VECTOR_BITS - 1

    pos = np.arange(max_len)
    mask = (pos[None, :] < lengths[:, None]) & (pos[None, :] >= QGRAM_LENGTH - 1)

    seq_ids = np.broadcast_to(np.arange(n)[:, None], vals.shape)
    flat_vals = (vals + seq_ids * VECTOR_BITS)[mask]
    counts = np.bincount(flat_vals, minlength=n * VECTOR_BITS)
    bits = (counts.reshape(n, VECTOR_BITS) & 1).astype(np.uint64)
    shifts = (np.arange(VECTOR_BITS, dtype=np.uint64) % 64).reshape(1, WORDS, 64)
    return np.bitwise_or.reduce(
        bits.reshape(n, WORDS, 64) << shifts, axis=2
    )


def qgram_mindiff(profiles: np.ndarray, seed: int, targets: np.ndarray) -> np.ndarray:
    """Lower-bound edit distances between `seed` and each target."""
    if len(targets) == 0:
        return np.zeros(0, dtype=np.int64)
    x = profiles[seed][None, :] ^ profiles[targets]
    diffs = np.bitwise_count(x).sum(axis=1).astype(np.int64)
    return (diffs + 2 * QGRAM_LENGTH - 1) // (2 * QGRAM_LENGTH)
