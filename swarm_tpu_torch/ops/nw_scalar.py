"""Output-only global aligner with CIGAR backtracking.

Exact transliteration of the reference's scalar cost-space
Needleman-Wunsch-Sellers (src/nw.cc:40-191) used for `-u` H-lines:
same direction bits, same backtrack priorities (left/insert, then
diagonal, then up/delete, with gap-extension stickiness), same CIGAR RLE
(src/utils/cigar.cc:29-61). The row sweep is vectorized over columns —
the horizontal-gap recurrence is resolved with a min-plus prefix scan,
which is exact for non-negative gap-open costs.

q = seed (columns), d = member (rows). Costs: match 0, mismatch/gap > 0.
"""

from typing import Tuple

import numpy as np

MASKUP = 1
MASKLEFT = 2
MASKEXTUP = 4
MASKEXTLEFT = 8

_BIG = np.int64(1) << 40


def nw(
    dseq: np.ndarray,
    qseq: np.ndarray,
    mismatch: int,
    gapopen: int,
    gapextend: int,
) -> Tuple[int, int, str]:
    """Align dseq (rows) to qseq (columns).

    Returns (nwdiff, alignment_length, cigar) where cigar describes the
    alignment in M/D/I runs from the start (counts omitted when 1).
    """
    from .. import _native

    if _native.available():
        return _native.nw_align(dseq, qseq, mismatch, gapopen, gapextend)

    qlen = len(qseq)
    dlen = len(dseq)
    go = np.int64(gapopen)
    ge = np.int64(gapextend)

    cols = np.arange(qlen, dtype=np.int64)

    H = go + (cols + 1) * ge  # H boundary (row -1)
    E = 2 * go + (cols + 2) * ge
    dirs = np.zeros((dlen, qlen), dtype=np.uint8)

    score = np.where(
        dseq[:, None] == qseq[None, :], np.int64(0), np.int64(mismatch)
    )  # [dlen, qlen]

    for row in range(dlen):
        diag_boundary = np.int64(0) if row == 0 else go + row * ge
        top_boundary = 2 * go + (row + 2) * ge

        diag_in = np.empty(qlen, dtype=np.int64)
        diag_in[0] = diag_boundary
        diag_in[1:] = H[:-1]
        diag = diag_in + score[row]

        left = E  # value read before update
        pre = np.minimum(diag, left)

        # horizontal gap (top) via min-plus prefix scan over pre:
        # top[c] = min(boundary + c*ge, min_{k<c}(newH[k] + go + (c-k)*ge));
        # pre[k] substitutes for newH[k] exactly when go >= 0 (lazy-F).
        open_cost = pre + go - cols * ge
        running = np.minimum.accumulate(open_cost)
        top = np.empty(qlen, dtype=np.int64)
        top[0] = top_boundary
        top[1:] = np.minimum(top_boundary + cols[1:] * ge, running[:-1] + cols[1:] * ge)

        newH = np.minimum(pre, top)

        row_dirs = np.zeros(qlen, dtype=np.uint8)
        row_dirs |= np.where(top < diag, MASKUP, 0).astype(np.uint8)
        after_top = np.minimum(diag, top)
        row_dirs |= np.where(left <= after_top, MASKLEFT, 0).astype(np.uint8)

        diag2 = newH + go + ge
        left2 = left + ge
        top2 = top + ge
        row_dirs |= np.where(top2 < diag2, MASKEXTUP, 0).astype(np.uint8)
        row_dirs |= np.where(left2 < diag2, MASKEXTLEFT, 0).astype(np.uint8)

        dirs[row] = row_dirs
        H = newH
        E = np.minimum(diag2, left2)

    # --- backtrack (reference src/nw.cc:115-191) ---
    raw = []
    operation = ""
    column = qlen
    row = dlen
    matches = 0
    while column > 0 and row > 0:
        cell = dirs[row - 1, column - 1]
        if operation == "I" and (cell & MASKEXTLEFT):
            row -= 1
            raw.append("I")
        elif operation == "D" and (cell & MASKEXTUP):
            column -= 1
            raw.append("D")
        elif cell & MASKLEFT:
            row -= 1
            raw.append("I")
            operation = "I"
        elif cell & MASKUP:
            column -= 1
            raw.append("D")
            operation = "D"
        else:
            if qseq[column - 1] == dseq[row - 1]:
                matches += 1
            column -= 1
            row -= 1
            raw.append("M")
            operation = "M"
    while column > 0:
        column -= 1
        raw.append("D")
    while row > 0:
        row -= 1
        raw.append("I")

    raw.reverse()
    alength = len(raw)
    nwdiff = alength - matches
    return nwdiff, alength, compress_cigar(raw)


def compress_cigar(raw) -> str:
    """RLE compression; counts of 1 are omitted (src/utils/cigar.cc)."""
    if not raw:
        return ""
    out = []
    prev = raw[0]
    count = 1
    for ch in raw[1:]:
        if ch == prev:
            count += 1
            continue
        if count > 1:
            out.append(str(count))
        out.append(prev)
        prev = ch
        count = 1
    if count > 1:
        out.append(str(count))
    out.append(prev)
    return "".join(out)
