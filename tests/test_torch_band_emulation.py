"""Emulation of the banded score kernel's arithmetic and schedule
(swarm_tpu_torch/csrc/nw_scores.cu: nw_band_kernel and its general
variant), held exactly (integer DP: tolerance 0) against the port's
plain version, the JAX side's same-band reference and the Pallas band
kernel in interpret mode.

The CUDA kernel cannot run without a card. What can go wrong in it apart
from CUDA itself is repeated here step for step, one pair at a time as
one thread runs it: rows read as 2-bit codes 16 at a time from a 16-byte
row stride, the query held as the stream S[j] = q[j - B] whose chunks
change with the target's, a row's window as funnel shifts of
neighbouring chunks, the peeled first B + 1 rows, the main loop's 8 rows
a trip between chunk entries, slots right of the query computed
unmasked, F' = min(F + R, H + Q), no clamp until
the score is read from slot qlen - tlen + B. Every pair must equal the
clamped plain version, above the cutoff too.
"""

import numpy as np
import pytest
import torch

from swarm_tpu_torch.corpora import SCORE_PENALTIES, band_edge_cases
from swarm_tpu_torch.ops import nw_scores
from swarm_tpu_torch.ops.search_torch import DeviceAligner

INF = 1 << 28
MAX_REG_BAND = 20  # csrc/nw_scores.cu: kMaxRegBand
BAND_ROWS = 8      # csrc/nw_scores.cu: kBandRows
M32 = 0xFFFFFFFF


def pack_codes16(row, chunk):
    """csrc/dpx.cuh: pack_codes16 of the row's 16-byte chunk `chunk`;
    zeros past the stride."""
    codes = row[16 * chunk: 16 * chunk + 16]
    return sum((int(c) & 3) << (2 * j) for j, c in enumerate(codes))


def funnelshift_r(lo, hi, shift):
    return (((hi << 32) | lo) >> (shift & 31)) & M32


class QueryStream:
    """csrc/nw_scores.cu: QueryStream<B>."""

    def __init__(self, row, B):
        self.row = row
        self.nw = (2 * B + 1 + 15) // 16
        self.skip, self.shift = divmod(B, 16)
        self.last = 0
        self.next = 0
        self.s = [0] * (self.nw + 1)
        for x in range(1, self.nw + 1):
            self.s[x] = 0 if x - 1 < self.skip else self.advance()

    def advance(self):
        fresh = pack_codes16(self.row, self.next)
        self.next += 1
        word = funnelshift_r(self.last, fresh, 32 - 2 * self.shift) \
            if self.shift else fresh
        self.last = fresh
        return word

    def enter_chunk(self):
        self.s = self.s[1:] + [self.advance()]


def band_pair_emulation(q_row, t_row, ql, tl, mm, go, ge, B):
    """The score of one pair as a thread of a register variant
    (B <= 20) computes it. Rows of a 16-byte-stride store."""
    W = 2 * B + 1
    U = BAND_ROWS
    Q, R = go + ge, ge
    kf = ql - tl + B
    if ql <= 0 or tl <= 0 or not 0 <= kf < W:
        return INF
    H = [Q + (k - B - 1) * R if k - B - 1 >= 0 else INF for k in range(W)]
    E = [2 * Q + (k - B - 1) * R if k - B - 1 >= 0 else INF for k in range(W)]
    qs = QueryStream(q_row, B)
    state = {"t_codes": 0, "t_next": 0}

    def enter_chunk():
        state["t_codes"] = pack_codes16(t_row, state["t_next"])
        state["t_next"] += 1
        qs.enter_chunk()

    def row_differs(row):
        sh = 2 * (row & 15)
        tc = (((state["t_codes"] >> sh) & 3) * 0x55555555) & M32
        return [funnelshift_r(qs.s[v], qs.s[v + 1], sh) ^ tc
                for v in range(qs.nw)]

    def differs_at(x, k):
        return (x[k // 16] & (3 << (2 * (k % 16)))) != 0

    def cell(k, is_mm, F):
        e_in = E[k + 1] if k + 1 < W else INF
        diag = H[k] + (mm if is_mm else 0)
        h = min(diag, e_in, F)
        hq = h + Q
        E[k] = min(e_in + R, hq)
        H[k] = h
        F = min(F + R, hq)
        for v in (h, E[k], F):
            assert 0 <= v < 1 << 31
        return F

    def do_row(row, checked):
        x = row_differs(row)
        F = INF
        for k in range(W):
            i = row + k - B
            # only the peeled rows (the first B + 1) may meet a slot left
            # of the matrix or the slot of column 0
            assert checked or i > 0
            if checked:
                if i < 0:
                    continue
                if i == 0:
                    H[k] = 0 if row == 0 else go + row * ge
                    F = 2 * go + (row + 2) * ge
            # slots right of the query are computed like any other:
            # nothing to their left ever reads them
            F = cell(k, differs_at(x, k), F)

    row = 0

    def single_rows(until, checked):
        nonlocal row
        while row < until:
            if row & 15 == 0:
                enter_chunk()
            do_row(row, checked)
            row += 1

    single_rows(min(tl, B + 1), True)
    single_rows(min(tl, (row + U - 1) // U * U), False)
    while row + U <= tl:
        assert row % U == 0
        if row & 15 == 0:
            enter_chunk()
        for j in range(U):
            do_row(row + j, False)
        row += U
    single_rows(tl, False)
    return min(H[kf], INF)


def band_register_emulation(store, lengths, seed_id, ids, mm, go, ge, B):
    """[nb] scores as a register variant launch computes them. `store`:
    [n, stride] uint8, stride % 16 == 0."""
    assert store.shape[1] % 16 == 0 and B <= MAX_REG_BAND
    return np.array(
        [band_pair_emulation(store[seed_id], store[t], int(lengths[seed_id]),
                             int(lengths[t]), mm, go, ge, B) for t in ids],
        dtype=np.int32).reshape(len(ids))


def band_general_emulation(padded, lengths, seed_id, ids, mm, go, ge, B):
    """[nb] scores as the general variant (B > 20) computes them: bytes
    compared as they are, every slot tested and clamped."""
    W = 2 * B + 1
    Q, R = go + ge, ge
    ql = int(lengths[seed_id])
    q = padded[seed_id]
    out = []
    for tid in ids:
        tl = int(lengths[tid])
        kf = ql - tl + B
        if ql <= 0 or tl <= 0 or not 0 <= kf < W:
            out.append(INF)
            continue
        H = [Q + (k - B - 1) * R if k - B - 1 >= 0 else INF for k in range(W)]
        E = [2 * Q + (k - B - 1) * R if k - B - 1 >= 0 else INF
             for k in range(W)]
        score = INF
        for row in range(tl):
            F = INF
            for k in range(W):
                i = row + k - B
                if i < 0 or i >= ql:
                    H[k] = E[k] = INF
                    continue
                e_in = E[k + 1] if k + 1 < W else INF
                diag_in = H[k]
                if i == 0:
                    diag_in = 0 if row == 0 else go + row * ge
                    F = 2 * go + (row + 2) * ge
                diag = diag_in + (0 if q[i] == padded[tid, row] else mm)
                pre = min(diag, e_in)
                h = min(pre, F, INF)
                H[k] = h
                E[k] = min(h + Q, e_in + R, INF)
                F = min(F + R, pre + Q, INF)
                if row == tl - 1 and i == ql - 1:
                    score = h
        out.append(score)
    return np.array(out, dtype=np.int32)


def band_emulation(padded, lengths, seed_id, ids, mm, go, ge, B):
    """What banded_scores launches for this matrix and band."""
    if B > MAX_REG_BAND:
        return band_general_emulation(
            padded, lengths, seed_id, ids, mm, go, ge, B)
    n, width = padded.shape
    store = np.zeros((n, max(-(-width // 16) * 16, 16)), dtype=np.uint8)
    store[:, :width] = padded
    return band_register_emulation(
        store, lengths, seed_id, ids, mm, go, ge, B)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


CASES = list(band_edge_cases())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_band_schedule_equals_reference_and_jax(case):
    """Every pair, above the cutoff too, equals the clamped plain
    version and the JAX side's same-band reference."""
    import jax.numpy as jnp

    from swarm_tpu.ops.pallas_nw import banded_scores_reference

    name, padded, lengths, seed_id, ids, B, (mm, go, ge) = case
    got = band_emulation(padded, lengths, seed_id, ids, mm, go, ge, B)
    want = nw_scores.banded_scores(
        _t(padded), _t(lengths), seed_id, _t(ids), mm, go, ge, B).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == ids.shape
    if name.startswith("ragged"):
        assert (want < INF).any() and (want == INF).any()
    if len(ids) == 0:
        return
    nb = len(ids)
    jax_side = np.asarray(banded_scores_reference(
        jnp.asarray(np.broadcast_to(padded[seed_id], (nb, padded.shape[1]))),
        jnp.asarray(padded[ids]),
        jnp.asarray(np.full(nb, lengths[seed_id], dtype=np.int32)),
        jnp.asarray(lengths[ids]), mm, go, ge, B))
    np.testing.assert_array_equal(got, jax_side)


def test_band_edge_cases_cover_what_they_claim():
    names = [c[0] for c in CASES]
    assert len(set(names)) == len(names)
    assert {c[5] for c in CASES} >= set(range(1, 21)) | {21, 40, 63}
    assert {c[4].dtype for c in CASES} == {np.dtype(np.int32),
                                           np.dtype(np.int64)}
    assert {c[6] for c in CASES} == set(SCORE_PENALTIES)
    assert any(c[1].shape[1] % 16 for c in CASES)
    assert any(c[2][c[3]] == 0 for c in CASES)          # an empty seed
    assert any(len(c[4]) == 0 for c in CASES)           # an empty list
    for name, _, lengths, seed_id, ids, B, _ in CASES:
        if not name.startswith("B"):
            continue
        ql = int(lengths[seed_id])
        gaps = {ql - int(t) for t in lengths[ids]}
        assert {0, -B, -B - 1} <= gaps                  # in band, its edge, out
        assert 0 in lengths[ids] and 1 in lengths[ids]
    assert any(c[2][c[3]] < c[5] for c in CASES if c[0].startswith("B"))


def test_band_schedule_equals_pallas_interpret():
    """The TPU kernel this one replaces, on close pairs (exact for both)
    and far pairs (both above the cutoff)."""
    from swarm_tpu.ops.pallas_nw import (
        band_for_cutoff, make_banded_scores_pallas_band)
    from test_torch_nw_scores import _band_corpus

    mm, go, ge = 18, 24, 13
    cutoff = 3 * max(mm, go + ge)
    band = band_for_cutoff(cutoff, go, ge)
    qrows, trows, qlens, tlens = _band_corpus(P=8)
    call = make_banded_scores_pallas_band(P_TILE=8, interpret=True)
    pallas = np.asarray(call(qrows, trows, qlens, tlens, mm, go, ge, band))
    got = []
    for p in range(len(qlens)):  # one seed per launch in the port
        padded = np.stack([trows[p], qrows[p]])
        lengths = np.array([tlens[p], qlens[p]], dtype=np.int32)
        got.append(int(band_emulation(
            padded, lengths, 1, np.array([0]), mm, go, ge, band)[0]))
    got = np.array(got)
    inside = pallas <= cutoff
    assert inside.any() and (~inside).any()
    np.testing.assert_array_equal(got[inside], pallas[inside])
    assert (got[~inside] > cutoff).all()


@pytest.mark.parametrize("width,scores,fits", [
    (401, (18, 24, 13), True),
    (16384, (255, 255, 255), True),
    (401, (1 << 21, 24, 13), False),     # a state could pass 2^31
    (1 << 20, (300, 300, 300), False),
    (401, (-1, 24, 13), False),
    (401, (18, -1, 13), False),
    (401, (18, 24, -1), False),
])
def test_band_kernel_limits(width, scores, fits):
    """Penalties and widths under which the kernel's single clamp equals
    the plain version's clamp of every cell (csrc/nw_scores.cu:
    band_fits)."""
    assert nw_scores.band_fits(width, *scores) is fits


@pytest.mark.parametrize("scores", [
    (1 << 24, 24, 13), (-1, 24, 13), (18, -1, 13), (18, 24, -1)])
def test_banded_scores_refuses_penalties_outside_the_limit(scores):
    padded = torch.zeros((2, 24), dtype=torch.uint8)
    lengths = torch.tensor([24, 22], dtype=torch.int32)
    ids = torch.tensor([1])
    assert nw_scores.banded_scores(
        padded, lengths, 0, ids, 18, 24, 13, 4).tolist() == [2 * 13 + 24]
    with pytest.raises(ValueError):
        nw_scores.banded_scores(padded, lengths, 0, ids, *scores, 4)


def test_band_limit_is_tight_enough_for_the_emulation():
    """Penalties just inside the limit: the emulation's own overflow
    assertions hold and the scores equal the plain version's."""
    rng = np.random.default_rng(11)
    width = 48
    big = ((1 << 31) - INF) // (3 * width + 2 * 63 + 16) - 2
    assert nw_scores.band_fits(width, big, big // 2, big // 2 - 1)
    assert not nw_scores.band_fits(width, big + 2, 0, 0)
    padded = rng.integers(0, 4, size=(6, width)).astype(np.uint8)
    padded[1:, :40] = padded[0, :40]
    padded[2, 7] ^= 1
    lengths = np.array([40, 40, 40, 43, 36, 45], dtype=np.int32)
    ids = np.arange(1, 6)
    for mm, go, ge in ((big, big // 2, big // 2 - 1), (big, 0, big)):
        got = band_emulation(padded, lengths, 0, ids, mm, go, ge, 4)
        want = nw_scores.banded_scores(
            _t(padded), _t(lengths), 0, _t(ids), mm, go, ge, 4).numpy()
        np.testing.assert_array_equal(got, want)


def test_device_aligner_keeps_rows_at_a_16_byte_stride():
    """The band kernel reads 16 bytes at a time; the aligner's matrix has
    the caller's shape and values all the same, and both score paths
    take it."""
    rng = np.random.default_rng(5)
    padded = rng.integers(0, 4, size=(9, 37)).astype(np.uint8)
    lengths = np.array([37, 35, 37, 33, 30, 36, 37, 0, 1], dtype=np.int32)
    al = DeviceAligner(padded, lengths, torch.device("cpu"))
    assert al.padded.shape == (9, 37)
    assert al.padded.stride() == (48, 1)
    np.testing.assert_array_equal(al.padded.numpy(), padded)
    ids = np.arange(1, 9)
    plain = DeviceAligner.__new__(DeviceAligner)
    plain.device, plain.n = al.device, al.n
    plain.padded, plain.lengths = _t(padded), _t(lengths)
    for cutoff in (None, 74, 30 * 37):
        np.testing.assert_array_equal(
            al.scores(0, ids, 18, 24, 13, cutoff=cutoff),
            plain.scores(0, ids, 18, 24, 13, cutoff=cutoff))
