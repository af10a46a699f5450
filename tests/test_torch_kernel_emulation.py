"""numpy emulations of the schedules of the port's CUDA kernels, held
exactly (integer DPs: tolerance 0) against the plain PyTorch versions
and the JAX side.

The CUDA kernels (swarm_tpu_torch/csrc/*.cu) cannot run without a card.
What can go wrong in them apart from CUDA itself is their arithmetic:
the packed (cost, priority, count) word of the d2_diffs register
variants, and the skewed wavefront of the full-row score kernel. The
functions here repeat that arithmetic step for step in numpy; each
names the kernel code it mirrors. The tests below run them on the
corpora chip_smoke.py and test_torch_cuda.py put to the kernels
themselves. Also here: DeviceDiffEngine with its 16-byte row stride
against swarm_tpu's engine.
"""

import numpy as np
import pytest
import torch

from swarm_tpu_torch.corpora import (
    D2_DIFFS_BAND_CASES,
    D2_DIFFS_KERNEL_CASES,
    chain_corpus,
    make_db,
    ragged_rows,
    score_edge_cases,
)
from swarm_tpu_torch.ops import nw_scores
from swarm_tpu_torch.ops.d2_diffs import (
    DeviceDiffEngine,
    d2_diffs,
    d2_diffs_reference,
    directions,
    row_stride_16,
    task_layout,
)
from swarm_tpu_torch.ops.nw_scores import FULL_STRIPS

# ---- d2_diffs register variants (csrc/d2_diffs.cu: d2_task_packed) ----

DIFF_BITS = 9
PRIO_SHIFT = DIFF_BITS
COST_SHIFT = DIFF_BITS + 2
DIFF_MASK = (1 << DIFF_BITS) - 1
PRIO_MASK = 3 << PRIO_SHIFT
INF_COST = 1 << 18
COST_LIMIT = 1 << 20


def pack(cost, prio, diff):
    return (cost << COST_SHIFT) | (prio << PRIO_SHIFT) | diff


def packed_variant_fits(B, stride, mm, go, ge, d):
    """The rule of swarm_d2_diffs (csrc/d2_diffs.cu: packed_fits)."""
    Q = go + ge
    big = max(mm, Q)
    cutoff = d * big
    if B > 20 or mm < 1 or ge < 1 or go < 0:
        return False
    if cutoff > 500 * min(mm, ge) or cutoff + 4 * big >= INF_COST:
        return False
    growth = (stride + 2 * B + 8) * (big + 1) + 4 * Q
    return INF_COST + growth < COST_LIMIT


def d2_diffs_packed_emulation(tq, td, qlens, dlens, B, mm, go, ge, d):
    """diffs[N] as the packed register variant computes them.

    tq/td: [N, L] uint8 code rows (0..3); qlens/dlens: [N]. One int per
    state: cost << 11 | priority << 9 | count. A three-way min of
    (E: priority 1, diagonal: 2, F: 3) picks the scan's winner and
    carries its count; the H-derived candidate of the E and F updates
    has priority 0, so it wins their ties. No clamp to INF.
    """
    W = 2 * B + 1
    Q, R = go + ge, ge
    cutoff = d * max(mm, Q)
    N = tq.shape[0]
    ql = qlens.astype(np.int64)
    dl = dlens.astype(np.int64)
    active = (ql > 0) & (dl > 0) & (np.abs(ql - dl) <= B)
    MMC = (mm << COST_SHIFT) + 1
    cA = (Q << COST_SHIFT) + 1 - (2 << PRIO_SHIFT)
    cR = (R << COST_SHIFT) + 1
    INFH, INFE, INFF = (pack(INF_COST, p, 0) for p in (2, 1, 3))

    H = [np.full(N, INFH, dtype=np.int64) for _ in range(W)]
    E = [np.full(N, INFE, dtype=np.int64) for _ in range(W)]
    for k in range(W):
        im1 = k - B - 1
        if im1 >= 0:
            ok = im1 < ql
            H[k] = np.where(ok, pack(Q + im1 * R, 2, im1 + 1), INFH)
            E[k] = np.where(ok, pack(2 * Q + im1 * R, 1, im1 + 2), INFE)

    L = tq.shape[1]
    # past the row's stride the kernel reads zeros
    codes_q = np.zeros((N, L + 2 * W + 2), dtype=np.uint8)
    codes_q[:, :L] = tq & 3
    for row in range(int(dl[active].max()) if active.any() else 0):
        live = active & (row < dl)
        dch = td[:, min(row, L - 1)] & 3
        F = np.full(N, INFF, dtype=np.int64)
        for k in range(W):
            i = row + k - B
            # only the kernel's checked rows (the first B + 1) may meet
            # a slot left of the matrix or the slot of column 0
            assert i > 0 or row <= B
            if i < 0:
                continue
            h_in = H[k]
            if i == 0:
                h_in = np.full(N, pack(0 if row == 0 else go + row * ge, 2,
                                       row), dtype=np.int64)
                F = np.full(N, pack(2 * go + (row + 2) * ge, 3, row + 2),
                            dtype=np.int64)
            e_in = E[k + 1] if k + 1 < W else np.full(N, INFE, dtype=np.int64)
            diag = h_in + np.where(codes_q[:, i] != dch, MMC, 0)
            hn = np.minimum(np.minimum(e_in, diag), F)
            hst = (hn & ~PRIO_MASK) | (2 << PRIO_SHIFT)
            a = hst + cA
            en = np.minimum(e_in + cR, a) | (1 << PRIO_SHIFT)
            fn = np.minimum(F + cR, a) | (3 << PRIO_SHIFT)
            # slots right of the query are computed like any other:
            # nothing to their left ever reads them
            H[k] = np.where(live, hst, H[k])
            E[k] = np.where(live, en, E[k])
            F = np.where(live, fn, F)
            for state in (H[k], E[k], F):
                assert 0 <= state.min() and state.max() < 1 << 31
    kf = np.clip(ql - dl + B, 0, W - 1)
    final = np.stack(H, axis=1)[np.arange(N), kf]
    cost = final >> COST_SHIFT
    diff = final & DIFF_MASK
    ok = active & (cost <= cutoff) & (diff <= d)
    return np.where(ok, diff, -1).astype(np.int32)


# ---- full-row scores (csrc/nw_scores.cu: nw_full_kernel) ----

INF = 1 << 28


def strip_for_width(width, strips=FULL_STRIPS):
    for C in strips:
        if 32 * C >= width:
            return C
    return strips[-1]


def wavefront_scores_emulation(padded, lengths, seed_id, target_ids, mm, go,
                               ge, strips=FULL_STRIPS):
    """[nb] int32 scores as the wavefront kernel computes them.

    Lane l of 32 owns C consecutive query columns. At step t it computes
    target row t - l over its strip, left to right, with F a carried
    value; after the step it hands its last column's new H and its F to
    lane l + 1. A pass covers 32 * C columns; the last lane's hand-over
    of a pass is kept per row and read by lane 0 of the next pass. All
    pairs of the list advance together here (one more numpy axis); in
    the kernel each warp walks its own pairs.
    """
    width = padded.shape[1]
    C = strip_for_width(width, strips)
    Q, R = go + ge, ge
    ids = np.asarray(target_ids, dtype=np.int64)
    nb = len(ids)
    ql = int(lengths[seed_id])
    tls = lengths[ids].astype(np.int64)
    out = np.full(nb, INF, dtype=np.int64)
    if nb == 0 or ql <= 0:
        return out.astype(np.int32)
    q = padded[seed_id]
    rows = padded[ids]
    lane = np.arange(32)
    npass = -(-ql // (32 * C))
    max_tl = int(tls.max())
    sH = np.zeros((nb, max(max_tl, 1)), dtype=np.int64)
    sF = np.zeros((nb, max(max_tl, 1)), dtype=np.int64)
    pair = np.arange(nb)
    for p in range(npass):
        col0 = p * 32 * C + lane * C                      # [32]
        cols = col0[:, None] + np.arange(C)[None, :]      # [32, C]
        qc = np.where(cols < ql, q[np.minimum(cols, width - 1)], 255)
        H = np.broadcast_to(Q + cols * R, (nb, 32, C)).copy()
        E = np.broadcast_to(2 * Q + cols * R, (nb, 32, C)).copy()
        hprev = np.broadcast_to(
            np.where(col0 == 0, 0, Q + (col0 - 1) * R), (nb, 32)).copy()
        final = p == npass - 1
        last = ql - 1 - p * 32 * C
        lq, cq = (last // C, last % C) if final else (31, C - 1)
        hout = np.zeros((nb, 32), dtype=np.int64)
        fout = np.zeros((nb, 32), dtype=np.int64)
        tc = np.zeros((nb, 32), dtype=np.int64)
        for t in range(max_tl + lq):
            # hand-over from lane l - 1 (what it published last step)
            hin = np.roll(hout, 1, axis=1)
            fin = np.roll(fout, 1, axis=1)
            tc = np.roll(tc, 1, axis=1)
            r = t - lane                                   # [32]
            tt = min(t, rows.shape[1] - 1)
            tc[:, 0] = np.where(t < tls, rows[:, tt], 0)
            if p == 0:
                hin[:, 0] = go + (t + 1) * ge
                fin[:, 0] = 2 * go + (t + 2) * ge
            else:
                ts = np.minimum(t, sH.shape[1] - 1)
                hin[:, 0] = sH[:, ts]
                fin[:, 0] = sF[:, ts]
            act = (r[None, :] >= 0) & (r[None, :] < tls[:, None])  # [nb, 32]
            F = fin.copy()
            dg = hprev.copy()
            Hn, En = H.copy(), E.copy()
            for c in range(C):
                V = np.where(qc[None, :, c] != tc, mm, 0)
                diag = dg + V
                dg = H[:, :, c]
                pre = np.minimum(diag, E[:, :, c])
                h = np.minimum(pre, F)
                hq = h + Q
                En[:, :, c] = np.minimum(E[:, :, c] + R, hq)
                F = np.minimum(F + R, hq)  # = min(F + R, pre + Q): Q >= R
                Hn[:, :, c] = h
            H = np.where(act[:, :, None], Hn, H)
            E = np.where(act[:, :, None], En, E)
            hprev = np.where(act, hin, hprev)
            hout = np.where(act, H[:, :, C - 1], hout)
            fout = np.where(act, F, fout)
            if not final:
                w = act[:, 31]
                rr = np.clip(t - 31, 0, sH.shape[1] - 1)
                sH[w, rr] = hout[w, 31]
                sF[w, rr] = fout[w, 31]
            else:
                done = act[:, lq] & (r[lq] == tls - 1)
                out[done] = H[pair[done], lq, cq]
    out[tls <= 0] = INF
    return out.astype(np.int32)


# ---- tests ----

SMALL_STRIPS = (1, 2, 4)  # edges at 32, 64, 128 columns; passes of 128
EDGE_CASES = list(score_edge_cases(SMALL_STRIPS))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_wavefront_equals_reference_and_jax_on_edge_lengths(case):
    """Strip ownership, step-to-row map, hand-over at strip edges and
    between passes, masking: lengths 1, 31, 32, 33 and around 32 * C,
    targets longer and shorter than the seed, an empty row, a
    one-element list."""
    import jax.numpy as jnp

    from swarm_tpu.ops.search_jax import nw_scores_device

    name, padded, lengths, seed_id, ids = case
    mm, go, ge = ((4, 12, 4), (18, 24, 13), (1, 1, 1))[len(name) % 3]
    got = wavefront_scores_emulation(
        padded, lengths, seed_id, ids, mm, go, ge, SMALL_STRIPS)
    want = nw_scores.nw_scores_reference(
        _t(padded), _t(lengths), seed_id, _t(ids), mm, go, ge).numpy()
    np.testing.assert_array_equal(got, want)
    jax_side = np.asarray(nw_scores_device(
        jnp.asarray(padded), jnp.asarray(lengths), jnp.int32(seed_id),
        jnp.asarray(ids.astype(np.int32)), jnp.int32(mm), jnp.int32(go),
        jnp.int32(ge)))
    filled = lengths[ids] > 0  # the port reports INF for an empty target
    np.testing.assert_array_equal(got[filled], jax_side[filled])
    assert (got[~filled] == INF).all()


@pytest.mark.parametrize("ql", [401, 416, 417])
def test_wavefront_at_the_kernels_own_strips(ql):
    """The strips the kernel is built with, at amplicon length: C = 13
    up to 416 columns, C = 16 above."""
    rng = np.random.default_rng(ql)
    t_lens = [ql - 9, ql - 1, ql, 0, 33]
    padded = rng.integers(0, 4, size=(len(t_lens) + 1, ql)).astype(np.uint8)
    for i in range(1, len(t_lens) + 1):
        keep = rng.random(ql) < 0.95
        padded[i] = np.where(keep, padded[0], padded[i])
    lengths = np.array([ql] + t_lens, dtype=np.int32)
    ids = np.arange(1, len(lengths), dtype=np.int64)
    assert strip_for_width(ql) == (13 if ql <= 416 else 16)
    got = wavefront_scores_emulation(padded, lengths, 0, ids, 18, 24, 13)
    want = nw_scores.nw_scores_reference(
        _t(padded), _t(lengths), 0, _t(ids), 18, 24, 13).numpy()
    np.testing.assert_array_equal(got, want)


def test_wavefront_equals_pallas_interpret():
    from swarm_tpu.ops.pallas_nw import make_banded_scores_pallas
    from test_pallas_nw import _pairs

    mm, go, ge = 18, 24, 13
    qrows, trows, qlens, tlens = _pairs(3, P=16, W=128)
    call = make_banded_scores_pallas(P_TILE=8, interpret=True)
    want = np.asarray(call(qrows, trows, qlens, tlens, mm, go, ge))
    got = []
    for p in range(len(qlens)):  # one seed per launch in the port
        padded = np.stack([trows[p], qrows[p]])
        lengths = np.array([tlens[p], qlens[p]], dtype=np.int32)
        got.append(int(wavefront_scores_emulation(
            padded, lengths, 1, np.array([0]), mm, go, ge)[0]))
    np.testing.assert_array_equal(np.array(got), want)


@pytest.mark.parametrize("seed,d,scores", D2_DIFFS_KERNEL_CASES)
def test_packed_word_equals_reference_on_tie_corpora(tmp_path, seed, d,
                                                     scores):
    """The packed (cost, priority, count) word makes the scan's
    tie-breaks: every ordered pair of the tie-heavy chain corpora."""
    mm, go, ge = scores
    db = make_db(tmp_path, chain_corpus(seed, 50, 48, d + 1))
    eng = DeviceDiffEngine(db, d, torch.device("cpu"))
    pa, pb = np.triu_indices(len(db), k=1)
    tq = np.concatenate([pa, pb])
    td = np.concatenate([pb, pa])
    B = eng.band_for_exact(d * max(mm, go + ge), go, ge)
    rows, lens = eng.rows.numpy(), eng.lens.numpy()
    want = d2_diffs_reference(
        eng.rows[tq], eng.rows[td], eng.lens[tq], eng.lens[td], B, eng.Lmax,
        mm, go, ge, d).numpy()
    got = d2_diffs_packed_emulation(
        rows[tq], rows[td], lens[tq], lens[td], B, mm, go, ge, d)
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).any() and (want < 0).any()


@pytest.mark.parametrize("B,d,scores", D2_DIFFS_BAND_CASES)
def test_packed_word_equals_reference_on_ragged_lengths(B, d, scores):
    """Every band the register variants are built for, on lengths that
    differ by up to B and more; the last two cases are the ones the
    kernel hands to its general variant."""
    mm, go, ge = scores
    rows, lens = ragged_rows(100 + B, 40, 61 + B, B + 2)
    n = len(lens)
    tq = np.repeat(np.arange(n), n)
    td = np.tile(np.arange(n), n)
    want = d2_diffs_reference(
        _t(rows[tq]), _t(rows[td]), _t(lens[tq]), _t(lens[td]), B,
        rows.shape[1], mm, go, ge, d).numpy()
    assert (want >= 0).any() and (want < 0).any()
    stride = -(-rows.shape[1] // 16) * 16
    fits = packed_variant_fits(B, stride, mm, go, ge, d)
    assert fits == (B <= 20 and mm < 70000)
    if fits:
        got = d2_diffs_packed_emulation(
            rows[tq], rows[td], lens[tq], lens[td], B, mm, go, ge, d)
        np.testing.assert_array_equal(got, want)


def test_packed_word_equals_jax_scan():
    import jax.numpy as jnp

    from swarm_tpu.ops.d2_diffs_jax import d2_diffs_program

    B, d, (mm, go, ge) = 8, 2, (18, 24, 13)
    rows, lens = ragged_rows(7, 48, 64, 6)
    n = len(lens)
    tq = np.repeat(np.arange(n), n)
    td = np.tile(np.arange(n), n)
    Lmax = rows.shape[1]
    want = np.asarray(d2_diffs_program(
        jnp.asarray(rows[tq]), jnp.asarray(rows[td]), jnp.asarray(lens[tq]),
        jnp.asarray(lens[td]), B=B, Lmax=Lmax, mismatch=mm, go=go, ge=ge,
        d=d))
    got = d2_diffs_packed_emulation(
        rows[tq], rows[td], lens[tq], lens[td], B, mm, go, ge, d)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > n


@pytest.mark.parametrize("stride,scores,d,fits", [
    (160, (18, 24, 13), 2, True),
    (416, (18, 24, 13), 2, True),
    (16384, (18, 24, 13), 2, True),     # 16k nt rows still fit
    (32768, (18, 24, 13), 2, False),    # the cost field has no room
    (160, (4, 2, 1), 16, True),         # B = 67 is refused by B, not here
    (160, (70000, 3, 1), 2, False),     # cutoff beyond the count's 9 bits
    (160, (0, 2, 1), 2, False),         # a free mismatch counts unboundedly
])
def test_packed_variant_limits(stride, scores, d, fits):
    mm, go, ge = scores
    assert packed_variant_fits(8, stride, mm, go, ge, d) is fits
    assert packed_variant_fits(21, stride, mm, go, ge, d) is False


@pytest.mark.parametrize("seed,d,scores", [
    (1, 2, (4, 12, 4)), (4, 2, (2, 2, 2)), (5, 4, (1, 1, 1)),
    (2, 2, (4, 12, 4))])
def test_engine_with_16_byte_stride_equals_jax_engine(tmp_path, seed, d,
                                                      scores):
    """DeviceDiffEngine keeps its rows at a stride of a multiple of 16
    bytes; the plain version and the results do not notice."""
    from swarm_tpu.ops.d2_diffs_jax import DeviceDiffEngine as JaxEngine
    from test_d2_diffs_jax import _chain_corpus, _mkdb

    mm, go, ge = scores
    records = _chain_corpus(seed, 60, 50, d + 1)
    db = make_db(tmp_path, records)
    eng = DeviceDiffEngine(db, d, torch.device("cpu"))
    assert eng.rows.shape == (len(db), eng.Lmax)
    assert eng.rows.stride(0) % 16 == 0 and eng.rows.stride(1) == 1
    assert eng.Lmax % 16 != 0  # the corpus does exercise the padding
    jax_eng = JaxEngine(_mkdb(tmp_path, records), d)
    pa, pb = np.triu_indices(len(db), k=1)
    pa, pb = pa.astype(np.int64), pb.astype(np.int64)
    for no_break in (False, True):
        got = eng.diff_tasks(*(torch.from_numpy(x.astype(np.int32))
                               for x in (pa, pb)), mm, go, ge, no_break)
        want_ab, want_ba = (np.asarray(x) for x in
                            jax_eng.diffs_pairs(pa, pb, mm, go, ge, no_break))
        need_ab, need_ba = directions(db.abundances, pa, pb, no_break)
        assert (want_ab[~need_ab] < 0).all() and \
            (want_ba[~need_ba] < 0).all()
        want = (*task_layout(pa, pb, need_ab, need_ba),
                np.concatenate([want_ba[need_ba], want_ab[need_ab]]))
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), y)


def test_row_stride_16_keeps_shape_and_values():
    rows, lens = ragged_rows(3, 10, 37, 4)
    t = _t(rows)
    padded = row_stride_16(t)
    assert padded.shape == t.shape and torch.equal(padded, t)
    assert padded.stride(0) % 16 == 0 and padded.stride(0) >= t.shape[1]
    idx = torch.arange(len(lens))
    a = d2_diffs(t, _t(lens), idx, idx.flip(0), 4, 18, 24, 13, 2)
    b = d2_diffs(padded, _t(lens), idx, idx.flip(0), 4, 18, 24, 13, 2)
    assert torch.equal(a, b)


def test_full_strips_are_the_kernel_source_list():
    """FULL_STRIPS, from which the edge cases and the emulation take
    their strip widths, is the list the kernel source is built from."""
    import re
    from pathlib import Path

    import swarm_tpu_torch

    source = (Path(swarm_tpu_torch.__file__).parent / "csrc"
              / "nw_scores.cu").read_text()
    macro = re.search(r"#define NW_FULL_STRIPS\(X\)((?:.*\\\n)*.*)\n", source)
    strips = tuple(int(c) for c in re.findall(r"X\((\d+)\)", macro.group(1)))
    assert strips == FULL_STRIPS
    assert list(strips) == sorted(set(strips))
