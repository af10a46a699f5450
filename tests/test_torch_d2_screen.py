"""The d>=2 qgram screen and extraction of swarm_tpu_torch
(ops/d2_network.py: screen_words, extract_pairs and their plain
versions) against swarm_tpu's XLA programs qgram_screen_words and
extract_pairs, element for element and in order, and numpy emulations
of the two kernels' schedules (csrc/d2_screen.cu: the screen's items,
warpgroups, wgmma fragments and swizzled columns, epilogue and counts;
the extraction's groups of rows and stores) against the plain versions.
Small tiles (T = 32 to 512) so that several tiles, items, row tiles and
chunks run on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swarm_tpu.ops.d2_network import D2NetworkEngine as JaxNetworkEngine
from swarm_tpu.ops.d2_network import extract_pairs as jax_extract_pairs
from swarm_tpu.ops.d2_network import qgram_screen_words
from swarm_tpu_torch.corpora import SCREEN_CASES, screen_edge_rows
from swarm_tpu_torch.ops.d2_network import (
    D2NetworkEngine,
    extract_pairs,
    extract_pairs_reference,
    row_counts_reference,
    screen_words,
    screen_words_reference,
    tile_steps,
)

from test_d2_network import _db_from_seqs

CPU = torch.device("cpu")


def screen_db(seed, n, d):
    return _db_from_seqs(screen_edge_rows(seed, n, d))


def engine_state(db, d, T, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_D2_TILE", str(T))
    eng = D2NetworkEngine(db, d, CPU)
    tis, tjs = tile_steps(eng.n_pad // T)
    return eng, torch.from_numpy(tis), torch.from_numpy(tjs)


def jax_words(eng, tis, tjs, T):
    words = qgram_screen_words(
        jnp.asarray(eng.prof.numpy()), jnp.asarray(eng.lengths.numpy()),
        jnp.asarray(tis.numpy()), jnp.asarray(tjs.numpy()),
        jnp.ones(len(tis), dtype=bool), T=T, n=eng.n, d=eng.d)
    return np.asarray(words)


@pytest.mark.parametrize("n", [255, 256, 257])
@pytest.mark.parametrize("d", [2, 3, 5])
def test_screen_words_reference_equals_jax(monkeypatch, d, n):
    """The words element for element, n one below, at and one above a
    multiple of T = 128 (2 or 3 tiles: diagonal and off-diagonal steps,
    padding rows)."""
    T = 128
    eng, tis, tjs = engine_state(screen_db(90 + d, n, d), d, T, monkeypatch)
    got = screen_words_reference(eng.prof, eng.lengths, tis, tjs, T,
                                 eng.n, d)
    want = jax_words(eng, tis, tjs, T)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert want.any()


@pytest.mark.parametrize("d", [2, 5])
def test_extract_pairs_reference_equals_jax(monkeypatch, d):
    """JAX's extract_pairs, its caps large enough, gives the same pairs
    in the same order from the same words."""
    T = 128
    eng, tis, tjs = engine_state(screen_db(95 + d, 257, d), d, T,
                                 monkeypatch)
    words = jax_words(eng, tis, tjs, T)
    ga, gb, n_s, n_w, n_c = jax_extract_pairs(
        jnp.asarray(words), jnp.asarray(tis.numpy()),
        jnp.asarray(tjs.numpy()), T=T, caps=1 << 12, capw=1 << 14,
        capc=1 << 16)
    n_c = int(n_c)
    assert 0 < n_c < 1 << 16 and int(n_w) < 1 << 14 and int(n_s) < 1 << 12
    pa, pb = extract_pairs_reference(
        torch.from_numpy(words.view(np.int32).copy()), tis, tjs, T)
    assert pa.dtype == pb.dtype == torch.int32
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ga)[:n_c])
    np.testing.assert_array_equal(pb.numpy(), np.asarray(gb)[:n_c])


#: the screen kernel's item (columns), warpgroup rows, warpgroups a
#: block and k-steps (csrc/d2_screen.cu: kCols, kRows, kGroups, kSteps)
KCOLS, KROWS, KGROUPS, KSTEPS = 128, 64, 3, 32
#: pairs of a pass that the extraction's lanes store directly (kDirect)
#: and pairs a warp stages at a time above that (kStage)
KDIRECT, KSTAGE = 32, 1024
#: blocks of the screen resident at once on an H100 (one an SM)
SLOTS = 132
#: the cases of both schedules: SCREEN_CASES, T = 32 (a quarter of an
#: item, half a row tile), T = 160 (a ragged second item and third row
#: tile) and d = 20 (dense words)
SCHEDULE_CASES = SCREEN_CASES + [(32, 75, 2), (160, 330, 3), (128, 200, 20)]


def _popcount32(x):
    return np.unpackbits(np.ascontiguousarray(x, dtype=np.uint32)
                         .view(np.uint8)).reshape(*np.shape(x), 32).sum(
        -1, dtype=np.int64)


def pm1_bytes(w):
    """The kernel's expansion of uint32 words: bytes 0..3 = bits 0, 8,
    16, 24 as +1 (clear) or -1 (set), by (w & 0x01010101) * 0xFE +
    0x01010101 in 32-bit arithmetic; returns [..., 4] int8."""
    v = (w & np.uint32(0x01010101)) * np.uint32(0xFE) + np.uint32(0x01010101)
    return np.ascontiguousarray(v, dtype=np.uint32)[..., None].view(np.int8)


def expand_columns(prof32, cols_ok):
    """The item's +-1 columns as expand_columns leaves them in shared
    memory: chunk kc (k-steps 4kc..4kc+3) a [128, 128]-byte array, column
    c's 16-byte unit u at u ^ (c % 8); then read back as the wgmma
    descriptors of the 32 k-steps read them (start 32 * (s % 4) bytes
    into the chunk's rows, 16-byte units swizzled by row). prof32:
    [128, 32] uint32 words of the item's columns. Returns [128, 1024]
    int8 in the kernel's K order and checks that every unit is written
    once."""
    smem = np.zeros((8, KCOLS, 8, 16), dtype=np.int8)
    written = np.zeros((8, KCOLS, 8), dtype=np.int64)
    x = np.arange(KCOLS * 8)
    c, kc = (x // 64) * 8 + x % 8, (x % 64) // 8  # a thread's column, chunk
    v = np.where(cols_ok[c][:, None],
                 prof32[c].reshape(-1, 8, 4)[np.arange(len(x)), kc],
                 0).astype(np.uint32)  # [threads, 4]: a uint4 of 4 words
    for i in range(4):
        for half in range(2):
            unit = (2 * i + half) ^ (c & 7)
            shifts = np.arange(4 * half, 4 * half + 4, dtype=np.uint32)
            smem[kc, c, unit] = pm1_bytes(v[:, i, None] >> shifts).reshape(
                -1, 16)
            written[kc, c, unit] += 1
    assert (written == 1).all()
    out = np.empty((KCOLS, KSTEPS * 32), dtype=np.int8)
    cols = np.arange(KCOLS)
    for s in range(KSTEPS):
        for h in range(2):
            unit = (2 * (s % 4) + h) ^ (cols & 7)
            out[:, 32 * s + 16 * h:32 * s + 16 * h + 16] = \
                smem[s // 4, cols, unit]
    return out


def a_fragments(wa, wb):
    """A warpgroup's 64 x 1024 int8 A as its threads' registers hold it:
    warp w, lane (g, t), k-step s: a[0] = pm1_bytes(wa >> t) at row 16w
    + g, bytes 4t.. of the step; a[1] the same of wb at row + 8; a[2],
    a[3] of shift t + 4 at bytes 16 + 4t. wa, wb: [4 warps, 8 g, 32
    steps] uint32, the words of each thread's two rows."""
    A = np.zeros((KROWS, KSTEPS * 32), dtype=np.int8)
    for t in range(4):
        for reg, (words, h, q) in enumerate(
                ((wa, 0, t), (wb, 1, t), (wa, 0, t + 4), (wb, 1, t + 4))):
            bytes_ = pm1_bytes(words >> np.uint32(q))  # [4, 8, 32, 4]
            for w in range(4):
                rows = 16 * w + np.arange(8) + 8 * h
                for s in range(KSTEPS):
                    k0 = 32 * s + 4 * t + 16 * (reg >= 2)
                    A[rows, k0:k0 + 4] = bytes_[w, :, s]
    return A


def screen_parts(items, row_tiles, slots=SLOTS):
    """The launch's row parts an item (csrc/d2_screen.cu: screen_parts):
    of 1..4 (at most the row tiles), the fewest whose items fill the
    last wave of `slots` blocks best, by more than 2%."""
    parts, best = 1, 0.0
    for p in range(1, min(4, row_tiles) + 1):
        m = items * p
        fill = m / (-(-m // slots) * slots)
        if fill > best + 0.02:
            parts, best = p, fill
    return parts


def emulate_screen(prof, lengths, tis, tjs, T, n, d, parts=None):
    """d2_screen_kernel's schedule in numpy: items (step, row part, 128
    columns; `parts` as the launch picks them at SLOTS blocks unless
    given), the part's row tiles of 64 taken in turn by three warpgroups;
    the items the masks decide
    alone (no column below n, or a diagonal step's rows at or past every
    column) skip the product and store zero words; the others expand
    their columns (expand_columns), build the A fragments from the rows'
    packed words (a_fragments), take the dot in the kernel's K order and
    lay it out as the accumulator (thread (g, t) of warp w: d[4j + 2h +
    e] = row 16w + g + 8h, column 8j + 2t + e); a warp with no sum at the
    threshold stores zero words, the others build each thread's bits of
    the dot test in its rows' four words, OR them over the quad; thread
    t keeps word t of each row, clears its set bits that fail the length
    or triangle test, stores it, and the quad's popcounts of a row are
    added once. Every word is written once (checked)."""
    prof32 = prof.view(np.uint32).reshape(-1, 32)
    C = len(tis)
    wpr = T // 32
    col_blocks = -(-T // KCOLS)
    row_tiles = -(-T // KROWS)
    if parts is None:
        parts = screen_parts(C * col_blocks, row_tiles)
    per_part = -(-row_tiles // parts)
    words = np.full(C * T * wpr, 0xDEADBEEF, dtype=np.uint32)
    written = np.zeros(C * T * wpr, dtype=np.int64)
    counts = np.zeros(C * T, dtype=np.int32)
    thr = 1024 - 20 * d
    w_ = np.arange(4)[:, None, None]
    g_ = np.arange(8)[None, :, None]
    t_ = np.arange(4)[None, None, :]
    j_ = np.arange(16)
    for item in range(C * col_blocks * parts):
        kp, cb = divmod(item, col_blocks)
        k, part = divmod(kp, parts)
        c0 = cb * KCOLS
        c_end = min(c0 + KCOLS, T)
        ti, tj = int(tis[k]), int(tjs[k])
        diag = ti == tj
        none = ti > tj or tj * T + c0 >= n
        cols = c0 + np.arange(KCOLS)
        gj = tj * T + cols
        if not none:
            ok = cols < T
            B = expand_columns(prof32[np.minimum(gj, tj * T + T - 1)], ok)
            col_len = np.where(ok & (gj < n),
                               lengths[np.minimum(gj, len(lengths) - 1)],
                               1 << 30)
        for group in range(KGROUPS):
            for rt in range(part * per_part + group,
                            min((part + 1) * per_part, row_tiles), KGROUPS):
                ra = rt * KROWS + 16 * w_ + g_ + 0 * t_  # [4, 8, 4]
                skip = none or (diag and rt * KROWS >= c_end - 1)
                acc = np.zeros((4, 8, 4, 64), dtype=np.int64)
                hit = np.zeros(4, dtype=bool)
                if not skip:
                    rows = rt * KROWS + np.arange(KROWS)
                    rw = np.where((rows < T)[:, None],
                                  prof32[ti * T + np.minimum(rows, T - 1)], 0)
                    rw = rw.reshape(4, 2, 8, KSTEPS)  # warp, h, g, step
                    A = a_fragments(rw[:, 0], rw[:, 1])
                    dot = (A.astype(np.float32) @ B.astype(np.float32).T
                           ).astype(np.int64)  # exact: |sum| <= 1024
                    for e in range(2):
                        for h in range(2):
                            acc[..., 4 * j_ + 2 * h + e] = dot[
                                (ra + 8 * h)[..., None] - rt * KROWS,
                                8 * j_ + 2 * t_[..., None] + e]
                    hit = (acc >= thr).reshape(4, -1).any(1)  # a warp's vote
                full = np.zeros((4, 8, 2, 4), dtype=np.uint32)  # w, g, h, word
                for w in np.flatnonzero(hit):
                    partial = np.zeros((8, 4, 2, 4), dtype=np.uint32)  # g, t, h
                    for h in range(2):
                        for e in range(2):  # the dot's bits alone
                            ok = acc[w][:, :, 4 * j_ + 2 * h + e] >= thr
                            sh = (8 * (j_ % 4) + 2 * np.arange(4)[:, None]
                                  + e).astype(np.uint32)
                            bits = ok.astype(np.uint32) << sh[None]
                            for wd in range(4):
                                partial[:, :, h, wd] |= np.bitwise_or.reduce(
                                    bits[:, :, 4 * wd:4 * wd + 4], axis=2)
                    full[w] = np.bitwise_or.reduce(partial, axis=1)  # the quad
                    for h in range(2):  # thread t masks word t's set bits
                        r = rt * KROWS + 16 * w + np.arange(8) + 8 * h
                        lr = np.where(r < T, lengths[ti * T + np.minimum(
                            r, T - 1)], 0)
                        for t in range(4):
                            c = 32 * t + np.arange(32)  # the item's columns
                            keep = ((np.abs(lr[:, None] - col_len[c][None])
                                     <= d)
                                    & ((r[:, None] < c0 + c[None]) | (not diag)))
                            set_ = (full[w, :, h, t][:, None]
                                    >> np.arange(32, dtype=np.uint32)) & 1
                            full[w, :, h, t] = ((set_ * keep) << np.arange(
                                32, dtype=np.uint32)).sum(1).astype(np.uint32)
                for w in range(4):
                    for h in range(2):
                        r = rt * KROWS + 16 * w + np.arange(8) + 8 * h
                        for t in range(4):  # thread t stores word t
                            ok = (r < T) & (c0 + 32 * t < T)
                            at = (k * T + r[ok]) * wpr + c0 // 32 + t
                            words[at] = full[w, ok, h, t]
                            written[at] += 1
                        if hit[w]:  # the quad's popcounts summed, one add
                            cnt = _popcount32(full[w, :, h]).sum(-1)
                            add = (r < T) & (cnt > 0)
                            counts[k * T + r[add]] += cnt[add]
    assert (written == 1).all()
    return words.reshape(C, T * wpr).view(np.int32), counts


def emulate_extract(words, counts, tis, tjs, T, stage=KSTAGE,
                    direct=KDIRECT):
    """d2_extract_kernel's schedule: the exclusive scan, then groups of
    32 rows (one load of their counts, a ballot of the rows that hold
    survivors, only those walked, lowest first); a row's words 4 a lane,
    128 a pass, the lanes' popcounts scanned; a pass of at most `direct`
    pairs has each lane store its pairs at its slots, a larger one puts
    them in windows of `stage` slots, each window stored in order. Every
    pair is written once (checked)."""
    words = words.view(np.uint32).reshape(-1)
    incl = np.cumsum(counts, dtype=np.int64)
    offsets = incl - counts
    total = int(incl[-1]) if len(incl) else 0
    ga = np.full(total, -1, dtype=np.int64)
    gb = np.full(total, -1, dtype=np.int64)
    written = np.zeros(total, dtype=np.int64)
    wpr = T // 32
    n_rows = len(counts)
    for grp in range(-(-n_rows // 32)):
        q_lane = grp * 32 + np.arange(32)
        cnt = np.where(q_lane < n_rows, counts[np.minimum(q_lane, n_rows - 1)],
                       0)
        for src in np.flatnonzero(cnt != 0):  # the ballot, lowest first
            q = grp * 32 + src
            k = q // T
            a = int(tis[k]) * T + q % T
            b0 = int(tjs[k]) * T
            base = start = int(offsets[q])
            for w0 in range(0, wpr, 128):
                w = w0 + 4 * np.arange(32)[:, None] + np.arange(4)  # [32, 4]
                x = np.where(w < wpr, words[q * wpr + np.minimum(w, wpr - 1)],
                             0).astype(np.uint32)
                bits = _popcount32(x).sum(1)
                lane_incl = np.cumsum(bits)
                pass_ = int(lane_incl[-1])
                assert base + pass_ <= total  # else the kernel traps
                if pass_ <= direct:
                    for lane in range(32):
                        pos = base + int(lane_incl[lane] - bits[lane])
                        for i in range(4):
                            for bit in range(32):
                                if int(x[lane, i]) >> bit & 1:
                                    ga[pos] = a
                                    gb[pos] = b0 + int(w[lane, i]) * 32 + bit
                                    written[pos] += 1
                                    pos += 1
                for win in range(0, pass_ if pass_ > direct else 0, stage):
                    staged = np.full(stage, -1, dtype=np.int64)
                    for lane in range(32):
                        slot = int(lane_incl[lane] - bits[lane])
                        if not (slot < win + stage and lane_incl[lane] > win):
                            continue
                        for i in range(4):
                            for bit in range(32):
                                if int(x[lane, i]) >> bit & 1:
                                    if win <= slot < win + stage:
                                        staged[slot - win] = \
                                            b0 + int(w[lane, i]) * 32 + bit
                                    slot += 1
                    span = min(pass_ - win, stage)
                    assert (staged[:span] >= 0).all()
                    ga[base + win:base + win + span] = a
                    gb[base + win:base + win + span] = staged[:span]
                    written[base + win:base + win + span] += 1
                base += pass_
            assert base == start + counts[q]  # else the kernel traps
    assert (written == 1).all()
    return ga, gb


@pytest.mark.parametrize("T,n,d", SCHEDULE_CASES)
def test_kernel_schedule_emulation(monkeypatch, T, n, d):
    """The emulated kernels give the plain versions' words, each row's
    count and the pairs in order."""
    eng, tis, tjs = engine_state(screen_db(100 + T, n, d), d, T,
                                 monkeypatch)
    want = screen_words_reference(eng.prof, eng.lengths, tis, tjs, T,
                                  eng.n, d)
    words, counts = emulate_screen(eng.prof.numpy(), eng.lengths.numpy(),
                                   tis.numpy(), tjs.numpy(), T, eng.n, d)
    np.testing.assert_array_equal(words, want.numpy())
    np.testing.assert_array_equal(counts,
                                  row_counts_reference(want, T).numpy())
    ga, gb = emulate_extract(words, counts, tis.numpy(), tjs.numpy(), T)
    pa, pb = extract_pairs_reference(want, tis, tjs, T)
    assert len(ga) > 0
    np.testing.assert_array_equal(ga, pa.numpy())
    np.testing.assert_array_equal(gb, pb.numpy())


@pytest.mark.parametrize("T,n,d,parts", [(512, 700, 5, 1), (512, 700, 5, 3),
                                         (160, 330, 3, 2), (96, 200, 3, 4)])
def test_screen_row_parts_emulation(monkeypatch, T, n, d, parts):
    """Items cut into row parts (runs of row tiles, the last one short
    or empty) write every word once and give the plain version's words
    and counts."""
    eng, tis, tjs = engine_state(screen_db(100 + T, n, d), d, T,
                                 monkeypatch)
    want = screen_words_reference(eng.prof, eng.lengths, tis, tjs, T,
                                  eng.n, d)
    words, counts = emulate_screen(eng.prof.numpy(), eng.lengths.numpy(),
                                   tis.numpy(), tjs.numpy(), T, eng.n, d,
                                   parts=parts)
    np.testing.assert_array_equal(words, want.numpy())
    np.testing.assert_array_equal(counts,
                                  row_counts_reference(want, T).numpy())


def test_screen_parts_fill_the_last_wave():
    """At 132 blocks: d2_100k's 10,400 items (325 steps of 32) and the
    d1_1m chunk's 16,384 stay whole; d2_long's 480 (15 steps) take 3
    parts (1,440 items, 11 waves of 132 filled to 99%, against 91%)."""
    assert screen_parts(325 * 32, 64) == 1
    assert screen_parts(512 * 32, 64) == 1
    assert screen_parts(15 * 32, 64) == 3
    assert screen_parts(3, 1) == 1  # T = 32: one row tile


@pytest.mark.parametrize("T,n,d", [(128, 200, 20), (160, 330, 3)])
def test_extract_stage_windows_emulation(monkeypatch, T, n, d):
    """Passes of more than 2 pairs staged, 4 slots at a time: a pass of
    more pairs is stored in windows, each lane putting only its slots of
    the window; the same pairs in the same order."""
    eng, tis, tjs = engine_state(screen_db(100 + T, n, d), d, T,
                                 monkeypatch)
    want = screen_words_reference(eng.prof, eng.lengths, tis, tjs, T,
                                  eng.n, d)
    counts = row_counts_reference(want, T).numpy()
    assert counts.max() > 4
    ga, gb = emulate_extract(want.numpy(), counts, tis.numpy(), tjs.numpy(),
                             T, stage=4, direct=2)
    pa, pb = extract_pairs_reference(want, tis, tjs, T)
    np.testing.assert_array_equal(ga, pa.numpy())
    np.testing.assert_array_equal(gb, pb.numpy())


def test_expansion_is_one_permutation_of_both_sides():
    """pm1_bytes gives +-1 of the right bits, and the A fragments and the
    swizzled columns put bit q + 8i of word s at byte 32s + 4q + i of
    both sides: the kernel's dot equals the plain +-1 dot."""
    rng = np.random.default_rng(123)
    w = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(
        np.uint32)
    got = pm1_bytes(w)
    for i in range(4):
        np.testing.assert_array_equal(
            got[:, i], 1 - 2 * (w >> 8 * i & 1).astype(np.int64))
    rows = rng.integers(0, 1 << 32, size=(KROWS, KSTEPS),
                        dtype=np.uint64).astype(np.uint32)
    cols = rng.integers(0, 1 << 32, size=(KCOLS, KSTEPS),
                        dtype=np.uint64).astype(np.uint32)
    r4 = rows.reshape(4, 2, 8, KSTEPS)
    A = a_fragments(r4[:, 0], r4[:, 1])
    B = expand_columns(cols, np.ones(KCOLS, dtype=bool))

    def plain_pm1(src):  # bit b of the profile at position b
        bits = (src[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
        return 1 - 2 * bits.reshape(len(src), -1).astype(np.int64)

    # byte 32s + 4q + i of either side holds bit 32s + q + 8i
    order = (32 * np.arange(KSTEPS)[:, None, None]
             + np.arange(8)[None, :, None]
             + 8 * np.arange(4)[None, None, :]).reshape(-1)
    pa, pb = plain_pm1(rows), plain_pm1(cols)
    np.testing.assert_array_equal(A, pa[:, order])
    np.testing.assert_array_equal(B, pb[:, order])
    dot = A.astype(np.int64) @ B.astype(np.int64).T
    np.testing.assert_array_equal(dot, pa @ pb.T)


@pytest.mark.parametrize("n", [127, 128, 129, 383])
@pytest.mark.parametrize("d", [2, 3, 5])
def test_candidate_pairs_equal_jax_in_order(monkeypatch, d, n):
    """The engine's pairs equal JAX's, in order, over chunks of 2 steps
    (one chunk at 1 and 2 tiles, 3 chunks at 3 tiles)."""
    monkeypatch.setenv("SWARM_TPU_D2_CHUNK", "2")
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "128")
    db = screen_db(110 + d, n, d)
    pa, pb, tot = D2NetworkEngine(db, d, CPU).candidate_pairs()
    ja, jb, jtot = JaxNetworkEngine(db, d).candidate_pairs()
    assert tot == jtot == len(pa) > 0
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pb, jb)
    assert pa.dtype == pb.dtype == np.int64
    lens = db.lengths
    assert (np.abs(lens[pa] - lens[pb]) == d).any()  # lengths d apart


def test_wrappers_refuse_what_the_kernels_cannot_take(monkeypatch):
    eng, tis, tjs = engine_state(screen_db(120, 100, 2), 2, 128,
                                 monkeypatch)
    args = (eng.prof, eng.lengths, tis, tjs)
    with pytest.raises(ValueError, match="multiple of 32"):
        screen_words(*args, 48, eng.n, 2)
    with pytest.raises(ValueError, match="int32"):
        screen_words(eng.prof, eng.lengths, tis.long(), tjs, 128, eng.n, 2)
    with pytest.raises(ValueError, match="uint8"):
        screen_words(eng.prof[:, :64], eng.lengths, tis, tjs, 128, eng.n, 2)
    words, counts = screen_words(*args, 128, eng.n, 2)
    with pytest.raises(ValueError, match="agree"):
        extract_pairs(words, counts[:-1], tis, tjs, 128)
    with pytest.raises(ValueError, match="agree"):
        extract_pairs(words, counts, tis, tjs, 64)
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "100")
    with pytest.raises(ValueError, match="multiple of 32"):
        D2NetworkEngine(screen_db(121, 50, 2), 2, CPU)


def test_empty_chunk_gives_no_pairs(monkeypatch):
    """Profiles far apart: no survivor, zero counts, no pairs."""
    rng = np.random.default_rng(122)
    db = _db_from_seqs([rng.integers(0, 4, size=200).astype(np.uint8)
                        for _ in range(40)])
    eng, tis, tjs = engine_state(db, 2, 128, monkeypatch)
    words, counts = screen_words(eng.prof, eng.lengths, tis, tjs, 128,
                                 eng.n, 2)
    assert not words.any() and not counts.any()
    ga, gb = extract_pairs(words, counts, tis, tjs, 128)
    assert ga.numel() == gb.numel() == 0 and ga.dtype == torch.int32
    assert eng.candidate_pairs()[2] == 0


def test_tile_steps_are_jax_order():
    tis, tjs = tile_steps(4)
    want = [(i, j) for i in range(4) for j in range(i, 4)]
    assert list(zip(tis.tolist(), tjs.tolist())) == want
    assert tis.dtype == tjs.dtype == np.int32
