"""The d>=2 qgram screen and extraction of swarm_tpu_torch
(ops/d2_network.py: screen_words, extract_pairs and their plain
versions) against swarm_tpu's XLA programs qgram_screen_words and
extract_pairs, element for element and in order, and a numpy emulation
of the two kernels' schedule (csrc/d2_screen.cu) against the plain
versions. Small tiles (T = 96, 128, 512) so that several tiles, column
blocks and chunks run on the CPU."""

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


def _popcount64(x):
    return np.unpackbits(x.view(np.uint8), axis=-1).reshape(
        *x.shape, 64).sum(-1)


def emulate_screen(prof, lengths, tis, tjs, T, n, d):
    """d2_screen_kernel's schedule in numpy: blocks of 32 rows and 32 * W
    columns (W warps, the most of 8, 4, 2, 1 that divides T / 32), a
    lane's column against each row by 64-bit words, stopping once the
    count passes 10d, a warp's ballot as the row's word, lane 0's store
    and atomic add. Every word is written once (checked)."""
    prof64 = prof.view(np.uint64).reshape(-1, 16)
    warps = 8
    while (T // 32) % warps:
        warps //= 2
    threads = 32 * warps
    col_blocks = T // threads
    C = len(tis)
    wpr = T // 32
    words = np.full(C * T * wpr, 0xDEADBEEF, dtype=np.uint32)
    written = np.zeros(C * T * wpr, dtype=np.int64)
    counts = np.zeros(C * T, dtype=np.int32)
    lim = 10 * d
    for bx in range(C * col_blocks):
        k, cb = divmod(bx, col_blocks)
        ti, tj = int(tis[k]), int(tjs[k])
        c = cb * threads + np.arange(threads)
        gj = tj * T + c
        b = prof64[gj]
        for by in range(T // 32):
            r = by * 32 + np.arange(32)
            a = prof64[ti * T + r]
            partial = np.cumsum(_popcount64(a[:, None, :] ^ b[None, :, :]),
                                axis=-1)  # [32, threads, 16]
            stopped = (partial > lim).any(-1)  # the loop broke on a word
            cheap = ((gj < n)[None, :]
                     & ((ti != tj) | (r[:, None] < c[None, :]))
                     & (np.abs(lengths[ti * T + r][:, None]
                               - lengths[gj][None, :]) <= d))
            passed = cheap & ~stopped
            for w in range(warps):
                lanes = passed[:, w * 32:(w + 1) * 32].astype(np.uint64)
                ballot = (lanes << np.arange(32, dtype=np.uint64)).sum(1)
                at = (k * T + by * 32 + np.arange(32)) * wpr + \
                    (cb * threads + w * 32) // 32
                words[at] = ballot.astype(np.uint32)
                written[at] += 1
                counts[k * T + by * 32 + np.arange(32)] += \
                    lanes.sum(1).astype(np.int32)
    assert (written == 1).all()
    return words.reshape(C, T * wpr).view(np.int32), counts


def emulate_extract(words, counts, tis, tjs, T):
    """d2_extract_kernel's schedule: the exclusive scan, then a warp a
    row of a step that returns on a zero count, its words 32 at a time
    (a lane a word), their popcounts scanned across the lanes, each
    lane's bits written in order at its offset."""
    words = words.view(np.uint32).reshape(-1)
    incl = np.cumsum(counts, dtype=np.int64)
    offsets = incl - counts
    total = int(incl[-1]) if len(incl) else 0
    ga = np.full(total, -1, dtype=np.int64)
    gb = np.full(total, -1, dtype=np.int64)
    wpr = T // 32
    for q in np.flatnonzero(counts):
        k = q // T
        a = int(tis[k]) * T + q % T
        base = int(offsets[q])
        for w0 in range(0, wpr, 32):
            lane_words = np.zeros(32, dtype=np.uint32)
            got = words[q * wpr + w0:q * wpr + min(w0 + 32, wpr)]
            lane_words[:len(got)] = got
            bits = np.array([bin(int(x)).count("1") for x in lane_words])
            lane_incl = np.cumsum(bits)
            for lane in range(32):
                pos = base + lane_incl[lane] - bits[lane]
                assert pos + bits[lane] <= total  # else the kernel traps
                for bit in range(32):
                    if int(lane_words[lane]) >> bit & 1:
                        ga[pos] = a
                        gb[pos] = int(tjs[k]) * T + (w0 + lane) * 32 + bit
                        pos += 1
            base += int(lane_incl[-1])
        assert base == offsets[q] + counts[q]  # else the kernel traps
    assert (ga >= 0).all() and (gb >= 0).all()
    return ga, gb


@pytest.mark.parametrize("T,n,d", SCREEN_CASES)
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
