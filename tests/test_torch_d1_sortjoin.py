"""swarm_tpu_torch's d=1 sort-join (ops/neighbors_sortjoin.py) against
swarm_tpu's, on the CPU, exactly (integers throughout):

- keygen: the port's deletion_keys_poly against swarm_tpu's, both
  halves and the valid slots, and the compacted keys of the wrappers on
  the ragged rows of the code arena;
- verify: verify_dist1_packed against swarm_tpu's _verify_dist1_packed,
  the numpy oracle verify_dist1 and the port's native verify_dist1_pairs,
  and the wrapper on ragged rows;
- partition and join: the candidates against a brute-force set of
  equal-key pairs (the kernels' emulations and swarm_tpu's join_pairs:
  tests/test_torch_d1_partition.py);
- the engine: SortJoinNeighborEngine(db, "cpu").build_network against
  swarm_tpu's engine and against the port's native d1_network;
- the dispatch of NeighborIndex between the native builder and the
  engine.

The CUDA kernels (csrc/d1_join.cu) cannot run here, so numpy
emulations of their arithmetic (the count pass's trips of four chunks
with its ballots and OR-reductions that pack the words, the keygen's
warp schedule with its lane powers, shuffle scans and ballots, the
verify's single pass with its funnel shift and
its look-ahead bound to the row's own words) are held against the plain
versions on the same cases; tests/test_torch_cuda.py holds the kernels
themselves against the plain versions on the card. The ragged rows of
mixed lengths, and the engine against swarm_tpu's width-bucketed
engine: tests/test_torch_d1_ragged.py.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from swarm_tpu.ops import neighbors_sortjoin as jax_sj
from swarm_tpu_torch import _native, metrics
from swarm_tpu_torch.corpora import (
    d1_edge_rows,
    insertion_run,
    make_db,
    rows_records,
)
from swarm_tpu_torch.ops import neighbors_sortjoin as sj
from swarm_tpu_torch.ops.neighbors import NeighborIndex, pad_codes
from test_jax_neighbors import _random_db

M32 = 0xFFFFFFFF


def _long_run_rows():
    """The corpus of tests/test_jax_neighbors.py's long-run test: a row
    of 40 codes and 30 distinct single insertions of it."""
    rng = np.random.Generator(np.random.PCG64(77))
    base = rng.integers(0, 4, size=40).astype(np.uint8)
    seqs, seen = [base], {base.tobytes()}
    while len(seqs) < 31:
        v = np.insert(base, int(rng.integers(0, 41)), int(rng.integers(0, 4)))
        if v.tobytes() not in seen:
            seen.add(v.tobytes())
            seqs.append(v)
    return seqs


def _rows_db(rows, seed=3):
    """A Db of distinct code rows with seeded abundances, built directly
    as tests/test_jax_neighbors.py builds its own."""
    from swarm_tpu.db import Db

    n = len(rows)
    db = Db()
    db.headers = [f"r{i}_1".encode() for i in range(n)]
    db.codes = np.concatenate(rows).astype(np.uint8)
    db.lengths = np.array([len(r) for r in rows], dtype=np.int64)
    db.offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(db.lengths[:-1], out=db.offsets[1:])
    db.abundances = np.random.default_rng(seed).integers(
        1, 50, size=n).astype(np.int64)
    db.longest = int(db.lengths.max())
    db.nucleotides = int(db.lengths.sum())
    return db


@functools.lru_cache(maxsize=None)
def _case_db(case):
    if case.startswith("seed"):
        return _random_db(n=300, min_len=1, max_len=90, seed=int(case[4:]))
    return _rows_db({"edge_rows": d1_edge_rows,
                     "insertion_run": insertion_run,
                     "long_run": _long_run_rows}[case]())


@functools.lru_cache(maxsize=None)
def _jax_keys(case):
    """swarm_tpu's deletion_keys_poly of a case: (h0, h1, valid)."""
    padded, lengths = _padded(_case_db(case))
    (h0, h1), valid = jax.jit(jax_sj.deletion_keys_poly)(
        jnp.asarray(padded), jnp.asarray(lengths))
    return np.asarray(h0), np.asarray(h1), np.asarray(valid)


DB_CASES = ["seed0", "seed1", "seed2", "seed3", "edge_rows",
            "insertion_run", "long_run"]


def _padded(db):
    width = -(-max(int(db.longest), 1) // 64) * 64
    padded = pad_codes(db.codes, db.offsets, db.lengths, width)
    return padded, db.lengths.astype(np.int32)


def _arena(db):
    """(codes, offsets, lengths, row_word, n_words) as the engine makes
    them, on the CPU."""
    return sj.SortJoinNeighborEngine(db, "cpu").arena()


# ---- numpy emulations of the kernels' arithmetic ------------------------

def _fmask(k):
    return M32 if k >= 16 else 0 if k <= 0 else (1 << (2 * k)) - 1


def _nonzero_fields(x):
    return (x | (x >> 1)) & 0x55555555


def _lane_power(r, lane):
    """(r^lane, r^32) as lane_power computes them: five squarings."""
    p = 1
    for b in range(5):
        if (lane >> b) & 1:
            p = p * r & M32
        r = r * r & M32
    return p, r


def emulate_count_pack(codes, offsets, lengths, row_word, n_words):
    """(counts, words) as d1_count_pack_kernel computes them: one warp a
    row, trips of four chunks of 32 positions with the trip's codes read
    first (4 past the row), run starts by a ballot against the lane
    before (lane 0: the last code of the chunk before), a chunk's two
    words by OR-reductions over each half warp, held by lanes 2k and
    2k + 1 and stored by lanes 0..7 at the trip's end."""
    lanes = np.arange(32)
    words = np.zeros(n_words, dtype=np.int64)
    counts = []
    for row, L in enumerate(int(x) for x in lengths):
        start, span = int(row_word[row]), int(sj.row_sizes(L)) * 16
        arena = np.zeros(span + 128, dtype=np.int64)  # the row, then room
        arena[:L] = codes[int(offsets[row]):int(offsets[row]) + L]
        count, before_chunk = int(L > 0), 4
        for base in range(0, span, 128):
            code = [np.where(base + 32 * k + lanes < L,
                             arena[base + 32 * k + lanes] & 3, 4)
                    for k in range(4)]
            trip = np.zeros(32, dtype=np.int64)
            for k in range(4):
                if base + 32 * k >= span:
                    break
                c = code[k]
                before = np.concatenate([[before_chunk], c[:31]])
                count += int(((c < 4) & (c != before)).sum())
                before_chunk = int(c[31])
                bits = np.where(c < 4, c << (2 * (lanes & 15)), 0)
                trip[2 * k] = np.bitwise_or.reduce(np.where(lanes < 16, bits, 0))
                trip[2 * k + 1] = np.bitwise_or.reduce(
                    np.where(lanes < 16, 0, bits))
            for lane in range(8):
                if 16 * (base // 16 + lane) < span:
                    words[start + base // 16 + lane] = trip[lane]
        counts.append(count)
    return np.array(counts), words


def emulate_keygen(words, row_word, lengths):
    """(counts, keys, owners) as d1_keygen_kernel computes them: one warp
    a row, reading its words from row_word[row], lane l on position
    base + l of each chunk of 32, with its power r^l and the chunk's
    r^base; the row's sums by a warp reduction, the prefix by a warp scan
    plus the chunks before, run starts against the lane before (lane 0:
    the last code of the chunk before), keys placed by a ballot; all mod
    2^32."""
    counts, keys, owners = [], [], []
    lanes = range(32)
    powers = [[_lane_power(r, lane) for lane in lanes] for r in sj._POLY_R]
    r32 = [pw[0][1] for pw in powers]
    for row, L in enumerate(int(x) for x in lengths):
        start = int(row_word[row])
        row_words = [int(w) & M32
                     for w in words[start:start + int(sj.row_sizes(L))]]

        def code(p):
            return (row_words[p >> 4] >> (2 * (p & 15))) & 3 if p < L else 4

        tot = [0, 0]
        c = [[pw[lane][0] for lane in lanes] for pw in powers]
        for base in range(0, L, 32):
            for h in (0, 1):
                terms = [((code(base + lane) + 1) * c[h][lane] & M32)
                         if base + lane < L else 0 for lane in lanes]
                tot[h] = (tot[h] + sum(terms)) & M32
                c[h] = [x * r32[h] & M32 for x in c[h]]
        row_keys = [tuple(tot)] if L > 0 else []
        before_chunk, pre = 4, [0, 0]
        c = [[pw[lane][0] for lane in lanes] for pw in powers]
        for base in range(0, L, 32):
            codes = [code(base + lane) for lane in lanes]
            before = [before_chunk] + codes[:31]
            halves = []
            for h in (0, 1):
                terms = [((codes[lane] + 1) * c[h][lane] & M32)
                         if codes[lane] < 4 else 0 for lane in lanes]
                inc, acc = [], 0
                for t in terms:
                    acc = (acc + t) & M32
                    inc.append(acc)
                q = [(pre[h] + inc[lane] - terms[lane]) & M32 for lane in lanes]
                halves.append([
                    (q[lane] + sj._POLY_RINV[h] * ((tot[h] - q[lane]
                                                    - terms[lane]) & M32))
                    & M32 for lane in lanes])
                pre[h] = (pre[h] + inc[31]) & M32
                c[h] = [x * r32[h] & M32 for x in c[h]]
            row_keys += [(halves[0][lane], halves[1][lane]) for lane in lanes
                         if codes[lane] < 4 and codes[lane] != before[lane]]
            before_chunk = codes[31]
        counts.append(len(row_keys))
        keys += [np.array(h0 << 32 | h1, dtype=np.uint64).view(np.int64)
                 for h0, h1 in row_keys]
        owners += [row] * len(row_keys)
    return (np.array(counts), np.array(keys, dtype=np.int64),
            np.array(owners))


def emulate_verify(words, row_word, lengths, a, b):
    """The flags of d1_verify_kernel: each row read from its own start,
    the single pass with f (first unshifted difference) and g (last
    shifted difference), the shift's look-ahead word zero past the
    longer row's own words."""
    out = []
    for ia, ib in zip(a, b):
        la, lb = int(lengths[ia]), int(lengths[ib])
        xa, xb = ([int(w) & M32 for w in words[int(row_word[i]):int(
            row_word[i]) + int(sj.row_sizes(int(lengths[i])))]]
                  for i in (ia, ib))
        if la == lb:
            mis = sum(bin(_nonzero_fields(p ^ q)).count("1")
                      for p, q in zip(xa, xb))
            out.append(mis == 1)
            continue
        if abs(la - lb) != 1:
            out.append(False)
            continue
        x, y = (xa, xb) if la > lb else (xb, xa)
        ly = min(la, lb)
        f, g = ly, -1
        for w in range(-(-ly // 64) * 4):
            base = w * 16
            below = _fmask(ly - base)
            md = _nonzero_fields(x[w] ^ y[w]) & below
            if md and f == ly:
                f = base + ((md & -md).bit_length() - 1) // 2
            nxt = x[w + 1] if w + 1 < len(x) else 0
            xs = ((x[w] >> 2) | (nxt << 30)) & M32
            ms = _nonzero_fields(xs ^ y[w]) & below
            if ms:
                g = base + (ms.bit_length() - 1) // 2
        out.append(g < f)
    return np.array(out, dtype=bool)


# ---- keygen ---------------------------------------------------------------

@pytest.mark.parametrize("case", DB_CASES)
def test_deletion_keys_poly_equals_jax(case):
    db = _case_db(case)
    padded, lengths = _padded(db)
    j0, j1, jvalid = _jax_keys(case)
    (h0, h1), valid = sj.deletion_keys_poly(
        torch.from_numpy(padded), torch.from_numpy(lengths))
    np.testing.assert_array_equal(h0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(h1.numpy(), np.asarray(j1).astype(np.int64))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert int(valid.sum()) > len(db)


@pytest.mark.parametrize("case", DB_CASES)
def test_keygen_wrappers_and_kernel_emulation(case):
    """deletion_keys on the ragged rows of the arena == swarm_tpu's halves
    compacted in row and slot order == the emulated kernels, counts and
    packed words included."""
    db = _case_db(case)
    padded, lengths = _padded(db)
    j0, j1, jvalid = _jax_keys(case)
    want = (np.asarray(j0).astype(np.uint64) << np.uint64(32)
            | np.asarray(j1).astype(np.uint64)).view(np.int64)[jvalid]
    want_owners = np.nonzero(jvalid)[0]

    codes, offsets, lens, row_word, n_words = _arena(db)
    counts, words = sj.keygen_count(codes, offsets, lens, row_word, n_words)
    keys, owners, words2 = sj.deletion_keys(codes, offsets, lens, row_word,
                                            n_words)
    assert torch.equal(words, words2)
    np.testing.assert_array_equal(keys.numpy(), want)
    np.testing.assert_array_equal(owners.numpy(), want_owners)
    np.testing.assert_array_equal(counts.numpy(), jvalid.sum(axis=1))
    np.testing.assert_array_equal(
        torch.stack(sj.split_keys(keys)).numpy(),
        np.stack([np.asarray(j0)[jvalid], np.asarray(j1)[jvalid]]))
    for i in range(len(db)):  # each row's words are its padded row's
        start, size = int(row_word[i]), int(sj.row_sizes(int(lens[i])))
        np.testing.assert_array_equal(
            sj.unpack2bit(words[None, start:start + size]).numpy()[0],
            padded[i, :16 * size])

    e_counts, e_words = emulate_count_pack(db.codes, db.offsets, lengths,
                                           row_word.numpy(), n_words)
    np.testing.assert_array_equal(e_counts, counts.numpy())
    np.testing.assert_array_equal(e_words.astype(np.uint32).view(np.int32),
                                  words.numpy())
    e_counts, e_keys, e_owners = emulate_keygen(words.numpy(),
                                                row_word.numpy(), lengths)
    np.testing.assert_array_equal(e_counts, counts.numpy())
    np.testing.assert_array_equal(e_keys, want)
    np.testing.assert_array_equal(e_owners, want_owners)


def test_keygen_of_no_rows_and_one_row(tmp_path):
    # [2, 2, 1]: the row's own key and deletions at run starts 0 and 2
    empty = _random_db(n=0, min_len=5, max_len=9, seed=1)
    one = make_db(tmp_path, rows_records([np.array([2, 2, 1], np.uint8)]))
    for db, n_keys in ((empty, 0), (one, 3)):
        keys, owners, words = sj.deletion_keys(*_arena(db))
        assert keys.numel() == n_keys
        assert owners.tolist() == [0] * n_keys
        assert words.numel() == 4 * len(db)


# ---- verify ---------------------------------------------------------------

def _verify_case(name):
    """(padded, lengths, a, b) of one verify case."""
    rng = np.random.default_rng(11)
    if name == "verify_dist1_cases":  # tests/test_jax_neighbors.py's
        seqs = [[0, 1, 2, 3, 0, 1], [0, 1, 3, 3, 0, 1], [0, 2, 3, 0, 1],
                [0, 1, 2, 2, 3, 0, 1], [0, 1, 2, 3, 0, 1], [3, 2, 1, 0, 3, 2],
                [0, 1, 2, 3], [0, 1, 2, 3, 0]]
        a = np.array([0, 0, 0, 0, 0, 0, 0])
        b = np.array([1, 2, 3, 4, 5, 6, 7])
    elif name == "edge_rows":  # every pair of the edge rows
        seqs = [list(r) for r in d1_edge_rows()]
        a, b = np.triu_indices(len(seqs), k=1)
    else:  # random pairs across word edges, every relation
        seqs, pairs = [], []
        for L in [1, 2, 5, 15, 16, 17, 31, 32, 33, 47, 48, 63, 64, 65, 90]:
            base = rng.integers(0, 4, size=L).tolist()
            i0 = len(seqs)
            seqs.append(base)
            variants = []
            for p in {0, L - 1, int(rng.integers(0, L))}:
                s = list(base)
                s[p] = (s[p] + 1 + int(rng.integers(0, 3))) % 4
                variants += [s, base[:p] + base[p + 1:]]
            for p in {0, L, L // 2}:
                variants.append(base[:p] + [int(rng.integers(0, 4))] + base[p:])
            variants += [list(base), base[:max(L - 2, 0)], base[1:] + [0]]
            if L >= 2:
                s = list(base)
                s[0], s[L - 1] = (s[0] + 1) % 4, (s[L - 1] + 1) % 4
                variants.append(s)
            for v in variants:
                pairs.append((i0, len(seqs)))
                seqs.append(v)
        for _ in range(300):  # unrelated rows of near lengths
            i, j = rng.integers(0, len(seqs), size=2)
            pairs.append((int(i), int(j)))
        a, b = (np.array(x) for x in zip(*pairs))
    width = -(-(max(len(s) for s in seqs) + 1) // 64) * 64
    padded = np.zeros((len(seqs), width), dtype=np.uint8)
    for i, s in enumerate(seqs):
        padded[i, :len(s)] = s
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    return padded, lengths, a.astype(np.int64), b.astype(np.int64)


@pytest.mark.parametrize("case", ["verify_dist1_cases", "word_edges",
                                  "edge_rows"])
def test_verify_dist1_packed_equals_jax_and_oracles(case):
    padded, lengths, a, b = _verify_case(case)
    packed_np = jax_sj.pack2bit(padded)
    want = jax_sj.verify_dist1(padded, lengths, a, b)
    jp = jnp.asarray(packed_np)
    got_jax = np.asarray(jax.jit(jax_sj._verify_dist1_packed)(
        jp[a], jp[b], jnp.asarray(lengths[a], jnp.int32),
        jnp.asarray(lengths[b], jnp.int32)))
    packed = torch.from_numpy(packed_np.view(np.int32))
    lens = torch.from_numpy(lengths.astype(np.int32))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = sj.verify_dist1_packed(packed[ta], packed[tb], lens[ta], lens[tb])
    np.testing.assert_array_equal(got.numpy(), got_jax)
    np.testing.assert_array_equal(got.numpy(), want)
    codes = padded.reshape(-1)
    offsets = np.arange(len(padded), dtype=np.int64) * padded.shape[1]
    np.testing.assert_array_equal(
        got.numpy(), _native.verify_dist1_pairs(codes, offsets, lengths, a, b))
    # the wrapper on the ragged rows, and the kernel's single pass
    words, row_word = sj.pack_ragged(torch.from_numpy(codes),
                                     torch.from_numpy(offsets), lens)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    keep = lo != hi
    pairs = torch.from_numpy(lo[keep] << 32 | hi[keep])
    np.testing.assert_array_equal(
        sj.verify_pairs(words, row_word, lens, pairs).numpy(), want[keep])
    np.testing.assert_array_equal(
        emulate_verify(words.numpy(), row_word.numpy(), lengths, a, b), want)
    assert want.any() and not want.all()
    if case == "verify_dist1_cases":
        assert want.tolist() == [True, True, True, False, False, False, True]


# ---- join -----------------------------------------------------------------

def _join_input(case):
    """(keys, owners) in keygen order: random keys from a small set of
    values (negative ones too), runs with repeated owners, or one long
    run."""
    rng = np.random.default_rng(int(case[-1]) if case[-1].isdigit() else 9)
    if case == "long_run":
        keys = np.concatenate([np.full(125, -5), rng.integers(0, 9, 40)])
        owners = np.concatenate([np.arange(125), rng.integers(0, 160, 40)])
        order = rng.permutation(len(keys))
        keys, owners = keys[order], owners[order]
    else:
        m = 400
        keys = rng.integers(-30, 30, size=m) * (1 << 40) + rng.integers(
            0, 3, size=m)
        owners = rng.integers(0, 150, size=m)
    return keys.astype(np.int64), owners.astype(np.int32)


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "long_run"])
def test_join_pairs_equal_brute_force(case):
    """partition, then join_pairs: the candidates are the equal-key pairs
    of brute force, in the kernel's order (test_torch_d1_partition.py
    emulates the kernels), with every bucket count."""
    keys, owners = _join_input(case)
    want = sorted(
        min(int(owners[i]), int(owners[j])) << 32
        | max(int(owners[i]), int(owners[j]))
        for i in range(len(keys)) for j in range(i)
        if keys[i] == keys[j] and owners[i] != owners[j])
    tk, to = torch.from_numpy(keys), torch.from_numpy(owners)
    for bits in (0, 2, 6):
        pk, po, ends = sj.partition(tk.clone(), to.clone(), bits)
        got = sj.join_pairs(pk, po, ends)
        assert sorted(got.tolist()) == want
        assert torch.equal(got, sj.join_buckets_reference(pk, po, ends))
        assert int(sj.join_count(pk, po, ends)[0].sum()) == len(want)
    assert sorted(sj.join_pairs_reference(tk, to).tolist()) == want
    if case == "long_run":
        assert len(want) >= 125 * 124 // 2


# ---- the engine -----------------------------------------------------------

def _jax_engine_edges(db, no_break):
    return jax_sj.SortJoinNeighborEngine(db).build_network(
        no_break, db.abundances.astype(np.uint64))


@pytest.mark.parametrize("no_break", [False, True])
@pytest.mark.parametrize("case", DB_CASES)
def test_engine_equals_jax_engine_and_native(case, no_break):
    db = _case_db(case)
    ab = db.abundances.astype(np.uint64)
    metrics.reset()
    ef, et = sj.SortJoinNeighborEngine(db, "cpu").build_network(no_break, ab)
    assert metrics.last_run["d1_join_comparisons"] >= len(ef) // 2
    jf, jt = _jax_engine_edges(db, no_break)
    np.testing.assert_array_equal(ef, jf)
    np.testing.assert_array_equal(et, jt)
    nf, nt = _native.d1_network(db.codes, db.offsets, db.lengths,
                                ab.astype(np.int64), no_break)
    np.testing.assert_array_equal(ef, nf)
    np.testing.assert_array_equal(et, nt)
    assert len(ef) > 0
    if case == "insertion_run":  # the base is 1 from each of 124 rows
        assert len(set(ef.tolist()) | set(et.tolist())) == 125


def test_engine_on_no_rows_one_row_and_duplicates(tmp_path):
    empty = _random_db(n=0, min_len=5, max_len=9, seed=1)
    eng = sj.SortJoinNeighborEngine(empty, "cpu")
    eng.start()
    assert [len(x) for x in eng.build_network(False, np.zeros(0))] == [0, 0]
    one = make_db(tmp_path, rows_records([np.array([1, 2, 3], np.uint8)]))
    ef, et = sj.SortJoinNeighborEngine(one, "cpu").build_network(
        False, one.abundances)
    assert len(ef) == len(et) == 0
    # equal rows: the speculative start() takes them (the duplicate fatal
    # comes from the host's check); their keys all meet, verify drops them
    rows = [np.array([0, 1, 2, 3], np.uint8)] * 2 + [
        np.array([0, 1, 2], np.uint8)]
    (tmp_path / "dup").mkdir()
    dup = make_db(tmp_path / "dup", rows_records(rows))
    eng = sj.SortJoinNeighborEngine(dup, "cpu")
    eng.start()
    ef, et = eng.build_network(True, dup.abundances)
    edges = set(zip(ef.tolist(), et.tolist()))
    assert len(edges) == 4
    assert all(dup.lengths[a] != dup.lengths[b] for a, b in edges)


# ---- dispatch -------------------------------------------------------------

def test_native_below_native_max_engine_above(monkeypatch):
    db = _random_db(n=300, min_len=20, max_len=90, seed=5)
    ab = db.abundances.astype(np.uint64)
    want = _native.d1_network(db.codes, db.offsets, db.lengths,
                              ab.astype(np.int64), False)
    monkeypatch.delenv("SWARM_TPU_D1_NATIVE_MAX", raising=False)
    index = NeighborIndex(db, device="cpu")
    assert index.uses_native()
    index.start_network()
    assert index._engine is None
    got = index.build_network(False, ab)
    np.testing.assert_array_equal(got[0], want[0])

    monkeypatch.setenv("SWARM_TPU_D1_NATIVE_MAX", str(len(db)))
    index = NeighborIndex(db, device="cpu")
    assert not index.uses_native()
    index.start_network()
    assert isinstance(index._engine, sj.SortJoinNeighborEngine)
    got = index.build_network(False, ab)
    assert index._engine is None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    monkeypatch.setenv("SWARM_TPU_D1_NATIVE_MAX", str(len(db) + 1))
    assert NeighborIndex(db, device="cpu").uses_native()

    # the rule at its thresholds, measured on the card
    # (scripts/dispatch_sweep.py, PERF.md §5): in a fresh process, and in
    # one that holds the card already
    from swarm_tpu_torch import device

    monkeypatch.delenv("SWARM_TPU_D1_NATIVE_MAX")
    for ready, at in ((False, 262_144), (True, 4_096)):
        monkeypatch.setattr(device, "card_ready", lambda: ready)
        for n, native in ((at - 1, True), (at, False)):
            rows = types.SimpleNamespace(longest=150,
                                         lengths=np.full(n, 150))
            assert NeighborIndex(rows, device="cpu").uses_native() == native


def test_mixed_lengths_take_the_engine(monkeypatch, tmp_path):
    """A mixed-length corpus (one that swarm_tpu would give its
    width-bucketed engine) takes the torch engine once n reaches
    SWARM_TPU_D1_NATIVE_MAX, and its edges are the native builder's."""
    rng = np.random.default_rng(71)
    short = rng.integers(0, 4, size=50).astype(np.uint8)
    rows = [short, np.insert(short, 7, 1), rng.integers(0, 4, 900)]
    rows.append(np.delete(rows[-1], 450))
    db = make_db(tmp_path, rows_records([r.astype(np.uint8) for r in rows]))
    assert jax_sj.BucketedSortJoinEngine.worthwhile(db.lengths)
    monkeypatch.setenv("SWARM_TPU_D1_NATIVE_MAX", "0")
    index = NeighborIndex(db, device="cpu")
    assert not index.uses_native()
    index.start_network()
    assert isinstance(index._engine, sj.SortJoinNeighborEngine)
    ef, et = index.build_network(True, db.abundances)
    assert len(ef) == 4
    nf, nt = _native.d1_network(db.codes, db.offsets, db.lengths,
                                db.abundances.astype(np.int64), True)
    np.testing.assert_array_equal(ef, nf)
    np.testing.assert_array_equal(et, nt)


def test_engine_without_a_device_request_needs_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the engine takes the card here")
    db = _random_db(n=50, min_len=20, max_len=40, seed=2)
    monkeypatch.setenv("SWARM_TPU_D1_NATIVE_MAX", "0")
    index = NeighborIndex(db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index.start_network()
