"""swarm_tpu_torch's d=1 sort-join on ragged rows of mixed lengths
against swarm_tpu, on the CPU, exactly:

- pack: pack_ragged (the code arena 2-bit packed at each row's own
  word offset) against swarm_tpu's pack2bit of the padded table, row
  by row, and the emulated count and pack kernel;
- keygen: the compacted keys of the ragged rows (grouped by width)
  against swarm_tpu's deletion_keys_poly on the padded table, element
  for element;
- verify: verify_pairs on pairs across widths against swarm_tpu's
  _verify_dist1_packed, the numpy oracle verify_dist1 and the port's
  native verify_dist1_pairs, and the emulated kernel;
- the engine: SortJoinNeighborEngine(db, "cpu").build_network against
  swarm_tpu's BucketedSortJoinEngine (the width buckets that the ragged
  rows replace), its single-table SortJoinNeighborEngine and the native
  d1_network; on longer rows against the native builder only;
- corpora.mixed_length_corpus: a corpus swarm_tpu would bucket.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from swarm_tpu.ops import neighbors_sortjoin as jax_sj
from swarm_tpu_torch import _native
from swarm_tpu_torch.corpora import (
    RAGGED_EDGE_LENGTHS,
    mixed_length_corpus,
    ragged_edge_rows,
    read_db,
)
from swarm_tpu_torch.ops import neighbors_sortjoin as sj
from swarm_tpu_torch.ops.neighbors import pad_codes
from test_torch_d1_sortjoin import (
    _rows_db,
    emulate_count_pack,
    emulate_keygen,
    emulate_verify,
)


def _jax_bucketed_rows():
    """The corpus of tests/test_jax_neighbors.py's bucketed-join test
    (seed 71): a cloud of 50 nt, a 64-nt row and its 65-nt insertion
    (across the 64-wide bucket's edge), a 900-nt row and a substitution
    of it."""
    rng = np.random.default_rng(71)
    seqs = []
    base = rng.integers(0, 4, size=50).astype(np.uint8)
    for _ in range(40):
        v = base.copy()
        for _ in range(int(rng.integers(0, 2))):
            v[rng.integers(0, len(v))] = rng.integers(0, 4)
        seqs.append(v)
    b = rng.integers(0, 4, size=64).astype(np.uint8)
    seqs += [b, np.insert(b, 30, 2).astype(np.uint8)]
    long = rng.integers(0, 4, size=900).astype(np.uint8)
    long2 = long.copy()
    long2[500] = (long2[500] + 1) % 4
    seqs += [long, long2]
    uniq, seen = [], set()
    for s in seqs:
        if s.tobytes() not in seen:
            seen.add(s.tobytes())
            uniq.append(s)
    return uniq, rng.integers(1, 9, size=len(uniq)).astype(np.int64)


def _clouds_and_long_reads(seed=72):
    """Clouds of 55-70 nt, and reads of 900-1,000 nt (swarm_tpu's
    1024-wide bucket) each with a few single edits."""
    rng = np.random.default_rng(seed)
    rows = []
    for L in (55, 58, 60, 64, 66, 70):
        centre = rng.integers(0, 4, size=L).astype(np.uint8)
        rows.append(centre)
        for _ in range(12):
            v, p = centre.copy(), int(rng.integers(0, L))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                v[p] = (v[p] + 1) % 4
            elif kind == 1:
                v = np.delete(v, p)
            else:
                v = np.insert(v, p, rng.integers(0, 4))
            rows.append(v)
    for L in (900, 960, 1000):  # 960 + 1 crosses a uint4
        read = rng.integers(0, 4, size=L).astype(np.uint8)
        rows += [read, np.insert(read, L // 2, 1), np.delete(read, L - 1),
                 np.append(read, 3)]
    return rows


def _bucket_edge_rows(seed=73):
    """Rows of 63-65 and 255-257 nt and their single edits, so that
    pairs at distance 1 straddle swarm_tpu's bucket widths 64 and 256."""
    rng = np.random.default_rng(seed)
    rows = []
    for L in (63, 64, 65, 255, 256, 257):
        base = rng.integers(0, 4, size=L).astype(np.uint8)
        rows += [base, np.insert(base, 0, 2), np.delete(base, L // 2)]
        v = base.copy()
        v[-1] = (v[-1] + 1) % 4
        rows.append(v)
    return rows


def _distinct(rows):
    out, seen = [], set()
    for r in rows:
        if len(r) and r.tobytes() not in seen:
            seen.add(r.tobytes())
            out.append(np.asarray(r, dtype=np.uint8))
    return out


@functools.lru_cache(maxsize=None)
def _case_db(case):
    if case == "mixed_71":
        rows, ab = _jax_bucketed_rows()
        db = _rows_db(rows)
        db.abundances = ab
        return db
    if case == "mixed_corpus":
        import tempfile
        from pathlib import Path

        with tempfile.TemporaryDirectory() as d:
            mixed_length_corpus(Path(d) / "m.fasta", n=1000, seed=5)
            return read_db(Path(d) / "m.fasta")
    return _rows_db(_distinct({
        "ragged_edge_rows": ragged_edge_rows,
        "clouds_and_long_reads": _clouds_and_long_reads,
        "bucket_edges": _bucket_edge_rows}[case]()))


def _arena(db):
    return sj.SortJoinNeighborEngine(db, "cpu").arena()


def _padded(db):
    width = -(-max(int(db.longest), 1) // 64) * 64
    return pad_codes(db.codes, db.offsets, db.lengths, width)


# ---- pack -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["ragged_edge_rows", "mixed_71",
                                  "mixed_corpus", "bucket_edges"])
def test_pack_ragged_equals_jax_pack2bit(case):
    """Row i's words at row_word[i] are swarm_tpu's packed padded row i
    up to its own 4 * ceil(len / 64) words, and the padded row's other
    words are zero; the count pass packs the same words."""
    db = _case_db(case)
    codes, offsets, lengths, row_word, n_words = _arena(db)
    want = jax_sj.pack2bit(_padded(db)).view(np.int32)
    words, layout = sj.pack_ragged(codes, offsets, lengths)
    assert torch.equal(layout, row_word) and words.numel() == n_words
    sizes = sj.row_sizes(db.lengths)
    assert n_words == int(sizes.sum()) and not (row_word % 4).any()
    for i in range(len(db)):
        s, z = int(row_word[i]), int(sizes[i])
        np.testing.assert_array_equal(words[s:s + z].numpy(), want[i, :z])
        assert not want[i, z:].any()
    counts, packed = sj.keygen_count(codes, offsets, lengths, row_word,
                                     n_words)
    assert torch.equal(packed, words)
    e_counts, e_words = emulate_count_pack(db.codes, db.offsets, db.lengths,
                                           row_word.numpy(), n_words)
    np.testing.assert_array_equal(e_words.astype(np.uint32).view(np.int32),
                                  words.numpy())
    np.testing.assert_array_equal(e_counts, counts.numpy())


# ---- keygen ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["ragged_edge_rows", "mixed_71",
                                  "mixed_corpus", "bucket_edges"])
def test_ragged_keygen_equals_jax(case):
    """The ragged keys, compacted in row and slot order, are swarm_tpu's
    deletion_keys_poly on the padded table at its valid slots, element
    for element; each row's count is its valid slots'."""
    db = _case_db(case)
    padded = _padded(db)
    (j0, j1), jvalid = jax.jit(jax_sj.deletion_keys_poly)(
        jnp.asarray(padded), jnp.asarray(db.lengths.astype(np.int32)))
    j0, j1, jvalid = (np.asarray(x) for x in (j0, j1, jvalid))
    want = (j0.astype(np.uint64) << np.uint64(32)
            | j1.astype(np.uint64)).view(np.int64)[jvalid]
    keys, owners, words = sj.deletion_keys(*_arena(db))
    np.testing.assert_array_equal(keys.numpy(), want)
    np.testing.assert_array_equal(owners.numpy(), np.nonzero(jvalid)[0])
    _, _, lengths, row_word, _ = _arena(db)
    ref_keys, ref_owners, counts = sj.ragged_keys_reference(
        words, row_word, lengths)
    assert torch.equal(ref_keys, keys) and torch.equal(ref_owners, owners)
    np.testing.assert_array_equal(counts.numpy(), jvalid.sum(axis=1))
    if case in ("mixed_71", "bucket_edges"):  # the emit kernel's schedule
        e_counts, e_keys, e_owners = emulate_keygen(
            words.numpy(), row_word.numpy(), db.lengths)
        np.testing.assert_array_equal(e_keys, want)
        np.testing.assert_array_equal(e_counts, counts.numpy())


def test_ragged_edge_rows_hold_every_edge_length():
    lengths = {len(r) for r in ragged_edge_rows()}
    for L in RAGGED_EDGE_LENGTHS:
        assert {L - 1, L, L + 1} - {0} <= lengths
    assert max(lengths) > 5000


# ---- verify ---------------------------------------------------------------

def _verify_pairs(case, db):
    """(a, b): every pair of rows whose lengths differ by at most one
    (on the mixed corpus, whose rows are many: the join's candidates);
    plus random pairs."""
    rng = np.random.default_rng(17)
    a, b = np.triu_indices(len(db), k=1)
    extra = rng.choice(len(a), size=min(300, len(a)), replace=False)
    if case == "mixed_corpus":
        keys, owners, _ = sj.deletion_keys(*_arena(db))
        keys, order = torch.sort(keys)
        cand = torch.unique(sj.join_pairs(keys, owners[order])).numpy()
        pairs = np.unique(np.concatenate([cand, a[extra] << 32 | b[extra]]))
        return pairs >> 32, pairs & 0xFFFFFFFF
    L = db.lengths
    pick = np.nonzero(np.abs(L[a] - L[b]) <= 1)[0]
    keep = np.unique(np.concatenate([pick, extra]))
    return a[keep].astype(np.int64), b[keep].astype(np.int64)


@pytest.mark.parametrize("case", ["ragged_edge_rows", "mixed_corpus",
                                  "bucket_edges"])
def test_ragged_verify_equals_jax_and_oracles(case):
    db = _case_db(case)
    padded = _padded(db)
    lengths = db.lengths.astype(np.int64)
    a, b = _verify_pairs(case, db)
    want = jax_sj.verify_dist1(padded, lengths, a, b)
    jp = jnp.asarray(jax_sj.pack2bit(padded))
    got_jax = np.asarray(jax.jit(jax_sj._verify_dist1_packed)(
        jp[a], jp[b], jnp.asarray(lengths[a], jnp.int32),
        jnp.asarray(lengths[b], jnp.int32)))
    np.testing.assert_array_equal(got_jax, want)
    np.testing.assert_array_equal(
        _native.verify_dist1_pairs(db.codes, db.offsets, db.lengths, a, b),
        want)
    codes, offsets, lens, row_word, _ = _arena(db)
    words, _ = sj.pack_ragged(codes, offsets, lens)
    pairs = torch.from_numpy(a << 32 | b)
    got = sj.verify_pairs(words, row_word, lens, pairs)
    np.testing.assert_array_equal(got.numpy(), want)
    sizes = sj.row_sizes(lengths)
    # pairs one uint4 apart (64 and 65 nt) and pairs at distance 1
    assert (sizes[a] != sizes[b])[want].any() and want.sum() >= 10
    if case != "mixed_corpus":
        np.testing.assert_array_equal(
            emulate_verify(words.numpy(), row_word.numpy(), lengths, a, b),
            want)


# ---- the engine -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_edges(case, no_break):
    """Edges of swarm_tpu's width-bucketed and single-table engines,
    which must agree."""
    db = _case_db(case)
    ab = db.abundances.astype(np.int64)
    got = jax_sj.BucketedSortJoinEngine(db).build_network(no_break, ab)
    single = jax_sj.SortJoinNeighborEngine(db).build_network(no_break, ab)
    for x, y in zip(got, single):
        np.testing.assert_array_equal(x, y)
    return got


def _native_edges(db, no_break):
    return _native.d1_network(db.codes, db.offsets, db.lengths,
                              db.abundances.astype(np.int64), no_break)


@pytest.mark.parametrize("no_break", [False, True])
@pytest.mark.parametrize("case", ["mixed_71", "clouds_and_long_reads",
                                  "bucket_edges"])
def test_engine_equals_jax_bucketed_engine_and_native(case, no_break):
    db = _case_db(case)
    assert jax_sj.BucketedSortJoinEngine.worthwhile(db.lengths) or \
        case == "bucket_edges"  # its rows straddle the buckets' edges
    ef, et = sj.SortJoinNeighborEngine(db, "cpu").build_network(
        no_break, db.abundances)
    jf, jt = _jax_edges(case, no_break)
    np.testing.assert_array_equal(ef, jf)
    np.testing.assert_array_equal(et, jt)
    nf, nt = _native_edges(db, no_break)
    np.testing.assert_array_equal(ef, nf)
    np.testing.assert_array_equal(et, nt)
    sizes = sj.row_sizes(db.lengths)
    assert (sizes[ef] != sizes[et]).any()  # pairs across widths
    if case == "mixed_71":  # the planted cross-bucket pair
        n = len(db)
        assert (n - 4, n - 3) in set(zip(ef.tolist(), et.tolist())) or \
            (n - 3, n - 4) in set(zip(ef.tolist(), et.tolist()))


@pytest.mark.parametrize("no_break", [False, True])
@pytest.mark.parametrize("case", ["ragged_edge_rows", "mixed_corpus"])
def test_engine_on_long_rows_equals_native(case, no_break):
    db = _case_db(case)
    eng = sj.SortJoinNeighborEngine(db, "cpu")
    eng.start()
    ef, et = eng.build_network(no_break, db.abundances)
    nf, nt = _native_edges(db, no_break)
    np.testing.assert_array_equal(ef, nf)
    np.testing.assert_array_equal(et, nt)
    assert int(db.longest) > 4000 and len(ef) > 0


# ---- the corpus -----------------------------------------------------------

def test_small_mixed_length_corpus_is_one_jax_would_bucket(tmp_path):
    n = mixed_length_corpus(tmp_path / "a.fasta", n=1000)
    assert n == 1000
    mixed_length_corpus(tmp_path / "b.fasta", n=1000)
    assert (tmp_path / "a.fasta").read_bytes() == \
        (tmp_path / "b.fasta").read_bytes()
    db = read_db(tmp_path / "a.fasta")
    assert len(db) == n  # dereplicated
    assert jax_sj.BucketedSortJoinEngine.worthwhile(db.lengths)
    for L in (64, 256, 1024, 4096):  # the fixed centres on bucket edges
        assert (db.lengths == L).any()
    assert int(db.longest) >= 4000 and (db.lengths <= 180).mean() > 0.3
