"""swarm_tpu_torch's fastidious graft (ops/fastidious_torch.py) against
swarm_tpu's, on the CPU, exactly:

- keygen: the Zobrist table is JAX's whatever the width; the port's
  variant_hash_halves equals JAX's slot for slot; each ragged row's
  valid keys, as a multiset, equal JAX's variant_hash_halves and
  variant_keys_hilo, and so do the variants the keys rebuild (JAX's
  _variant_rows on its slots, the port's variant_rows_reference on its
  own); an empty side has no key;
- the engine: GraftEngine(db, "cpu").graft_candidates equals JAX's
  GraftEngine in its sort mode (SWARM_TPU_GRAFT=sorted) and its probe
  mode (=chunked), the native graft_join and models/d1._graft_join on
  seeded corpora; strips of the bigger side equal one pass;
- a numpy emulation of the join kernels' schedule (csrc/graft.cu: a
  block a chunk of the big side, one hash table over the small elements
  of the buckets it touches, in tiles, each big key probed once a tile;
  the count pass' records and links, the emit pass from the records
  alone) equals the plain versions and brute force at the kernel's
  chunk and tile and at chunks of 8 and tables of 8 elements; join_items
  covers every bucket in (bucket, chunk) order; join_count writes
  neither side;
- a numpy emulation of the keygen emit pass' staged stores (a chunk's
  keys in slot order out as 16-byte pairs with a scalar head and tail,
  the deletions by rank, the payloads as an iota of quads) equals
  variant_keys_reference;
- an emulation of the verify kernel's schedule (groups of G lanes: the
  k-ary row search with its interpolated first round, the run-start
  scan across the lanes, variant words built by funnel shifts and
  compared G at a time) equals verify_reference and best_reference on
  graft_edge_rows (edits on the 16-base word edges) and a fastidious
  side, pairs of equal keys and random ones; verify_reference equals
  the equality of JAX's _variant_rows of the two keys; the emulation
  traps where the kernel does;
- the dispatch of models/d1.py: the native join up to
  SWARM_TPU_GRAFT_PROBE_MAX keys on the smaller side (read at each
  call), the device engine above it, with the same outputs.

tests/test_torch_cuda.py holds the kernels against the plain versions
on the card; tests/test_torch_cli.py holds the CLI's -f outputs against
bin/swarm with the device graft forced on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from swarm_tpu.ops import fastidious_jax
from swarm_tpu.ops.neighbors import pad_codes as jax_pad_codes
from swarm_tpu.ops.neighbors_jax import _round_up
from swarm_tpu.ops.neighbors_jax import make_zobrist_pair as jax_zobrist
from swarm_tpu.ops.neighbors_jax import variant_hash_halves as jax_halves
from swarm_tpu_torch import _native
from swarm_tpu_torch.corpora import (
    GRAFT_EDGE_LENGTHS,
    fastidious_corpus,
    graft_edge_rows,
    insertion_run,
    make_db,
    read_db,
    record_index,
    rows_records,
)
from swarm_tpu_torch.ops import fastidious_torch as ft
from swarm_tpu_torch.ops import neighbors_sortjoin as sj
from test_jax_neighbors import _random_db

INT32_MAX = 2**31 - 1
M32 = 0xFFFFFFFF


def _run_rows(seed, n=40, longest=80):
    """Distinct code rows of 1..longest bases built from homopolymer
    runs (so deletions inside runs are not canonical), with rows of one
    base and of one repeated base."""
    rng = np.random.default_rng(seed)
    rows = [np.array([c], np.uint8) for c in range(4)] + [
        np.full(7, 2, np.uint8)]
    while len(rows) < n:
        runs = rng.integers(1, 5, size=rng.integers(1, longest // 2))
        row = np.repeat(rng.integers(0, 4, size=runs.size), runs)[:longest]
        rows.append(row.astype(np.uint8))
    out, seen = [], set()
    for r in rows:
        if r.tobytes() not in seen:
            seen.add(r.tobytes())
            out.append(r)
    return out


def _padded(db, width):
    return jax_pad_codes(db.codes, db.offsets, db.lengths, width)


def test_zobrist_table_is_jaxs_whatever_the_width():
    """The port sizes the table by the longest row; JAX by the padded
    width: the rows they share are equal."""
    for longest, width in ((1, 64), (80, 128), (166, 192), (700, 704)):
        assert np.array_equal(ft.make_zobrist_pair(longest),
                              jax_zobrist(width)[:longest + 2])


@pytest.mark.parametrize("seed", [1, 2])
def test_variant_hash_halves_equal_jax(tmp_path, seed):
    """Slot for slot on one padded table: both halves, the sequence
    hashes and the valid slots."""
    db = make_db(tmp_path, rows_records(_run_rows(seed)))
    width = 96
    padded = _padded(db, width)
    lengths = db.lengths.astype(np.int32)
    zob = jax_zobrist(width)
    (hi, lo), (shi, slo), valid = jax_halves(
        jnp.asarray(padded), jnp.asarray(lengths), jnp.asarray(zob))
    (thi, tlo), (tshi, tslo), tvalid = ft.variant_hash_halves(
        torch.from_numpy(padded), torch.from_numpy(lengths),
        torch.from_numpy(zob.astype(np.int64)))
    for want, got in ((hi, thi), (lo, tlo), (shi, tshi), (slo, tslo)):
        assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    assert np.array_equal(np.asarray(valid), tvalid.numpy())


def _port_side(db, amps):
    """The port's keys of rows `amps` with their (amp, slot)."""
    words, row_word, lengths = ft.GraftEngine(db, "cpu").packed_rows()
    ids = torch.from_numpy(np.asarray(amps, dtype=np.int64))
    zob = ft.zobrist_tensor(ft.make_zobrist_pair(int(db.lengths.max())),
                            "cpu")
    keys, counts = ft.variant_keys_reference(words, row_word, lengths, ids,
                                             zob)
    assert torch.equal(counts.to(torch.int32),
                       ft.keygen_count(words, row_word, lengths, ids))
    owner = torch.repeat_interleave(ids, counts)
    slots = torch.arange(keys.numel()) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    return (words, row_word, lengths), keys, owner, slots


def _per_row(amps, keys, rows=None, lens=None):
    """{amp: sorted [(key, variant bytes)]}."""
    out = {}
    for i, (a, k) in enumerate(zip(amps.tolist(), keys.tolist())):
        seq = b"" if rows is None else bytes(rows[i, :lens[i]].tolist())
        out.setdefault(a, []).append((k, seq))
    return {a: sorted(v) for a, v in out.items()}


def _port_variants(db, rows3, keys, owner, slots):
    """{amp: sorted [(key, variant bytes)]} of the port's keys, each
    variant rebuilt by variant_rows_reference from its slot."""
    width = 16 * int(sj.row_sizes(int(db.lengths.max()) + 1))
    vrows, vlens = ft.variant_rows_reference(*rows3, owner, slots, width)
    return _per_row(owner, keys, vrows.numpy(), vlens.numpy())


def _jax_variants(db):
    """{amp: sorted [(key, variant bytes)]} of JAX's valid keys of every
    row, each variant rebuilt by JAX's _variant_rows from its slot of
    variant_keys_hilo."""
    n = len(db)
    width = _round_up(int(db.lengths.max()), 64)
    lcap = min(_round_up(int(db.lengths.max()), 16), width)
    padded = jnp.asarray(_padded(db, width))
    lengths = jnp.asarray(db.lengths.astype(np.int32))
    zob = jnp.asarray(jax_zobrist(width))
    ids = jnp.asarray(np.arange(n, dtype=np.int32))
    hi, lo, sent = fastidious_jax.variant_keys_hilo(
        padded, lengths, zob, ids, chunk_rows=n, lcap=lcap)
    assert int(sent[0]) == 0
    S = 7 * lcap + 4
    hi, lo = np.asarray(hi).astype(np.int64), np.asarray(lo).astype(np.int64)
    ok = ~((hi == M32) & (lo == M32))
    flat = np.nonzero(ok)[0]
    j_amp, j_slot = flat // S, flat % S
    jrows, jlens = fastidious_jax._variant_rows(
        padded, lengths, jnp.asarray(j_amp, jnp.int32),
        jnp.asarray(j_slot, jnp.int32), width, lcap)
    return _per_row(torch.from_numpy(j_amp),
                    torch.from_numpy((hi[flat] << 32) | lo[flat]),
                    np.asarray(jrows), np.asarray(jlens))


def _edge_db(tmp_path):
    """(db, light [n] bool) of graft_edge_rows up to 48 nt (its 5-kb rows
    are the card's)."""
    rows, light = graft_edge_rows(lengths=GRAFT_EDGE_LENGTHS[:-1])
    db = make_db(tmp_path, rows_records(rows))
    return db, light[record_index(db)]


@pytest.mark.parametrize("case", ["runs", "lengths_1_to_80", "empty_side",
                                  "graft_edge_rows"])
def test_ragged_keys_and_variants_equal_jax_per_row(tmp_path, case):
    """Each row's valid keys as a multiset, and the variant each key
    rebuilds: JAX's variant_keys_hilo slots decoded by its _variant_rows
    against the port's slots decoded by variant_rows_reference; the
    same multisets from JAX's variant_hash_halves."""
    if case == "graft_edge_rows":
        db, _ = _edge_db(tmp_path)
    else:
        rows = _run_rows(3) if case == "runs" else [
            np.random.default_rng(L).integers(0, 4, L).astype(np.uint8)
            for L in range(1, 81)]
        db = make_db(tmp_path, rows_records(rows))
    n = len(db)
    amps = np.arange(n) if case != "empty_side" else np.arange(0)
    rows3, keys, owner, slots = _port_side(db, amps)
    if case == "empty_side":
        assert keys.numel() == 0 and owner.numel() == 0
        return
    assert _port_variants(db, rows3, keys, owner, slots) == _jax_variants(db)

    width = _round_up(int(db.lengths.max()), 64)
    padded = jnp.asarray(_padded(db, width))
    lengths = jnp.asarray(db.lengths.astype(np.int32))
    zob = jnp.asarray(jax_zobrist(width))
    (h_hi, h_lo), _, valid = jax_halves(padded, lengths, zob)
    valid = np.asarray(valid)
    h_keys = (np.asarray(h_hi).astype(np.int64) << 32) | np.asarray(h_lo)
    at = np.nonzero(valid)
    assert _per_row(owner, keys) == _per_row(torch.from_numpy(at[0]),
                                             torch.from_numpy(h_keys[at]))


def _sides(db, seed, share=0.4):
    rng = np.random.Generator(np.random.PCG64(seed + 99))
    light = rng.random(len(db)) < share
    return np.nonzero(~light)[0], np.nonzero(light)[0]


def _jax_graft(db, heavy, light, mode, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_GRAFT", mode)
    width = _round_up(int(db.lengths.max()), 64)
    eng = fastidious_jax.GraftEngine(
        jax_pad_codes(db.codes, db.offsets, db.lengths, width),
        db.lengths.astype(np.int32), jax_zobrist(width))
    eng.KEYGEN_CHUNK = 256  # the sort mode's row chunk: small on the CPU
    return eng.graft_candidates(heavy, light)


@pytest.mark.parametrize("seed", [0, 3, 8])
def test_engine_equals_jax_native_and_python(seed, monkeypatch):
    from swarm_tpu_torch.models.d1 import NO_SWARM, _graft_join
    from swarm_tpu_torch.ops.neighbors import NeighborIndex

    db = _random_db(n=260, min_len=20, max_len=60, seed=seed)
    heavy, light = _sides(db, seed)
    count, cand = ft.GraftEngine(db, "cpu").graft_candidates(heavy, light)
    assert count > 0
    for mode in ("sorted", "chunked"):
        j_count, j_cand = _jax_graft(db, heavy, light, mode, monkeypatch)
        assert count == j_count, mode
        assert np.array_equal(cand, j_cand), mode
    n_count, n_cand = _native.graft_join(db.codes, db.offsets, db.lengths,
                                         len(db), heavy, light)
    assert count == n_count and np.array_equal(cand, n_cand)
    p_count, p_cand = _graft_join(db, NeighborIndex(db), heavy, light)
    assert count == p_count
    assert np.array_equal(np.where(cand < 0, NO_SWARM, cand), p_cand)


def test_engine_on_a_fastidious_corpus_equals_native(tmp_path):
    """gen_corpus' clouds with satellites, the light side the satellites
    and a share of the clouds; the heavy side then the smaller."""
    fastidious_corpus(tmp_path / "f.fasta", n=600, length=60, seed=4)
    db = read_db(tmp_path / "f.fasta")
    heavy, light = _sides(db, 4, share=0.7)
    count, cand = ft.GraftEngine(db, "cpu").graft_candidates(heavy, light)
    want = _native.graft_join(db.codes, db.offsets, db.lengths, len(db),
                              heavy, light)
    assert count == want[0] > 0
    assert np.array_equal(cand, want[1])


@pytest.mark.parametrize("n,strip_keys", [(40, 1), (300, 8_000),
                                          (300, 20_000)])
def test_strips_equal_one_pass(n, strip_keys):
    """Strips of one row each, of a few rows, and two strips."""
    db = _random_db(n=n, min_len=20, max_len=50, seed=5)
    heavy, light = _sides(db, 5, share=0.5)
    want = ft.GraftEngine(db, "cpu").graft_candidates(heavy, light)
    eng = ft.GraftEngine(db, "cpu")
    eng.MAX_STRIP_KEYS = strip_keys
    got = eng.graft_candidates(heavy, light)
    assert got[0] == want[0] > 0
    assert np.array_equal(got[1], want[1])


def test_strips_cover_the_side_in_order():
    counts = np.array([5, 0, 7, 3, 9, 1])
    assert ft._strips(counts, 10) == [(0, 2), (2, 4), (4, 6)]
    assert ft._strips(counts, 1) == [(i, i + 1) for i in range(6)]
    assert ft._strips(counts, 100) == [(0, 6)]


def test_empty_side_gives_no_candidate():
    db = _random_db(n=50, min_len=20, max_len=30, seed=6)
    count, cand = ft.GraftEngine(db, "cpu").graft_candidates(
        np.arange(len(db)), np.arange(0))
    assert count == 0 and (cand == -1).all()


# ---- numpy emulations of the join kernels' schedule ----------------------

def _slot_of(key, bits):
    """csrc/graft.cu: slot_of, the table's home slot of a key."""
    return ((int(key) * 0x9E3779B97F4A7C15) & (2**64 - 1)) >> (64 - bits)


class _Table:
    """build_table's hash table over n small keys: open addressing with
    linear probing from slot_of; a slot holds the smallest element of its
    key and the key's number of elements; every probe compares the full
    key. (The kernel inserts in parallel, so a slot may differ from this
    sequential schedule's; what a slot holds does not.)"""

    def __init__(self, keys, min_bits):
        self.keys, self.bits = keys, min_bits
        while (1 << self.bits) < 2 * len(keys):
            self.bits += 1
        size = 1 << self.bits
        self.table = np.full(size, -1, np.int64)
        self.cnt = np.zeros(size, np.int64)
        self.slot = np.zeros(len(keys), np.int64)
        for i, key in enumerate(keys):
            h = _slot_of(key, self.bits)
            while self.table[h] >= 0 and keys[self.table[h]] != key:
                h = (h + 1) % size
            if self.table[h] < 0:
                self.table[h] = i
            self.slot[i] = h
            self.cnt[h] += 1

    def find(self, key):
        h = _slot_of(key, self.bits)
        while self.table[h] >= 0:
            if self.keys[self.table[h]] == key:
                return h
            h = (h + 1) % len(self.table)
        return -1


#: a link the emulated kernel did not write
UNWRITTEN = -7


def _link_tile(tab, skeys, tile_lo, own, every, later, s_hi, links):
    """link_tile: the elements [own, n) to link listed in order; a key's
    next after the tile (none, or with `every` its smallest later
    element); warp 0's walk from the list's end in chunks of 32, each
    element linked to the nearest later lane of its slot, else to the
    key's last one seen."""
    n = len(tab.keys)
    listed = [t for t in range(own, n)
              if every or tab.cnt[tab.slot[t]] >= 2]
    last = {}
    if every:
        for j in range(later, s_hi):
            h = tab.find(skeys[j])
            if h >= 0 and h not in last:
                last[h] = j
    for base in range((len(listed) - 1) // 32 * 32, -1, -32):
        lanes = listed[base:base + 32]
        for q, t in enumerate(lanes):
            g = tab.slot[t]
            later_lanes = [u for u in lanes[q + 1:] if tab.slot[u] == g]
            links[tile_lo + t] = tile_lo + later_lanes[0] if later_lanes \
                else last.get(g, -1)
        for t in reversed(lanes):
            last[tab.slot[t]] = tile_lo + t


def emulate_join_count(skeys, s_ends, bkeys, b_ends, chunk, tile,
                       min_bits):
    """(counts, rec, n_rec, links) of graft_join_count_kernel's schedule:
    chunk after chunk of the big side (a persistent block takes chunks b,
    b + grid, ...; first and last bucket from join_items), one table over
    the small span of the buckets it touches in tiles of `tile`, each big
    key probed in every tile (counts summed, the head from the first tile
    that holds the key), links by the chunk that holds a bucket's first
    big element, records in place order."""
    m_big = len(bkeys)
    bits = chunk.bit_length() - 1
    count_max = (1 << (32 - bits)) - 1
    starts = np.arange(0, m_big, chunk)
    first = np.searchsorted(b_ends, starts, side="right")
    last = np.searchsorted(b_ends, np.minimum(starts + chunk, m_big) - 1,
                           side="right")
    counts = np.zeros(len(starts), np.int64)
    n_rec = np.zeros(len(starts), np.int64)
    rec = np.full(m_big, -1, np.int64)
    links = np.full(len(skeys), UNWRITTEN, np.int64)
    for k, e0 in enumerate(starts):
        nb = min(chunk, m_big - e0)
        bf, bl = first[k], last[k]
        s_lo = s_ends[bf - 1] if bf else 0
        s_hi = s_ends[bl]
        own_lo = s_lo if (b_ends[bf - 1] if bf else 0) >= e0 else s_ends[bf]
        tiled = s_hi - s_lo > tile
        cnt = np.zeros(nb, np.int64)
        head = np.full(nb, -1, np.int64)
        for tile_lo in range(s_lo, s_hi, tile):
            n = min(tile, s_hi - tile_lo)
            tab = _Table(skeys[tile_lo:tile_lo + n], min_bits)
            for p in range(nb):
                h = tab.find(bkeys[e0 + p])
                if h >= 0:
                    cnt[p] += tab.cnt[h]
                    if head[p] < 0:
                        head[p] = tile_lo + tab.table[h]
            if tile_lo + n > own_lo:
                _link_tile(tab, skeys, tile_lo, max(own_lo - tile_lo, 0),
                           tiled, max(tile_lo + n, own_lo), s_hi, links)
        hit = np.nonzero(cnt)[0]
        rec[e0:e0 + len(hit)] = (head[hit] << 32) | (
            np.minimum(cnt[hit], count_max) << bits) | hit
        n_rec[k], counts[k] = len(hit), cnt.sum()
    return counts, rec, n_rec, links


def emulate_join_emit(spays, bpays, rec, n_rec, links, chunk):
    """graft_join_emit_kernel's schedule: chunk after chunk, its records
    in order, each its head's chain along the links (a saturated count
    walked to its end)."""
    bits = chunk.bit_length() - 1
    pairs = []
    for k, n in enumerate(n_rec):
        for v in rec[k * chunk:k * chunk + n]:
            j, c = int(v) >> 32, (int(v) & M32) >> bits
            pay = int(bpays[k * chunk + (int(v) & (chunk - 1))])
            if c == (1 << (32 - bits)) - 1:
                c, i = 1, j
                while links[i] >= 0:
                    c, i = c + 1, links[i]
            for step in range(c):
                assert j >= 0 and links[j] != UNWRITTEN or step == c - 1
                pairs.append((int(spays[j]) << 32) | pay)
                if step + 1 < c:
                    j = int(links[j])
    return np.array(pairs, np.int64)


def _join_case(tmp_path, case, permuted=True):
    """Two sides' keys and payloads partitioned into the same buckets;
    `permuted`: the small side's payloads out of place order (else they
    rise with their place, as the engine's do)."""
    if case == "random":
        rng = np.random.default_rng(9)
        sk = torch.from_numpy(rng.integers(-50, 50, 700) * (1 << 40))
        bk = torch.from_numpy(rng.integers(-50, 50, 3000) * (1 << 40))
        bits = 4
    else:
        rows = insertion_run() if case == "insertion_run" else None
        if rows is not None:
            db = make_db(tmp_path, rows_records(rows))
        else:
            fastidious_corpus(tmp_path / "f.fasta", n=300, length=40, seed=2)
            db = read_db(tmp_path / "f.fasta")
        light = np.arange(len(db)) % 3 == 0
        sk = _port_side(db, np.nonzero(light)[0])[1]
        bk = _port_side(db, np.nonzero(~light)[0])[1]
        bits = sj.bucket_bits(sk.numel() + bk.numel())
    sp = torch.from_numpy((np.random.default_rng(3).permutation(sk.numel())
                           if permuted else np.arange(sk.numel()))
                          .astype(np.int32))
    bp = torch.arange(bk.numel(), dtype=torch.int32)
    return (*sj.partition(sk, sp, bits), *sj.partition(bk, bp, bits))


#: (chunk, tile, smallest table bits): the kernel's, and tiny ones (chunks
#: of 8, tables of 8 elements in 16 slots) that chunk every big bucket
#: and tile every small span of more than 8
JOIN_PARAMS = [(ft.JOIN_CHUNK, ft.JOIN_TILE, 6), (8, 8, 4)]


@pytest.mark.parametrize("chunk,tile,min_bits", JOIN_PARAMS)
@pytest.mark.parametrize("case", ["random", "insertion_run",
                                  "fastidious_corpus"])
def test_join_kernel_emulation(tmp_path, case, chunk, tile, min_bits):
    """The count pass' counts, records and links and the emit pass' pairs
    as the kernels' schedule gives them, against the plain versions
    (join_record_reference, join_reference) and, on random keys, every
    equal pair by brute force."""
    skeys, spays, s_ends, bkeys, bpays, b_ends = _join_case(tmp_path, case)
    sk, se, bk, be = (x.numpy() for x in (skeys, s_ends, bkeys, b_ends))
    counts, rec, n_rec, links = emulate_join_count(sk, se, bk, be, chunk,
                                                   tile, min_bits)
    pairs = emulate_join_emit(spays.numpy(), bpays.numpy(), rec, n_rec,
                              links, chunk)
    want = ft.join_reference(skeys, spays, bkeys, bpays)
    assert want.numel() > 0
    assert np.array_equal(pairs, want.numpy())
    w_counts, w_record = ft.join_record_reference(skeys, s_ends, bkeys,
                                                  b_ends, chunk)
    assert np.array_equal(counts, w_counts.numpy())
    assert np.array_equal(n_rec, w_record.n_rec.numpy())
    valid = np.arange(len(bk)) % chunk < np.repeat(n_rec, chunk)[:len(bk)]
    assert np.array_equal(rec[valid], w_record.rec.numpy()[valid])
    # every link of a repeated key whose bucket the big side reaches is
    # written, and written links are the plain ones
    written = links != UNWRITTEN
    assert np.array_equal(links[written], w_record.links.numpy()[written])
    bucket = np.searchsorted(se, np.arange(len(sk)), side="right")
    reached = np.diff(be, prepend=0)[bucket] > 0
    repeats = np.unique(sk, return_counts=True)
    many = np.isin(sk, repeats[0][repeats[1] > 1])
    assert written[reached & many].all()
    if case == "random":  # every equal pair, once
        eq = torch.nonzero(skeys[:, None] == bkeys[None, :])
        assert sorted(pairs.tolist()) == sorted(
            (spays[eq[:, 0]].long() << 32 | bpays[eq[:, 1]].long()).tolist())
    if chunk == ft.JOIN_CHUNK:  # the wrappers
        assert torch.equal(
            ft.join_pairs(skeys, spays, s_ends, bkeys, bpays, b_ends), want)
    else:  # some big bucket spans chunks, some small span several tiles
        sizes = np.diff(be, prepend=0)
        assert sizes.max() > chunk
        assert np.diff(se, prepend=0).max() > tile


def _bucket_ends(sizes):
    return torch.cumsum(torch.tensor(sizes, dtype=torch.int64), 0)


@pytest.mark.parametrize("sizes", [
    [3, 0, 5, 0, 0, 9, 1, 0],          # small buckets, several to a chunk
    [0, 0, 0, 0],                       # an empty side
    [2, 40, 1, 0, 0, 0, 0, 17],         # a bucket over several chunks
    [0, 1000, 1, 0],                    # a skewed one, the rest tiny
])
def test_join_items_cover_every_bucket_in_order(sizes):
    """join_items: each chunk's first and last bucket hold its first and
    last element, so the chunks' pieces, taken chunk after chunk, cover
    every big element once, bucket by bucket, in (bucket, chunk) order."""
    chunk = 8
    b_ends = _bucket_ends(sizes)
    m_big = int(b_ends[-1])
    first, last = ft.join_items(b_ends, m_big, chunk)
    assert first.numel() == -(-m_big // chunk)
    pieces = []
    for k in range(first.numel()):
        e0, e1 = k * chunk, min((k + 1) * chunk, m_big)
        for b in range(int(first[k]), int(last[k]) + 1):
            lo = max(e0, int(b_ends[b - 1]) if b else 0)
            hi = min(e1, int(b_ends[b]))
            if hi > lo:
                pieces.append((b, k, lo, hi))
    assert [p[2:] for p in pieces] == sorted(p[2:] for p in pieces)
    assert [p[:2] for p in pieces] == sorted(p[:2] for p in pieces)
    covered = np.concatenate([np.arange(lo, hi) for *_, lo, hi in pieces]) \
        if pieces else np.zeros(0)
    assert np.array_equal(covered, np.arange(m_big))
    at = np.searchsorted(b_ends.numpy(), covered, side="right")
    assert np.array_equal(at, np.concatenate(
        [np.full(hi - lo, b) for b, _, lo, hi in pieces]) if pieces else at)


@pytest.mark.parametrize("case", ["random", "insertion_run",
                                  "fastidious_corpus"])
def test_join_count_leaves_the_small_side_as_it_was(tmp_path, case):
    skeys, spays, s_ends, bkeys, bpays, b_ends = _join_case(tmp_path, case)
    before = [x.clone() for x in (skeys, spays, s_ends, bkeys, bpays,
                                  b_ends)]
    counts, record = ft.join_count(skeys, s_ends, bkeys, b_ends)
    ends, total = sj._cumsum_total(counts)
    pairs = ft.join_emit(spays, bpays, record, ends, total)
    for x, y in zip(before, (skeys, spays, s_ends, bkeys, bpays, b_ends)):
        assert torch.equal(x, y)
    assert torch.equal(pairs, ft.join_reference(skeys, spays, bkeys, bpays))


# ---- a numpy emulation of the keygen emit pass' staged stores -------------

def _zob_keys(zob):
    """Z[p, b] as the int64 key (hi << 32) | lo."""
    return (zob[..., 0].astype(np.uint64) << np.uint64(32)) | \
        zob[..., 1].astype(np.uint64)


def _xor_scan(v):
    return np.bitwise_xor.accumulate(v)


def emulate_keygen_emit(rows, zob):
    """(keys, payloads, vector stores) of graft_emit_kernel's schedule on
    rows (code arrays, in order): per row the iota of payloads (scalar
    head to a multiple of 4, 16-byte quads, scalar tail), the walk's
    totals, then per chunk of 32 positions the 6 x 32 keys staged in slot
    order and written as a scalar head (an odd first key), pairs of keys
    (16-byte stores, each checked to start on an even key) and a scalar
    tail; the deletions staged by their rank among the chunk's run
    starts. Buffers start 16-byte aligned (key 0, payload 0)."""
    z = _zob_keys(zob)
    counts = [6 * len(r) + 4 + int((np.diff(r) != 0).sum()) + 1
              if len(r) else 0 for r in rows]
    ends = np.cumsum(counts)
    keys = np.zeros(int(ends[-1]) if rows else 0, np.uint64)
    pays = np.full(len(keys), -1, np.int64)
    written = np.zeros(len(keys), np.int64)
    vector = []
    for r, row in enumerate(rows):
        L = len(row)
        if L == 0:
            continue
        out = int(ends[r - 1]) if r else 0
        a, e = out, int(ends[r])
        head = min((4 - a % 4) % 4, e - a)
        pays[a:a + head] = np.arange(a, a + head)
        a += head
        quads = (e - a) // 4
        for i in range(quads):
            assert (a + 4 * i) % 4 == 0
            pays[a + 4 * i:a + 4 * i + 4] = np.arange(a + 4 * i, a + 4 * i + 4)
        pays[a + 4 * quads:e] = np.arange(a + 4 * quads, e)
        pos = np.arange(L)
        seq = np.bitwise_xor.reduce(z[pos, row])
        s_del = np.bitwise_xor.reduce(z[pos[1:] - 1, row[1:]]) if L > 1 \
            else np.uint64(0)
        s_ins = np.bitwise_xor.reduce(z[pos + 1, row])
        keys[out:out + 4] = z[0, :4] ^ s_ins
        written[out:out + 4] += 1
        pre0 = pre_del = pre_ins = np.uint64(0)
        before_chunk = 4
        del_at = out + 4 + 6 * L
        for base in range(0, L, 32):
            p = np.arange(base, min(base + 32, L))
            c = row[p].astype(np.int64)
            g0 = z[p, c]
            gd = np.where(p >= 1, z[np.maximum(p - 1, 0), c], np.uint64(0))
            gi = z[p + 1, c]
            inc0, incd, inci = _xor_scan(g0), _xor_scan(gd), _xor_scan(gi)
            before = np.concatenate([[before_chunk], c[:-1]])
            start = c != before
            prefix = pre0 ^ inc0 ^ g0
            del_after = s_del ^ pre_del ^ incd
            ins_after = s_ins ^ pre_ins ^ inci
            stage = np.zeros(6 * len(p), np.uint64)
            for k in range(3):
                o = k + (c <= k)
                stage[k::6] = seq ^ g0 ^ z[p, o]
                stage[3 + k::6] = prefix ^ g0 ^ ins_after ^ z[p + 1, o]
            d, cnt = out + 4 + 6 * base, len(stage)
            hd = min(d % 2, cnt)
            keys[d:d + hd] = stage[:hd]
            written[d:d + hd] += 1
            for i in range((cnt - hd) // 2):
                at = d + hd + 2 * i
                assert at % 2 == 0
                vector.append(at)
                keys[at:at + 2] = stage[hd + 2 * i:hd + 2 * i + 2]
                written[at:at + 2] += 1
            if hd + 2 * ((cnt - hd) // 2) < cnt:
                keys[d + cnt - 1] = stage[-1]
                written[d + cnt - 1] += 1
            dels = (prefix ^ del_after)[start]  # staged by rank
            keys[del_at:del_at + len(dels)] = dels
            written[del_at:del_at + len(dels)] += 1
            del_at += len(dels)
            pre0 ^= inc0[-1]
            pre_del ^= incd[-1]
            pre_ins ^= inci[-1]
            before_chunk = c[-1]
        assert del_at == int(ends[r])
    assert (written == 1).all()  # every key once
    return keys.view(np.int64), pays, vector


@pytest.mark.parametrize("case", ["edge_rows", "runs", "lengths_1_to_80",
                                  "empty_side"])
def test_keygen_emit_emulation(tmp_path, case):
    """The staged emit's keys and payloads equal variant_keys_reference
    and an iota, row after row, with chunk spans starting on odd and even
    keys (the scalar head), partial last chunks (the tail) and rows whose
    payload span starts anywhere in a quad."""
    from swarm_tpu_torch.corpora import ragged_edge_rows

    rows = {"edge_rows": lambda: ragged_edge_rows(
                lengths=(1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127)),
            "runs": lambda: _run_rows(4),
            "lengths_1_to_80": lambda: [
                np.random.default_rng(L).integers(0, 4, L).astype(np.uint8)
                for L in range(1, 81)],
            "empty_side": lambda: _run_rows(5)}[case]()
    db = make_db(tmp_path, rows_records(rows))
    amps = np.arange(len(db)) if case != "empty_side" else np.arange(0)
    rows3, want, _, _ = _port_side(db, amps)
    zob = ft.make_zobrist_pair(int(db.lengths.max()))
    side = [db.codes[db.offsets[a]:db.offsets[a] + db.lengths[a]]
            for a in amps]
    keys, pays, vector = emulate_keygen_emit(side, zob)
    assert np.array_equal(keys, want.numpy())
    assert np.array_equal(pays, np.arange(len(keys)))
    if case == "empty_side":
        assert len(keys) == 0
        return
    ids = torch.from_numpy(amps.astype(np.int64))
    ends, total = sj._cumsum_total(ft.keygen_count(*rows3, ids))
    got_keys, got_pays = ft.keygen_emit(*rows3, ids,
                                        ft.zobrist_tensor(zob, "cpu"), ends,
                                        total)
    assert np.array_equal(got_keys.numpy(), keys)
    assert np.array_equal(got_pays.numpy(), pays)
    outs = (ends - ends.diff(prepend=ends.new_zeros(1))).numpy()
    assert {int(o) % 2 for o in outs} == {0, 1} and vector  # both spans
    assert len({int(o) % 4 for o in outs}) > 2  # payload heads of 0-3


# ---- a numpy emulation of the verify kernel's schedule --------------------

SUB, DEL, INS = 0, 1, 2
ODD = 0x55555555


class _Trap(Exception):
    """Where graft_verify_kernel would __trap()."""


def _field_mask(k):
    return M32 if k >= 16 else 0 if k <= 0 else (1 << (2 * k)) - 1


def _popc(x):
    return bin(x).count("1")


def _scan(c):
    """Inclusive sums across the group's lanes, as its shuffles take
    them: log2(G) steps, each lane adding the value d lanes below."""
    incl, d = list(c), 1
    while d < len(c):
        incl = [v + (incl[s - d] if s >= d else 0) for s, v in enumerate(incl)]
        d <<= 1
    return incl


def _pivots(lo, hi, rows, total, pay, G, guided):
    """The lanes' pivots of a round: every G / 2 rows around the
    payload's interpolated row (clamped) in the first, G points
    splitting [lo, hi) evenly later."""
    if not guided:
        return [lo + (s + 1) * (hi - lo) // (G + 1) for s in range(G)]
    guess = int(float(pay) * rows / total) if total else 0
    return [min(max(guess + (s - G // 2) * (G // 2), lo), hi - 1)
            for s in range(G)]


def _find_rows(sides, pays, G, rounds):
    """find_rows: the k-ary search of both sides' ends (a pivot a lane a
    round, rising with the lane, the first round's around the payload's
    interpolated row; the pivots at or below the payload counted by a
    ballot, the new bounds taken from the lanes beside that count), then
    a candidate row a lane, the one whose keys hold the payload picked;
    [(amp, start)], the rounds appended to `rounds`."""
    f = [[0, len(ends)] for ends, _ in sides]
    guided = True
    while True:
        more = [hi - lo >= G for lo, hi in f]
        if not any(more):
            break
        rounds.append(more)
        for k, (ends, _) in enumerate(sides):
            if not more[k]:
                continue
            lo, hi = f[k]
            q = _pivots(lo, hi, len(ends), ends[-1], pays[k], G, guided)
            assert q == sorted(q) and lo <= q[0] and q[-1] < hi
            at = [ends[x] <= pays[k] for x in q]
            below = sum(at)
            assert at == [True] * below + [False] * (G - below)
            if below:
                f[k][0] = q[below - 1] + 1
            if below < G:
                f[k][1] = q[below]
        guided = False
    out = []
    for k, (ends, ids) in enumerate(sides):
        lo, hi = f[k]
        assert hi - lo < G
        hits = []
        for s in range(G):
            r = lo + s
            if r <= hi and r < len(ends):
                first = ends[r - 1] if r else 0
                if first <= pays[k] < ends[r]:
                    hits.append((ids[r], first))
        if not hits:
            raise _Trap("a payload outside its side")
        assert len(hits) == 1
        out.append(hits[0])
    return out


def _run_start(word, n_bases, rank, G):
    """run_start: G words a pass, a lane a word, the popcounts of their
    run-start masks scanned across the lanes."""
    words = (n_bases + 15) >> 4
    for w0 in range(0, words, G):
        ws = range(w0, w0 + G)
        starts = []
        for w in ws:
            x = word(w) if w < words else 0
            prev = word(w - 1) >> 30 if 1 <= w <= words else 0
            st = (((x ^ ((x << 2) & M32 | prev)) |
                   ((x ^ ((x << 2) & M32 | prev)) >> 1)) & ODD) & \
                _field_mask(n_bases - 16 * w)
            starts.append(st | 1 if w == 0 else st)
        c = [_popc(st) for st in starts]
        incl = _scan(c)
        if rank < incl[-1]:
            mine = [incl[s] - c[s] <= rank < incl[s] for s in range(G)]
            assert sum(mine) == 1
            s = mine.index(True)
            st = starts[s]
            for _ in range(rank - (incl[s] - c[s])):
                st &= st - 1
            return 16 * ws[s] + ((st & -st).bit_length() - 1) // 2
        rank -= incl[-1]
    raise _Trap("a deletion slot past the row's run starts")


def _decode(word, n_bases, slot, G):
    """decode: (type, position, base, from, variant length) of a slot;
    with from >= 0 the base is k of o_k = k + (x_from <= k), taken by
    variant_word."""
    if slot < 4:
        return INS, 0, slot, -1, n_bases + 1
    if slot < 4 + 6 * n_bases:
        p, j = divmod(slot - 4, 6)
        return (SUB, p, j % 3, p, n_bases) if j < 3 else \
            (INS, p + 1, j % 3, p, n_bases + 1)
    return DEL, _run_start(word, n_bases, slot - 4 - 6 * n_bases, G), 0, \
        -1, n_bases - 1


def _variant_word(v, w):
    """variant_word: word w of a variant from the source's words w - 1, w
    and w + 1 (zero outside the row's), by funnel shifts."""
    (kind, pos, base, at_code, _), word, src_words = v
    if at_code >= 0:
        base += ((word(at_code >> 4) >> (2 * (at_code & 15))) & 3) <= base

    def src(i):
        return word(i) if 0 <= i < src_words else 0

    cur = src(w)
    below = _field_mask(pos - 16 * w)
    if kind == DEL:  # __funnelshift_r(cur, next, 2)
        down = ((src(w + 1) << 32 | cur) >> 2) & M32
        return (cur & below) | (down & ~below & M32)
    at = _field_mask(pos + 1 - 16 * w) & ~below & M32
    b = (base * ODD) & at
    if kind == SUB:
        return (cur & ~at & M32) | b
    up = ((cur << 32 | src(w - 1)) << 2 >> 32) & M32  # __funnelshift_l
    return (cur & below) | b | (up & ~(below | at) & M32)


def emulate_verify(words, row_word, lengths, s_ids, s_ends, b_ids, b_ends,
                   pairs, small_is_heavy, best, G):
    """(ok, best, stats) of graft_verify_kernel's schedule with groups of
    G lanes: both rows found by find_rows, both slots decoded, the
    variants built G words a pass and compared lengths first, then a
    pass at a time (all lanes equal), best lowered for a verified pair;
    stats: the most search rounds and compare passes a pair took."""
    w32 = (words.numpy().astype(np.int64) & M32).tolist()
    rw, lens = row_word.tolist(), lengths.tolist()
    sides = [(s_ends.tolist(), s_ids.tolist()),
             (b_ends.tolist(), b_ids.tolist())]
    best = best.clone()
    ok, most_rounds, most_passes = [], 0, 0
    for pr in pairs.tolist():
        pays = [pr >> 32, pr & M32]
        rounds = []
        found = _find_rows(sides, pays, G, rounds)
        most_rounds = max(most_rounds, len(rounds))
        vs = []
        for (amp, start), pay in zip(found, pays):
            n_bases = lens[amp]

            def word(i, at=rw[amp]):
                return w32[at + i]

            vs.append((_decode(word, n_bases, pay - start, G), word,
                       (n_bases + 15) >> 4))
        same = vs[0][0][4] == vs[1][0][4]
        v_words = (vs[0][0][4] + 15) >> 4
        passes = 0
        for w0 in range(0, v_words, G):
            if not same:
                break
            passes += 1
            same = all(w >= v_words or
                       _variant_word(vs[0], w) == _variant_word(vs[1], w)
                       for w in range(w0, w0 + G))
        most_passes = max(most_passes, passes)
        ok.append(same)
        if same:
            heavy, light = (found[0][0], found[1][0]) if small_is_heavy \
                else (found[1][0], found[0][0])
            best[light] = min(int(best[light]), heavy)
    return torch.tensor(ok, dtype=torch.bool), best, (most_rounds,
                                                      most_passes)


def _verify_case(tmp_path, case):
    """(db, rows3, sides, pairs, small_is_heavy): a case's two sides (the
    side of fewer keys as the small one, as the engine takes it), each
    (ids, ends, keys by payload, owners); the pairs of equal keys
    (spay << 32) | bpay and 300 pairs of random payloads."""
    if case == "graft_edge_rows":
        db, light = _edge_db(tmp_path)
    else:
        fastidious_corpus(tmp_path / "f.fasta", n=300, length=60, seed=11)
        db = read_db(tmp_path / "f.fasta")
        light = np.random.default_rng(11).random(len(db)) < 0.3
    heavy, light = np.nonzero(~light)[0], np.nonzero(light)[0]
    lens = db.lengths.astype(np.int64)
    small_is_heavy = (7 * lens[heavy] + 4).sum() <= (7 * lens[light] + 4).sum()
    sides = []
    for amps in ((heavy, light) if small_is_heavy else (light, heavy)):
        rows3, keys, owner, _ = _port_side(db, amps)
        counts = ft.keygen_count(*rows3, torch.from_numpy(amps))
        sides.append((torch.from_numpy(amps), torch.cumsum(counts.long(), 0),
                      keys, owner))
    at = {}
    for i, k in enumerate(sides[0][2].tolist()):
        at.setdefault(k, []).append(i)
    pairs = [(a << 32) | b for b, k in enumerate(sides[1][2].tolist())
             for a in at.get(k, ())]
    rng = np.random.default_rng(12)
    pairs += ((rng.integers(0, sides[0][2].numel(), 300) << 32) |
              rng.integers(0, sides[1][2].numel(), 300)).tolist()
    return db, rows3, sides, torch.tensor(pairs), small_is_heavy


@pytest.mark.parametrize("lanes", [16, 2])
@pytest.mark.parametrize("case", ["graft_edge_rows", "fastidious_corpus"])
def test_verify_kernel_emulation(tmp_path, case, lanes):
    """The verify kernel's schedule (groups of 16 lanes, as the kernel's,
    and of 2, whose searches take many rounds and whose compares take
    many passes) equals verify_reference and best_reference on the
    pairs of equal keys and on random pairs: edits at positions 0, 15,
    16, 31, 32 and the last, appended bases, deletions inside runs,
    unequal lengths, rows of 1 to 50 nt."""
    db, rows3, sides, pairs, small_is_heavy = _verify_case(tmp_path, case)
    (s_ids, s_ends, _, _), (b_ids, b_ends, _, _) = sides
    want = ft.verify_reference(*rows3, s_ids, s_ends, b_ids, b_ends, pairs)
    want_best = torch.full((len(db),), INT32_MAX, dtype=torch.int32)
    ft.best_reference(s_ids, s_ends, b_ids, b_ends, pairs[want],
                      small_is_heavy, want_best)
    got, got_best, (rounds, passes) = emulate_verify(
        *rows3, s_ids, s_ends, b_ids, b_ends, pairs, small_is_heavy,
        torch.full((len(db),), INT32_MAX, dtype=torch.int32), lanes)
    assert torch.equal(got, want)
    assert torch.equal(got_best, want_best)
    n_joined = pairs.numel() - 300
    assert bool(want[:n_joined].all()) and n_joined > 100
    assert rounds <= _even_rounds(max(s_ids.numel(), b_ids.numel()),
                                  lanes) + 1
    assert passes == -(-((int(db.lengths.max()) + 1 + 15) // 16) // lanes)


def _even_rounds(rows, G):
    """Rounds of G evenly split pivots that take `rows` rows below G: a
    round takes n to ~n / (G + 1)."""
    return max(0, int(np.ceil(np.log(rows / G) / np.log(G + 1))))


@pytest.mark.parametrize("lengths", ["fastidious", "mixed"])
def test_verify_row_search_rounds(lengths):
    """find_rows on a side of 150,000 rows (ends: the key counts 6L + 4 +
    runs of rows of 142-158 nt, as a fastidious corpus', or of 63-4,879
    nt, as a mixed one's) picks np.searchsorted's row for 2,000 random
    payloads; the first round, around the interpolated row, leaves fewer
    than 16 rows for nearly every payload of the even lengths, and no
    search takes more than one round beyond an even split's."""
    rng = np.random.default_rng(13)
    rows = 150_000
    L = rng.integers(142, 159, rows) if lengths == "fastidious" else \
        np.exp(rng.uniform(np.log(63), np.log(4879), rows)).astype(np.int64)
    ends = np.cumsum(7 * L + 4 - rng.integers(0, L // 4 + 1))
    ids = rng.permutation(rows)
    side = (ends.tolist(), ids.tolist())
    counts = []
    for pay in rng.integers(0, int(ends[-1]), 2000).tolist():
        rounds = []
        (amp, start), _ = _find_rows([side, side], [pay, 0], 16, rounds)
        r = int(np.searchsorted(ends, pay, side="right"))
        assert (amp, start) == (ids[r], int(ends[r - 1]) if r else 0)
        counts.append(sum(more[0] for more in rounds))
    assert max(counts) <= _even_rounds(rows, 16) + 1
    if lengths == "fastidious":
        assert np.mean(np.array(counts) == 1) > 0.99


def test_verify_reference_equals_jax_variants(tmp_path):
    """verify_reference's flag of each pair (pairs of equal keys and
    random ones, on the word-edge rows) is the equality of JAX's
    _variant_rows of the two keys."""
    db, rows3, sides, pairs, _ = _verify_case(tmp_path, "graft_edge_rows")
    (s_ids, s_ends, skeys, s_owner), (b_ids, b_ends, bkeys, b_owner) = sides
    jax_rows = {}
    for amp, variants in _jax_variants(db).items():
        for key, seq in variants:
            assert jax_rows.setdefault((amp, key), seq) == seq
    spay, bpay = (pairs >> 32).tolist(), (pairs & M32).tolist()
    want = [jax_rows[(int(s_owner[a]), int(skeys[a]))] ==
            jax_rows[(int(b_owner[b]), int(bkeys[b]))]
            for a, b in zip(spay, bpay)]
    got = ft.verify_reference(*rows3, s_ids, s_ends, b_ids, b_ends, pairs)
    assert got.tolist() == want


@pytest.mark.parametrize("ends,pay", [(65, 65), (66, 65)])
def test_verify_emulation_traps_where_the_kernel_does(ends, pay):
    """One row of ten A (65 keys): a payload past its side's keys, and a
    deletion slot past the row's run starts (a side that claims 66
    keys), trap in the emulation and raise in the plain version."""
    words, lengths = torch.zeros(4, dtype=torch.int32), torch.tensor(
        [10], dtype=torch.int32)
    ids = torch.zeros(1, dtype=torch.int64)
    side = (ids, torch.tensor([ends]))
    pairs = torch.tensor([pay << 32])
    with pytest.raises(_Trap):
        emulate_verify(words, ids, lengths, *side, *side, pairs, True,
                       torch.zeros(1, dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        ft.verify_reference(words, ids, lengths, *side, *side, pairs)


# ---- the dispatch in models/d1.py ----------------------------------------

def test_dispatch_reads_the_threshold_at_each_call(tmp_path, monkeypatch):
    """-d 1 -f through main.run on the CPU: the device engine serves
    when the smaller side's keys exceed SWARM_TPU_GRAFT_PROBE_MAX (set
    after import), the native join otherwise; same bytes."""
    from genfasta import amplicon_cloud
    from swarm_tpu_torch import metrics
    from swarm_tpu_torch.main import run

    (tmp_path / "in.fasta").write_text(amplicon_cloud(
        seed=777, n_centers=12, cloud_size=35, length=70, max_edits=4,
        max_abundance=8))
    calls = []
    real = ft.GraftEngine.graft_candidates

    def spy(self, heavy, light):
        calls.append(self.device.type)
        return real(self, heavy, light)

    monkeypatch.setattr(ft.GraftEngine, "graft_candidates", spy)
    out = {}
    for probe_max in ("0", str(1 << 40)):
        monkeypatch.setenv("SWARM_TPU_GRAFT_PROBE_MAX", probe_max)
        work = tmp_path / probe_max
        work.mkdir()
        monkeypatch.chdir(work)
        metrics.reset()
        assert run(["-d", "1", "-f", "-o", "out.txt", "-s", "stats.txt",
                    "-l", "log.txt", "../in.fasta"], "swarm",
                   device="cpu") == 0
        out[probe_max] = [(work / f).read_bytes()
                          for f in ("out.txt", "stats.txt", "log.txt")]
        assert metrics.last_run["graft_join_comparisons"] > 0
    assert calls == ["cpu"]
    assert out["0"] == out[str(1 << 40)]
    assert b"Made 0 grafts" not in out["0"][2]
