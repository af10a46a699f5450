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
- a numpy emulation of the join kernels' schedule (csrc/graft.cu: the
  count pass' bitonic network over each tile of the small side, once;
  binary searches and walks of equal keys, rounds of the big side, tiles
  beyond the first searched in place) equals the plain join at the
  kernel's tile and at a 16-element tile; join_count leaves the small
  side as the emulated network does, and no pair changes;
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
    fastidious_corpus,
    insertion_run,
    make_db,
    read_db,
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


@pytest.mark.parametrize("case", ["runs", "lengths_1_to_80", "empty_side"])
def test_ragged_keys_and_variants_equal_jax_per_row(tmp_path, case):
    """Each row's valid keys as a multiset, and the variant each key
    rebuilds: JAX's variant_keys_hilo slots decoded by its _variant_rows
    against the port's slots decoded by variant_rows_reference; the
    same multisets from JAX's variant_hash_halves."""
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
    width_port = 16 * int(sj.row_sizes(int(db.lengths.max()) + 1))
    vrows, vlens = ft.variant_rows_reference(*rows3, owner, slots,
                                             width_port)
    got = _per_row(owner, keys, vrows.numpy(), vlens.numpy())

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
    want = _per_row(torch.from_numpy(j_amp),
                    torch.from_numpy((hi[flat] << 32) | lo[flat]),
                    np.asarray(jrows), np.asarray(jlens))
    assert got == want

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


# ---- a numpy emulation of the join kernel's schedule ----------------------

def _bitonic(keys, at):
    """csrc/graft.cu: sort_tile's network on (key, at) pairs (at: the
    payloads there) over a power of two of at least 32 (padding: the
    largest key and at), as its threads run it stage by stage."""
    size = 32
    while size < len(keys):
        size <<= 1
    k = np.full(size, np.iinfo(np.int64).max, np.int64)
    a = np.full(size, INT32_MAX, np.int64)
    k[:len(keys)], a[:len(keys)] = keys, at
    i = np.arange(size)
    kk = 2
    while kk <= size:
        j = kk >> 1
        while j > 0:
            o = i ^ j
            lo = i[o > i]
            hi = lo ^ j
            greater = (k[lo] > k[hi]) | ((k[lo] == k[hi]) & (a[lo] > a[hi]))
            swap = greater == ((lo & kk) == 0)
            sl, sh = lo[swap], hi[swap]
            k[sl], k[sh] = k[sh].copy(), k[sl].copy()
            a[sl], a[sh] = a[sh].copy(), a[sl].copy()
            j >>= 1
        kk <<= 1
    return k, a


def emulate_sort_tiles(skeys, spays, s_ends, tile=2048):
    """(keys, payloads): the count kernel's tile sort, a block a bucket
    sorting each tile in place by (key, payload)."""
    keys, pays = skeys.copy(), spays.copy()
    for b in range(len(s_ends)):
        lo = s_ends[b - 1] if b else 0
        for first in range(lo, s_ends[b], tile):
            size = min(tile, s_ends[b] - first)
            k, a = _bitonic(keys[first:first + size],
                            pays[first:first + size])
            keys[first:first + size] = k[:size]
            pays[first:first + size] = a[:size]
    return keys, pays


def emulate_join(skeys, spays, s_ends, bkeys, bpays, b_ends, tile=2048,
                 threads=256):
    """(counts a bucket, pairs): the count kernel's and the emit
    kernel's schedule after the count pass' tile sort (emulate_sort_tiles):
    per bucket, rounds of `threads` big elements, each finding its key in
    every tile of the small bucket by a lower bound and walking the equal
    keys (a bucket of one tile in shared memory, the tiles of a larger
    one where they lie); the emit pass places a round's pairs by an
    exclusive scan of the round's counts."""
    nb = len(s_ends)
    counts = np.zeros(nb, np.int64)
    pairs = []
    for b in range(nb):
        s_lo = s_ends[b - 1] if b else 0
        b_lo = b_ends[b - 1] if b else 0
        s_n, b_n = s_ends[b] - s_lo, b_ends[b] - b_lo
        if s_n == 0 or b_n == 0:
            continue
        tiles = [(first, skeys[first:min(first + tile, s_lo + s_n)])
                 for first in range(s_lo, s_lo + s_n, tile)]
        for r in range(0, b_n, threads):
            out = [[] for _ in range(threads)]
            for t in range(min(threads, b_n - r)):
                key = bkeys[b_lo + r + t]
                for first, k in tiles:
                    i = int(np.searchsorted(k, key))  # lower_bound
                    while i < len(k) and k[i] == key:
                        out[t].append((int(spays[first + i]) << 32)
                                      | int(bpays[b_lo + r + t]))
                        i += 1
            counts[b] += sum(len(o) for o in out)
            for o in out:  # the scan's order: thread after thread
                pairs += o
    return counts, np.array(pairs, np.int64)


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


@pytest.mark.parametrize("tile,threads", [(2048, 256), (16, 8)])
@pytest.mark.parametrize("case", ["random", "insertion_run",
                                  "fastidious_corpus"])
def test_join_kernel_emulation(tmp_path, case, tile, threads):
    skeys, spays, s_ends, bkeys, bpays, b_ends = _join_case(tmp_path, case)
    sorted_keys, sorted_pays = emulate_sort_tiles(
        skeys.numpy(), spays.numpy(), s_ends.numpy(), tile)
    counts, pairs = emulate_join(sorted_keys, sorted_pays, s_ends.numpy(),
                                 bkeys.numpy(), bpays.numpy(),
                                 b_ends.numpy(), tile, threads)
    if case == "random":  # every equal pair, once
        eq = torch.nonzero(skeys[:, None] == bkeys[None, :])
        assert sorted(pairs.tolist()) == sorted(
            (spays[eq[:, 0]].long() << 32 | bpays[eq[:, 1]].long()).tolist())
    # the plain versions on the side as the count pass leaves it
    keys, pays = (torch.from_numpy(x) for x in (sorted_keys, sorted_pays))
    want = ft.join_reference(keys, pays, bkeys, bpays)
    assert np.array_equal(pairs, want.numpy())
    assert np.array_equal(counts, ft.join_count_reference(keys, bkeys,
                                                          b_ends).numpy())
    assert want.numel() > 0
    if tile == ft.JOIN_TILE:  # the wrappers
        assert torch.equal(
            ft.join_pairs(skeys, spays, s_ends, bkeys, bpays, b_ends), want)
    else:  # some bucket of the small side spans several tiles
        assert int(torch.diff(s_ends, prepend=s_ends.new_zeros(1)).max()) \
            > tile


@pytest.mark.parametrize("tile", [2048, 16])
@pytest.mark.parametrize("case", ["random", "insertion_run",
                                  "fastidious_corpus"])
def test_join_count_sorts_the_tiles_as_the_network_does(tmp_path, case,
                                                        tile):
    """The tile sort's plain version equals the count kernel's emulated
    network; the sorted side stays partitioned and gives the same pairs,
    in the same order where the payloads rise with their place;
    join_count leaves the side so."""
    for permuted in (True, False):
        (tmp_path / str(permuted)).mkdir()
        skeys, spays, s_ends, bkeys, bpays, b_ends = _join_case(
            tmp_path / str(permuted), case, permuted)
        keys, pays = ft.sort_tiles_reference(skeys, spays, s_ends, tile)
        want_keys, want_pays = emulate_sort_tiles(
            skeys.numpy(), spays.numpy(), s_ends.numpy(), tile)
        assert np.array_equal(keys.numpy(), want_keys)
        assert np.array_equal(pays.numpy(), want_pays)
        assert not torch.equal(keys, skeys)  # some tile was out of order
        sj._check_partitioned(keys, pays, s_ends)
        pairs = ft.join_reference(keys, pays, bkeys, bpays)
        before = ft.join_reference(skeys, spays, bkeys, bpays)
        assert sorted(pairs.tolist()) == sorted(before.tolist())
        if not permuted:
            assert torch.equal(pairs, before)
        if tile == ft.JOIN_TILE:  # the wrapper, in place
            ft.join_count(skeys, spays, s_ends, bkeys, b_ends)
            assert torch.equal(skeys, keys) and torch.equal(spays, pays)


def test_bitonic_network_sorts_by_key_then_place():
    rng = np.random.default_rng(11)
    for size in (1, 5, 32, 33, 100, 2048):
        keys = rng.integers(-3, 3, size) * (1 << 50)
        k, a = _bitonic(keys, np.arange(size))
        order = np.lexsort((np.arange(size), keys))
        assert np.array_equal(k[:size], keys[order])
        assert np.array_equal(a[:size], order)


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
