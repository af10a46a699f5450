"""Seeded corpora for the card checks (chip_smoke.py, tests/test_torch_cuda.py).

Every generator is a pure function of its seed (numpy generators), so a
run on the card and a run on the CPU see the same sequences.

- ``gen_corpus``: dereplicated amplicon clouds of 20 around random
  centres (the d2_100k and d2_long corpora; same generator and default
  seed as the benchmark script's, so the files are identical).
- ``chain_corpus``: tie-heavy chains of edits for the exact-diff kernel.
- ``dense_cloud_corpus``: a few centres, each with a cloud of thousands
  of variants, so that the seed/subseed loop hands DeviceAligner target
  lists above its batch threshold.
- ``ragged_rows``, ``D2_DIFFS_BAND_CASES``: one family of ragged
  lengths, as padded code rows, for every band variant of the
  exact-diff kernel.
- ``score_edge_cases``: seeds and targets whose lengths sit on the edges
  of the full-row score kernel's schedule.
- ``band_edge_cases``: every band of the banded score kernel on ragged
  lengths, and seeds and targets whose lengths sit on the edges of the
  band.
- ``d1_edge_rows``, ``insertion_run``: rows on the edges of the d=1
  sort-join kernels (word edges, length 1, homopolymers, prefixes) and
  one run of 125 rows that share one key.
- ``ragged_edge_rows``: rows of mixed lengths on the edges of the
  ragged layout (1 to 5,003 nt), with their neighbours at distance 1.
- ``graft_edge_rows``: heavy rows and light rows two edits from them,
  whose graft pairs put the edits on the verify's word edges.
- ``mixed_length_corpus``: gen_corpus' clouds around centres of mixed
  lengths (V4, V3-V4, full-length 16S, long reads, and centres on JAX's
  width-bucket edges): the d1_mixed_1m corpus.
- ``fastidious_corpus``: gen_corpus' clouds (15 a centre) and
  low-abundance satellites 2 and 3 edits from a cloud member, the light
  swarms of a `-f` run: the d1_fastidious_200k (balanced) and
  d1_fastidious_asym_200k (a few thousand light amplicons) corpora.
- ``read_db``, ``make_db``: a corpus as a Db, read back through db_read;
  ``record_index``: where each of its amplicons came from.
"""

import io
from pathlib import Path

import numpy as np

#: (seed, d, (mismatch, gapopen, gapextend)) chain-corpus cases of the
#: d2_diffs kernel check: tie-heavy score sets, plus two bands above the
#: register variants (B = 39 and B = 67 take the local-memory variant)
D2_DIFFS_KERNEL_CASES = [
    (1, 2, (4, 12, 4)),
    (4, 2, (2, 2, 2)),   # gap-open == extend: dense b4/b8 ties
    (5, 4, (1, 1, 1)),   # everything ties
    (6, 2, (9, 3, 1)),
    (3, 3, (4, 12, 4)),
    (8, 9, (4, 2, 1)),
    (7, 16, (4, 2, 1)),
]


#: (B, d, (mismatch, gapopen, gapextend)) cases of the d2_diffs kernel
#: check on ragged_rows: every register variant B = 1..20 over five score
#: sets (three tie-heavy), then two that take the general variant: a
#: band above 20, and a cutoff the packed cost word has no room for
D2_DIFFS_BAND_CASES = [
    (B, max(1, B // 3),
     [(4, 12, 4), (2, 2, 2), (1, 1, 1), (18, 24, 13), (9, 3, 1)][B % 5])
    for B in range(1, 21)
] + [(25, 6, (4, 2, 1)), (8, 2, (70000, 3, 1))]


def ragged_rows(seed, n, length, max_edits):
    """(rows [n, Lmax] uint8, lens [n] int32): row 0 is a random
    sequence of `length` codes, row i is row 0 after 0..max_edits
    edits biased towards insertions or deletions, so lengths differ by
    up to max_edits; a tenth of the rows are unrelated or empty.
    Padding holds random codes: nothing may read it."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=length).astype(np.uint8)
    seqs = [base]
    while len(seqs) < n:
        kind = int(rng.integers(0, 20))
        if kind == 0:
            seqs.append(base[:0])
            continue
        if kind == 1:
            L = int(rng.integers(1, length + max_edits))
            seqs.append(rng.integers(0, 4, size=L).astype(np.uint8))
            continue
        v = base.copy()
        grow = bool(rng.integers(0, 2))
        for _ in range(int(rng.integers(0, max_edits + 1))):
            p = int(rng.integers(0, len(v)))
            op = int(rng.integers(0, 4))
            if op == 0:
                v[p] = (v[p] + 1 + rng.integers(0, 3)) % 4
            elif grow:
                v = np.insert(v, p, rng.integers(0, 4))
            elif len(v) > 1:
                v = np.delete(v, p)
        seqs.append(v)
    lens = np.array([len(v) for v in seqs], dtype=np.int32)
    rows = rng.integers(0, 4, size=(n, int(lens.max()))).astype(np.uint8)
    for i, v in enumerate(seqs):
        rows[i, : len(v)] = v
    return rows, lens


def score_edge_cases(strips, seed=20260819):
    """(name, padded [n, W] uint8, lengths [n] int32, seed_id, ids
    int64) cases for the full-row score kernel, which gives each of 32
    lanes a strip of C query columns, C the smallest of `strips` with
    32 * C >= W (several passes of 32 * max(strips) columns beyond).

    Seed lengths 1, 31, 32, 33 and one below, at and above 32 * C for
    every C of `strips`, and two passes and a bit; once with targets no
    longer than the seed (so W is the seed's length) and once with
    longer ones too. Targets are the seed after a few edits, cut or
    extended to lengths 1, 31, 32, 33 and around the seed's, plus an
    empty row; the last case of each seed is a one-element list.
    """
    rng = np.random.default_rng(seed)
    q_lens = {1, 31, 32, 33, 2 * 32 * strips[-1] + 7}
    for C in strips:
        q_lens |= {32 * C - 1, 32 * C, 32 * C + 1}
    for ql in sorted(q_lens):
        q = rng.integers(0, 4, size=ql).astype(np.uint8)
        for longer in (False, True):
            t_lens = {1, 31, 32, 33, ql - 1, ql, max(1, ql - 40), 0}
            if longer:
                t_lens |= {ql + 1, ql + 40}
            t_lens = sorted(t for t in t_lens if 0 <= t and (longer or t <= ql))
            W = max(t_lens + [ql])
            padded = rng.integers(0, 4, size=(len(t_lens) + 1, W)).astype(
                np.uint8)
            padded[0, :ql] = q
            for i, tl in enumerate(t_lens, start=1):
                m = min(tl, ql)
                keep = rng.random(m) < 0.9
                padded[i, :m] = np.where(keep, q[:m], padded[i, :m])
            lengths = np.array([ql] + t_lens, dtype=np.int32)
            ids = np.arange(1, len(lengths), dtype=np.int64)
            name = f"ql{ql}_{'longer' if longer else 'within'}"
            yield name, padded, lengths, 0, ids
        yield f"ql{ql}_one", padded, lengths, 0, ids[-1:]


#: (mismatch, gapopen, gapextend) sets of the score kernels' checks
SCORE_PENALTIES = ((4, 12, 4), (3, 6, 2), (18, 24, 13))


def band_edge_cases(seed=20260820):
    """(name, padded [n, W] uint8, lengths [n] int32, seed_id, ids, band,
    (mismatch, gapopen, gapextend)) cases for the banded score kernel,
    which keeps the 2B+1 slots of a pair in registers up to B = 20, reads
    rows 16 bytes at a time and peels the first B + 1 rows.

    Every band B = 1..20 and B = 21, 40, 63 (the general variant) with
    row 0 of ``ragged_rows`` as the seed against the other rows; B = 4
    under every set of SCORE_PENALTIES; then, for bands on both sides of
    the variants' limits, seeds of length 1, below B, just above B and
    well above it against targets of length 0, 1, the seed's, and the
    seed's -+ B (the band's last slots) and -+ (B + 1) (outside: INF);
    an empty seed; an empty list. Row widths are mostly no multiple of
    16, padding holds random codes, ids alternate between int32 and
    int64, penalties rotate through SCORE_PENALTIES.
    """
    rng = np.random.default_rng(seed)
    made = 0

    def case(name, padded, lengths, seed_id, ids, band, scores=None):
        nonlocal made
        made += 1
        return (name, padded, lengths, seed_id,
                ids.astype(np.int32 if made % 2 else np.int64), band,
                scores or SCORE_PENALTIES[made % 3])

    for B in list(range(1, 21)) + [21, 40, 63]:
        rows, lens = ragged_rows(200 + B, 40, 61 + B, B + 2)
        yield case(f"ragged_B{B}", rows, lens, 0, np.arange(1, len(lens)), B)
    rows, lens = ragged_rows(204, 40, 65, 6)
    for scores in SCORE_PENALTIES:
        yield case(f"ragged_B4_mm{scores[0]}", rows, lens, 0,
                   np.arange(1, len(lens)), 4, scores)
    for B in (1, 2, 4, 7, 20, 21, 63):
        for ql in sorted({1, max(1, B - 1), B + 2, 2 * B + 35}):
            q = rng.integers(0, 4, size=ql).astype(np.uint8)
            t_lens = sorted(t for t in {0, 1, ql, ql - B, ql + B, ql - B - 1,
                                        ql + B + 1} if t >= 0)
            W = max(t_lens + [ql])
            W += 3 if W % 16 == 0 else 0
            padded = rng.integers(0, 4, size=(len(t_lens) + 1, W)).astype(
                np.uint8)
            padded[0, :ql] = q
            for i, tl in enumerate(t_lens, start=1):
                m = min(tl, ql)
                keep = rng.random(m) < 0.9
                padded[i, :m] = np.where(keep, q[:m], padded[i, :m])
            lengths = np.array([ql] + t_lens, dtype=np.int32)
            ids = np.arange(1, len(lengths))
            yield case(f"B{B}_ql{ql}", padded, lengths, 0, ids, B)
    # the last matrix again: its row 1 is empty
    yield case("empty_seed", padded, lengths, 1, ids, 4)
    yield case("empty_list", padded, lengths, 0, ids[:0], 4)


def _edit(rng, v, min_len):
    """One random substitution, deletion or insertion of v (a copy)."""
    op = int(rng.integers(0, 3))
    p = int(rng.integers(0, len(v)))
    if op == 0:
        v = v.copy()
        v[p] = (v[p] + 1 + rng.integers(0, 3)) % 4
        return v
    if op == 1 and len(v) > min_len:
        return np.delete(v, p)
    return np.insert(v, p, rng.integers(0, 4))


_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _record(name, abundance, codes):
    return f">{name}_{abundance}\n{_ACGT[np.asarray(codes)].tobytes().decode()}\n"


def gen_corpus(path: Path, n: int, length: int, seed: int = 20260816) -> int:
    """Deterministic dereplicated amplicon clouds; returns actual count."""
    rng = np.random.Generator(np.random.Philox(seed))
    cloud = 20
    n_centers = max(1, n // cloud)
    seen = set()
    records = []
    idx = 0
    for _ in range(n_centers):
        L = int(rng.integers(length - 8, length + 9))
        center = rng.integers(0, 4, size=L).astype(np.uint8)
        variants = [center]
        for _ in range(cloud - 1):
            v = variants[int(rng.integers(0, len(variants)))].copy()
            for _ in range(int(rng.integers(1, 3))):
                v = _edit(rng, v, 10)
            variants.append(v)
        for v in variants:
            key = v.tobytes()
            if key in seen:
                continue
            seen.add(key)
            ab = int(rng.integers(1, 1000))
            records.append(_record(f"b{idx}", ab, v))
            idx += 1
            if idx >= n:
                break
        if idx >= n:
            break
    order = rng.permutation(len(records))
    with open(path, "w") as fh:
        fh.writelines(records[i] for i in order)
    return idx


#: centre lengths of mixed_length_corpus: (share of the drawn centres,
#: shortest, longest): V4-like amplicons, V3-V4, full-length 16S
MIXED_SHARES = ((0.90, 120, 180), (0.09, 380, 460), (0.01, 1400, 1600))
#: (centres, shortest, longest) that every mixed_length_corpus holds:
#: long reads, and centres on JAX's width-bucket edges 64 * 4^k, so that
#: their clouds' edits cross them
MIXED_FIXED = ((4, 4000, 5000), (2, 64, 64), (2, 256, 256), (2, 1024, 1024),
               (2, 4096, 4096))


def mixed_length_corpus(path: Path, n: int, seed: int = 20260824) -> int:
    """Dereplicated amplicon clouds of mixed lengths; returns the count.

    gen_corpus' shape (clouds of 20 around each centre, each member 1-2
    edits from an earlier one, abundances 1..999, records in a seeded
    random order), with the centres' lengths of MIXED_FIXED and, for
    the rest, MIXED_SHARES: about 188 nt a row. Every random number is
    drawn in bulk, and records are written through a byte table.
    """
    rng = np.random.Generator(np.random.Philox(seed))
    cloud = 20
    n_centers = n // cloud + n // 1000 + 2  # a few spare: duplicates
    fixed = [(lo, hi) for count, lo, hi in MIXED_FIXED for _ in range(count)]
    kind = rng.choice(len(MIXED_SHARES), size=max(0, n_centers - len(fixed)),
                      p=[share for share, _, _ in MIXED_SHARES])
    bounds = np.array(fixed + [MIXED_SHARES[k][1:] for k in kind])
    lengths = rng.integers(bounds[:, 0], bounds[:, 1] + 1)
    codes = rng.integers(0, 4, size=int(lengths.sum())).astype(np.uint8)
    n_var = len(lengths) * (cloud - 1)
    parent, pos = rng.random(n_var), rng.random((n_var, 2))
    n_edits = rng.integers(1, 3, size=n_var)
    op = rng.integers(0, 3, size=(n_var, 2))
    new = rng.integers(0, 4, size=(n_var, 2)).astype(np.uint8)
    shift = rng.integers(1, 4, size=(n_var, 2)).astype(np.uint8)
    abundance = rng.integers(1, 1000, size=len(lengths) * cloud)

    seen, records, t = set(), [], 0
    for centre in np.split(codes, np.cumsum(lengths)[:-1]):
        variants = [centre]
        for _ in range(cloud - 1):
            v = variants[int(parent[t] * len(variants))]
            for e in range(n_edits[t]):
                p = int(pos[t, e] * len(v))
                if op[t, e] == 0:
                    v = v.copy()
                    v[p] = (v[p] + shift[t, e]) % 4
                elif op[t, e] == 1 and len(v) > 10:
                    v = np.delete(v, p)
                else:
                    v = np.insert(v, p, new[t, e])
            variants.append(v)
            t += 1
        for v in variants:
            key = v.tobytes()
            if key in seen:
                continue
            seen.add(key)
            records.append(b">m%d_%d\n%s\n" % (
                len(records), abundance[len(records)], _ACGT[v].tobytes()))
            if len(records) >= n:
                break
        if len(records) >= n:
            break
    order = rng.permutation(len(records))
    with open(path, "wb") as fh:
        fh.writelines(records[i] for i in order)
    return len(records)


def _apply_edits(v, count, pos, op, new, shift, min_len=10):
    """v after `count` edits, the e-th at the fraction pos[e] of its
    length: a substitution by shift[e] (op 0), a deletion (op 1, above
    min_len) or an insertion of new[e]."""
    for e in range(count):
        p = int(pos[e] * len(v))
        if op[e] == 0:
            v = v.copy()
            v[p] = (v[p] + shift[e]) % 4
        elif op[e] == 1 and len(v) > min_len:
            v = np.delete(v, p)
        else:
            v = np.insert(v, p, new[e])
    return v


#: members of a fastidious_corpus cloud, centre included
FASTIDIOUS_CLOUD = 15


def fastidious_corpus(path: Path, n: int, length: int = 150,
                      satellites: float = 5.0,
                      seed: int = 20260826) -> int:
    """Amplicon clouds with light satellites; returns the count.

    gen_corpus' clouds (a centre of length +- 8, each member 1-2 edits
    from an earlier one, abundances 1..999), FASTIDIOUS_CLOUD members
    each, and `satellites` satellites a cloud on average (the fraction
    by a seeded draw a cloud): reads of abundance 1-2, 2 edits (3 in
    5) or 3 edits (2 in 5) from a random member of their cloud. After
    `-d 1` most satellites are light swarms of one read a few edits from
    a heavy one: 5 a cloud make a quarter of the reads light (balanced
    sides), 0.3 a cloud about 4,000 of 200,000 (a small light side).
    Every random number is drawn in bulk; records are written in a
    seeded random order.
    """
    rng = np.random.Generator(np.random.Philox(seed))
    cloud = FASTIDIOUS_CLOUD
    n_centers = int(n / (cloud + satellites)) + n // 1000 + 2
    lengths = rng.integers(length - 8, length + 9, size=n_centers)
    codes = rng.integers(0, 4, size=int(lengths.sum())).astype(np.uint8)
    n_sat = (int(satellites) + (rng.random(n_centers) < satellites % 1)
             ).astype(np.int64)
    n_var = n_centers * (cloud - 1) + int(n_sat.sum())
    parent, pos = rng.random(n_var), rng.random((n_var, 3))
    n_edits = np.concatenate([
        rng.integers(1, 3, size=n_centers * (cloud - 1)),
        np.where(rng.random(int(n_sat.sum())) < 0.6, 2, 3)])
    op = rng.integers(0, 3, size=(n_var, 3))
    new = rng.integers(0, 4, size=(n_var, 3)).astype(np.uint8)
    shift = rng.integers(1, 4, size=(n_var, 3)).astype(np.uint8)
    abundance = rng.integers(1, 1000, size=n_centers * cloud)
    sat_abundance = rng.integers(1, 3, size=int(n_sat.sum()))

    seen, records = set(), []
    t, s = 0, n_centers * (cloud - 1)  # next member's and satellite's draws
    a = sa = 0
    for centre, k in zip(np.split(codes, np.cumsum(lengths)[:-1]), n_sat):
        members = [centre]
        for _ in range(cloud - 1):
            members.append(_apply_edits(
                members[int(parent[t] * len(members))], n_edits[t], pos[t],
                op[t], new[t], shift[t]))
            t += 1
        group = [(v, abundance[a + i]) for i, v in enumerate(members)]
        a += cloud
        for _ in range(k):
            group.append((_apply_edits(
                members[int(parent[s] * cloud)], n_edits[s], pos[s], op[s],
                new[s], shift[s]), sat_abundance[sa]))
            s += 1
            sa += 1
        for v, ab in group:
            key = v.tobytes()
            if key in seen:
                continue
            seen.add(key)
            records.append(b">f%d_%d\n%s\n" % (len(records), ab,
                                                _ACGT[v].tobytes()))
            if len(records) >= n:
                break
        if len(records) >= n:
            break
    order = rng.permutation(len(records))
    with open(path, "wb") as fh:
        fh.writelines(records[i] for i in order)
    return len(records)


def chain_corpus(seed, n, length, edits):
    """n distinct records, each 1..edits edits away from an earlier one."""
    rng = np.random.default_rng(seed)
    seqs = []
    seen = set()
    base = rng.integers(0, 4, size=length).astype(np.uint8)
    pool = [base]
    while len(seqs) < n:
        v = pool[int(rng.integers(0, len(pool)))].copy()
        for _ in range(int(rng.integers(1, edits + 1))):
            v = _edit(rng, v, 12)
        key = v.tobytes()
        if key in seen:
            continue
        seen.add(key)
        pool.append(v)
        seqs.append(v)
    return [_record(f"t{i}", int(rng.integers(1, 500)), s)
            for i, s in enumerate(seqs)]


def dense_cloud_corpus(path: Path, n_centers: int, cloud: int, length: int,
                       seed: int = 20260817) -> int:
    """Dense amplicon clouds; returns the record count,
    n_centers * (2 * cloud + 2).

    Each family has a centre (the most abundant, so it becomes the
    seed) with `cloud` distinct variants 1-2 edits away, and a hub, 2
    substitutions from the centre and second in abundance, with `cloud`
    variants 1-2 edits away from the hub (up to 4 from the centre). The
    centre's target list holds its own cloud; the hub, attached in
    generation 1, finds its cloud as a subseed. Records are written in
    a seeded random order.
    """
    rng = np.random.Generator(np.random.Philox(seed))
    seen = set()
    records = []

    def add(name, abundance, v):
        seen.add(v.tobytes())
        records.append(_record(name, abundance, v))

    def add_cloud(prefix, origin):
        made = 0
        while made < cloud:
            v = origin
            for _ in range(int(rng.integers(1, 3))):
                v = _edit(rng, v, 10)
            if v.tobytes() in seen:
                continue
            add(f"{prefix}v{made}", int(rng.integers(1, 100)), v)
            made += 1

    for c in range(n_centers):
        L = int(rng.integers(length - 8, length + 9))
        centre = rng.integers(0, 4, size=L).astype(np.uint8)
        hub = centre.copy()
        for p in rng.choice(L, size=2, replace=False):
            hub[p] = (hub[p] + 1 + rng.integers(0, 3)) % 4
        add(f"c{c}", 100_000 - c, centre)
        add(f"c{c}h", 50_000 - c, hub)
        add_cloud(f"c{c}", centre)
        add_cloud(f"c{c}h", hub)
    order = rng.permutation(len(records))
    with open(path, "w") as fh:
        fh.writelines(records[i] for i in order)
    return len(records)


def d1_edge_rows(seed=20260821):
    """Distinct code rows (uint8 arrays) on the edges of the d=1 kernels:
    the four rows of length 1 (they share the key of the empty string),
    homopolymers (one run: a full key and one deletion) and their
    neighbours, and for lengths 15, 16, 17, 31, 32, 33, 63, 64, 65 (the
    edges of 16-base words and 64-base loads) a random row with
    substitutions, deletions and insertions at both ends and inside, a
    prefix one shorter (the first difference at the shorter's end) and
    rows at distance 2."""
    rng = np.random.default_rng(seed)
    rows = [np.array([c], dtype=np.uint8) for c in range(4)]
    for c in range(4):
        rows.append(np.full(10, c, dtype=np.uint8))
    rows += [np.full(9, 0, dtype=np.uint8), np.full(11, 0, dtype=np.uint8)]
    h = np.full(10, 2, dtype=np.uint8)
    h[4] = 1
    rows.append(h)
    for L in (15, 16, 17, 31, 32, 33, 63, 64, 65):
        base = rng.integers(0, 4, size=L).astype(np.uint8)
        rows.append(base)
        for p in (0, L // 2, L - 1):
            v = base.copy()
            v[p] = (v[p] + 1 + rng.integers(0, 3)) % 4
            rows.append(v)
            rows.append(np.delete(base, p))
        for p in (0, L // 3, L):
            rows.append(np.insert(base, p, rng.integers(0, 4)))
        two = base.copy()
        two[0] = (two[0] + 1) % 4
        two[L - 1] = (two[L - 1] + 2) % 4
        rows += [two, base[:L - 2], np.roll(base, 1)]
    out, seen = [], set()
    for r in rows:
        r = r.astype(np.uint8)
        if r.tobytes() not in seen:
            seen.add(r.tobytes())
            out.append(r)
    return out


#: lengths on the edges of the ragged layout: 16-base words, 64-base
#: uint4s, and the longest rows of a mixed corpus
RAGGED_EDGE_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1023, 1024,
                       1025, 4095, 4096, 4097, 5000, 5003)


def ragged_edge_rows(seed=20260825, lengths=RAGGED_EDGE_LENGTHS):
    """Distinct code rows of mixed lengths on the edges of the ragged
    layout: for each length, a random row, its substitutions, deletions
    and insertions at both ends and inside (a deletion of a 65-base row
    has one uint4 less), a prefix one shorter and a row at distance 2."""
    rng = np.random.default_rng(seed)
    rows = []
    for L in lengths:
        base = rng.integers(0, 4, size=L).astype(np.uint8)
        rows.append(base)
        for p in sorted({0, L // 2, L - 1}):
            v = base.copy()
            v[p] = (v[p] + 1 + rng.integers(0, 3)) % 4
            rows += [v, np.delete(base, p), np.insert(base, p, rng.integers(
                0, 4))]
        rows.append(np.append(base, rng.integers(0, 4)))
        if L >= 2:
            two = base.copy()
            two[0] = (two[0] + 1) % 4
            two[-1] = (two[-1] + 2) % 4
            rows += [two, base[:-1]]
    out, seen = [], set()
    for r in rows:
        r = r.astype(np.uint8)
        if len(r) and r.tobytes() not in seen:
            seen.add(r.tobytes())
            out.append(r)
    return out


#: base-row lengths of graft_edge_rows: one base, around one, two and
#: three 16-base words, and the longest reads of a mixed corpus
GRAFT_EDGE_LENGTHS = (1, 2, 15, 16, 17, 31, 32, 33, 48, 5004)


def graft_edge_rows(seed=20261019, lengths=GRAFT_EDGE_LENGTHS):
    """(rows, light): distinct code rows and which are light, whose graft
    pairs put the verify's edits on the edges of its 16-base words. For
    each length L a random base row, heavy, and light rows two edits from
    it (so that every pair's midpoint is one edit from both): a
    substitution, deletion or insertion at positions 0, 15, 16, 31, 32
    and L - 1 (those below L), each with a base appended after the last
    one or with a random second edit. From L = 48 on, the base row holds
    a run over 12-19 (across position 16) and one over 32-39 (starting
    on a word), so that the deletions at 15, 16 and 32 lie inside runs.
    The light rows are L - 2 to L + 2 bases long."""
    rng = np.random.default_rng(seed)
    rows, light, seen = [], [], set()

    def add(row, is_light):
        row = np.asarray(row, dtype=np.uint8)
        if len(row) and row.tobytes() not in seen:
            seen.add(row.tobytes())
            rows.append(row)
            light.append(is_light)

    def edit(v, kind, p):
        if kind == 0:
            v = v.copy()
            v[p] = (v[p] + 1 + rng.integers(0, 3)) % 4
            return v
        if kind == 1:
            return np.delete(v, p)
        return np.insert(v, p, rng.integers(0, 4))

    for L in lengths:
        base = rng.integers(0, 4, size=L).astype(np.uint8)
        if L >= 48:
            for lo, hi in ((12, 20), (32, 40)):
                c = base[lo]
                base[lo:hi] = c
                base[lo - 1] = base[hi] = (c + 1) % 4
        add(base, False)
        for p in sorted({p for p in (0, 15, 16, 31, 32, L - 1) if p < L}):
            for kind in range(3):
                one = edit(base, kind, p)
                add(np.append(one, rng.integers(0, 4)), True)
                if len(one):
                    q = int(rng.integers(0, len(one)))
                    add(edit(one, int(rng.integers(0, 3)), q), True)
    return rows, np.array(light, dtype=bool)


def insertion_run(seed=20260822, length=40):
    """A random row of `length` codes and every distinct single insertion
    of it (3 * length + 4 rows): all of them share the row's own key, so
    the sorted keys hold one run of 3 * length + 5 slots."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=length).astype(np.uint8)
    out, seen = [base], {base.tobytes()}
    for p in range(length + 1):
        for b in range(4):
            v = np.insert(base, p, b).astype(np.uint8)
            if v.tobytes() not in seen:
                seen.add(v.tobytes())
                out.append(v)
    return out


def rows_records(rows, seed=20260823):
    """FASTA records of code rows, with seeded abundances."""
    rng = np.random.default_rng(seed)
    return [_record(f"r{i}", int(rng.integers(1, 50)), r)
            for i, r in enumerate(rows)]


def record_index(db):
    """[n] int64: the index, in the list given to rows_records, of each
    amplicon of a Db read from its records (db_read sorts by
    abundance)."""
    return np.array([int(h[1:h.index(b"_")]) for h in db.headers],
                    dtype=np.int64)


def read_db(path: Path):
    """The FASTA file at `path` as a Db, through db_read."""
    from .db import db_read
    from .params import Parameters
    from .progress import Progress

    p = Parameters()
    p.input_filename = str(path)
    p.logfile = io.StringIO()
    return db_read(p, Progress(io.StringIO(), True))


def make_db(tmp_path: Path, records):
    """Write `records` to tmp_path/in.fasta and read them back as a Db."""
    path = Path(tmp_path) / "in.fasta"
    path.write_text("".join(records))
    return read_db(path)
