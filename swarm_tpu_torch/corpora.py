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
- ``read_db``, ``make_db``: a corpus as a Db, read back through db_read.
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


def _record(name, abundance, codes):
    return f">{name}_{abundance}\n" + "".join("ACGT"[c] for c in codes) + "\n"


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
