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
