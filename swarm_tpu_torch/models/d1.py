"""d=1 engine (reference: src/algod1.cc).

Counterpart of swarm_tpu/models/d1.py: the exact 1-difference network
comes from ops/neighbors.py: NeighborIndex (the native C code below
its threshold, the torch sort-join engine on the device from it up,
started before the duplicate check: NATIVE_MAX amplicons in a process
that holds the card already, NATIVE_MAX_GRAFT in a fresh -f run, whose
graft takes the card anyway, NATIVE_MAX_COLD otherwise) and feeds a
host breadth-first
cluster growth that replicates the reference's ordering rules:
  - amplicons processed in abundance-sorted order;
  - per generation, new members attach in ascending amplicon order;
  - a member's parent is the lowest-index subseed that links it.

The fastidious pass reuses the same join machinery: a light amplicon l
grafts onto min{heavy h : dist(h, l) <= 2}, found by joining the
variant-hash sets of heavy and light amplicons (a midpoint sequence m
with dist(h,m)=dist(m,l)=1 exists iff dist(h,l) <= 2).
"""

import os
import resource
from typing import List

import numpy as np

from .. import metrics
from ..db import Db
from ..fatal import ERROR_PREFIX, fatal
from ..ops.neighbors import NeighborIndex, variant_hashes, _join
from ..ops.nw_scalar import nw
from ..params import Parameters
from ..progress import Progress

NO_SWARM = -1
ONE_MEGABYTE = 1 << 20

# duplicate-sequence check memo, keyed by arena object identity: the
# serving-model DB cache returns the same numpy arrays across runs, so
# the native scan runs once per resident corpus. The held reference
# pins the arena, keeping id() stable.
_DUP_MEMO = {}


def _find_duplicate_memo(db):
    from .. import _native

    key = (id(db.codes), id(db.offsets))
    hit = _DUP_MEMO.get(key)
    if hit is not None and hit[0] is db.codes:
        return hit[2]
    dup = _native.find_duplicate_seq(db.codes, db.offsets, db.lengths)
    _DUP_MEMO.clear()
    _DUP_MEMO[key] = (db.codes, db.offsets, dup)
    return dup


def _timing(what, index, prefix, steps) -> None:
    """The `[timing] WHAT (DEVICE)` lines of the run's spans of the
    one-device engine's steps (PREFIX.STEP), where that engine ran (its
    "keys" step is there): nothing for the native and sharded ones."""
    phases = metrics.step_seconds(prefix, steps)
    if "keys" in phases:
        device = index.device.type if index.device is not None else "cuda"
        metrics.timing(f"{what} ({device})", phases)


def _memtotal() -> int:
    try:
        return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return 0


def _memused() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _ref_memused_model(db, n: int, swarmcount: int, network_links: int) -> int:
    """Deterministic emulation of the reference's peak RSS at the
    fastidious ceiling check (arch_get_memused, src/arch.cc:41-75,
    consumed at src/algod1.cc:1359-1392).

    This process's own RSS includes the Python/PyTorch runtime — hundreds
    of MB before any clustering work — so comparing it against
    --ceiling rejects ceilings the reference accepts. The reference's
    envelope at the check is the sum of its d=1 allocations, all of
    which are deterministic functions of the input (allocation sites:
    src/db.cc:139-158 arena chunks, src/db.cc:677 seqinfo,
    src/zobrist.cc:49-108 tables, src/algod1.cc:1104-1156 ampinfo/
    swarminfo/global-hits/network, src/hashtable.cc:125-143,
    src/bloompat.cc:100-114), plus a small process base (binary + libc
    + startup, ~4 MB measured). ru_maxrss granularity and allocator
    noise make the true value fuzzy at the ~1 MB level even across
    reference runs, so only MB-scale behavior is reproducible — which
    is exactly what the --ceiling interface exposes. One more Linux
    subtlety: ru_maxrss survives execve, so a reference binary spawned
    from a large process inherits the launcher's high-water mark; this
    model reproduces the canonical shell-launched envelope (calibrated
    against bash-launched fatal thresholds: 51-52 MB at 200k amplicons,
    228-232 MB at 1M, both within 1 MB of the formula below)."""
    MB = ONE_MEGABYTE
    base = 5 * MB + MB // 2
    # datainfo arena: header + NUL + 2-bit seq rounded to whole u64s,
    # grown in 1 MiB chunks
    hdr_bytes = sum(len(h) + 1 for h in db.headers)
    seq_bytes = int((((db.lengths + 31) // 32) * 8).sum())
    arena = -(-(hdr_bytes + seq_bytes) // MB) * MB
    seqinfo = 64 * n  # sizeof(seqinfo_s) == 64
    hdr_hash = 16 * n  # db_read's header-dup table, 2n pointers (db.cc:657)
    longest = int(db.longest)
    # zobrist base table 4 u64 per position + byte-combined 256 per
    # 4-position group (sized for longest+1: insertions grow by one)
    zlen = longest + 1
    zobrist = 8 * 4 * zlen + 8 * 256 * ((zlen + 3) // 4)
    ampinfo = 28 * n  # sizeof(ampinfo_s) == 28
    sw_cap = 1024  # swarminfo_v starts at one kilobyte and doubles
    while sw_cap < max(swarmcount, 1):
        sw_cap *= 2
    swarminfo = 40 * sw_cap  # sizeof(swarminfo_s) == 40
    ht_size = 2  # smallest power of two >= 10(n+1)/7
    while ht_size * 7 < 10 * (n + 1):
        ht_size *= 2
    # occupied bitmap + u64 values + u32 data (hash_alloc)
    hashtable = ht_size // 8 + 8 * ht_size + 4 * ht_size
    bloom = max(ht_size, 8)  # bloom_init(hashtablesize) bytes
    # network_v: starts at 1 Mi elements, grows in 1 Mi-element steps
    net_cap = max(1, -(-network_links // (1 << 20))) * (1 << 20)
    network = 4 * net_cap
    return (base + arena + seqinfo + hdr_hash + zobrist + ampinfo
            + swarminfo + hashtable + bloom + network)


class D1State:
    def __init__(self, n: int):
        self.swarmid = np.full(n, NO_SWARM, dtype=np.int64)
        self.parent = np.full(n, NO_SWARM, dtype=np.int64)
        self.generation = np.zeros(n, dtype=np.int64)
        self.graft_cand = np.full(n, NO_SWARM, dtype=np.int64)
        self.network_links = 0
        # per swarm
        self.swarm_seed: List[int] = []
        self.swarm_members: List[List[int]] = []  # chain order
        self.swarm_mass: List[int] = []
        self.swarm_sumlen: List[int] = []
        self.swarm_size: List[int] = []
        self.swarm_singletons: List[int] = []
        self.swarm_maxgen: List[int] = []
        self.swarm_attached: List[bool] = []
        # flat CSR members (native BFS path; invalidated by grafting)
        self.flat_members = None
        self.flat_bounds = None


def _dump_network_python(p, db, progress, n, link_start, link_count,
                         edges_to, ua, aa):
    out = []
    n_processed = 0
    for amp in range(n):
        start = link_start[amp]
        cnt = link_count[amp]
        targets = np.sort(edges_to[start : start + cnt])
        amp_id = db.print_id(amp, ua, aa)
        for tgt in targets:
            out.append(f"{amp_id}\t{db.print_id(int(tgt), ua, aa)}\n")
            n_processed += 1
        progress.update(n_processed)
    p.network_file.write("".join(out))
    progress.done()


def algo_d1_run(p: Parameters, db: Db, progress: Progress, device) -> None:
    """`device`: the torch device of the sort-join engine (None: cuda:0)."""
    n = len(db)
    abundances = db.abundances.astype(np.uint64)

    # --- hashing phase: exact duplicate-sequence check ---
    from .. import _native

    # start the device join before the host-side hashing phase: the
    # device works while the host runs the duplicate check (a dup fatal
    # just abandons the speculative work: it produces no output)
    # -f's graft takes the card whatever n: the network's rule knows it
    # (NeighborIndex.graft_on_card)
    index = NeighborIndex(
        db, threads=p.opt_threads, device=device,
        graft_on_card=p.opt_fastidious and _graft_on_card(device))
    index.start_network()

    progress.init("Hashing sequences:", n)
    dup_msg = (
        "some fasta entries have identical sequences.\n"
        "Swarm expects dereplicated fasta files.\n"
        "Such files can be produced with swarm or vsearch:\n"
        " swarm -d 0 -w derep.fasta -o /dev/null input.fasta\n"
        "or\n"
        " vsearch --derep_fulllength input.fasta --sizein --sizeout "
        "--output derep.fasta\n"
    )
    if _native.available():
        dup = _find_duplicate_memo(db)
        from ..progress import replay_range

        if dup >= 0:
            # the reference updates progress for the duplicate's own
            # record before breaking (src/algod1.cc:1133-1139:
            # hash_insert(k); progress_update(k); if (dup) break)
            replay_range(progress, dup + 1)
            fatal(ERROR_PREFIX, dup_msg)
        replay_range(progress, n)
    else:
        codes_bytes = db.codes.tobytes()
        seen = {}
        for k in range(n):
            key = codes_bytes[db.offsets[k] : db.offsets[k] + db.lengths[k]]
            dup_found = key in seen
            seen[key] = k
            # reference order: insert, update, THEN break on duplicate
            # (src/algod1.cc:1133-1139)
            progress.update(k)
            if dup_found:
                fatal(ERROR_PREFIX, dup_msg)
        del seen
    progress.done()

    # --- network phase: batched variant hashing + join ---
    progress.init("Building network: ", n)
    edges_from, edges_to = index.build_network(
        p.opt_no_cluster_breaking, abundances, keep_rows=p.opt_fastidious
    )
    from ..ops.neighbors_sortjoin import SortJoinNeighborEngine

    _timing("d1 join", index, "d1_network",
            ("start",) + SortJoinNeighborEngine.STEPS)
    link_count = np.bincount(edges_from, minlength=n).astype(np.int64) if n else np.zeros(0, dtype=np.int64)
    link_start = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(link_count[:-1], out=link_start[1:])
    # the reference updates per amplicon scanned (src/algod1.cc:646);
    # replay the same milestone writes after the batched device pass
    from ..progress import replay_range

    replay_range(progress, n)
    progress.done()

    ua = p.opt_usearch_abundance
    aa = p.opt_append_abundance

    # --- network dump ---
    if p.opt_network_file and _native.available():
        progress.init("Dumping network:  ", int(len(edges_from)))
        blob = _native.write_network_d1(
            _native.HeaderArena(db), aa, ua, link_start, link_count, edges_to
        )
        if blob is not None:
            from ..cli import write_blob

            write_blob(p.network_file, blob)
            from ..progress import replay_values

            # the python loop updates with the running edge count after
            # each amplicon; replay the same milestone sequence
            cum = np.cumsum(link_count)
            replay_values(progress, cum)
            progress.done()
        else:
            _dump_network_python(
                p, db, progress, n, link_start, link_count, edges_to, ua, aa
            )
    elif p.opt_network_file:
        progress.init("Dumping network:  ", int(len(edges_from)))
        _dump_network_python(
            p, db, progress, n, link_start, link_count, edges_to, ua, aa
        )


    # --- clustering phase: generation-by-generation BFS ---
    st = D1State(n)
    st.network_links = int(len(edges_to))  # for the --ceiling envelope model
    lengths = db.lengths
    largest = 0
    maxgen_all = 0

    from .. import _native

    if _native.available() and n > 0:
        progress.init("Clustering:       ", n)
        (
            nswarms, swarmid, parent, generation, members, bound,
            seed_a, mass_a, sumlen_a, size_a, singles_a, maxgen_a,
        ) = _native.bfs_cluster(
            n, link_start, link_count, edges_to,
            db.abundances.astype(np.int64), lengths,
        )
        st.swarmid = swarmid
        st.parent = parent
        st.generation = generation
        st.swarm_seed = seed_a
        st.swarm_members = None  # built lazily from the flat CSR
        st.swarm_mass = mass_a
        st.swarm_sumlen = sumlen_a
        st.swarm_size = size_a
        st.swarm_singletons = singles_a
        st.swarm_maxgen = maxgen_a
        st.swarm_attached = np.zeros(nswarms, dtype=bool)
        st.flat_members = members
        st.flat_bounds = bound
        largest = int(size_a.max()) if nswarms else 0
        maxgen_all = int(maxgen_a.max()) if nswarms else 0
        from ..progress import replay_range

        replay_range(progress, n + 1)
        progress.done()
        return _d1_finish(p, db, progress, st, index, largest, maxgen_all)

    progress.init("Clustering:       ", n)
    for seed in range(n):
        if st.swarmid[seed] != NO_SWARM:
            progress.update(seed + 1)
            continue
        swarmid = len(st.swarm_seed)
        st.swarmid[seed] = swarmid
        st.generation[seed] = 0
        st.parent[seed] = NO_SWARM

        members = [seed]
        mass = int(abundances[seed])
        singletons = 1 if abundances[seed] == 1 else 0
        sumlen = int(lengths[seed])
        swarm_maxgen = 0

        frontier = [seed]
        generation = 0
        while frontier:
            generation += 1
            hits = []
            for subseed in frontier:
                start = link_start[subseed]
                cnt = link_count[subseed]
                for tgt in edges_to[start : start + cnt]:
                    tgt = int(tgt)
                    if st.swarmid[tgt] == NO_SWARM:
                        st.swarmid[tgt] = swarmid
                        st.generation[tgt] = generation
                        st.parent[tgt] = subseed
                        hits.append(tgt)
            hits.sort()
            members.extend(hits)
            for tgt in hits:
                mass += int(abundances[tgt])
                if abundances[tgt] == 1:
                    singletons += 1
                sumlen += int(lengths[tgt])
            if hits:
                swarm_maxgen = generation
            frontier = hits

        st.swarm_seed.append(seed)
        st.swarm_members.append(members)
        st.swarm_mass.append(mass)
        st.swarm_sumlen.append(sumlen)
        st.swarm_size.append(len(members))
        st.swarm_singletons.append(singletons)
        st.swarm_maxgen.append(swarm_maxgen)
        st.swarm_attached.append(False)
        largest = max(largest, len(members))
        maxgen_all = max(maxgen_all, swarm_maxgen)
        progress.update(seed + 1)
    progress.done()

    swarmcount = len(st.swarm_seed)
    swarmcount_adjusted = swarmcount

    return _d1_finish(p, db, progress, st, index, largest, maxgen_all)


def _ensure_members(st):
    """Materialize per-swarm member lists from the flat CSR (needed by
    the Python writers and the fastidious graft splicing)."""
    if st.swarm_members is None:
        m, b = st.flat_members, st.flat_bounds
        st.swarm_members = [m[b[i] : b[i + 1]] for i in range(len(b) - 1)]
    return st.swarm_members


def _d1_finish(p, db, progress, st, index, largest, maxgen_all):
    swarmcount = len(st.swarm_seed)
    swarmcount_adjusted = swarmcount

    # --- fastidious phase ---
    if p.opt_fastidious:
        largest, swarmcount_adjusted = _fastidious(
            p, db, progress, st, index, swarmcount, largest
        )

    _output_results(p, db, progress, st, swarmcount_adjusted)

    p.logfile.write("\n")
    p.logfile.write(f"Number of swarms:  {swarmcount_adjusted}\n")
    p.logfile.write(f"Largest swarm:     {largest}\n")
    p.logfile.write(f"Max generations:   {maxgen_all}\n")


def _variant_counts(db: Db, amps: np.ndarray, diff_cumsum=None) -> int:
    """Exact number of variants the reference generates: 6L + 4 + runs.

    One pass over the flat arena: runs per amplicon come from a cumsum
    of the adjacent-difference mask, so no [n, width] padded matrix is
    ever materialized (that cost ~6s of the fastidious log lines at
    1M amplicons). Pass diff_cumsum (from _diff_cumsum) to share the
    arena pass between the light and heavy calls."""
    if len(amps) == 0:
        return 0
    from .. import _native

    if _native.available() and diff_cumsum is None:
        return _native.variant_count_total(
            db.codes, db.offsets, db.lengths, amps
        )
    lens = db.lengths[amps]
    c = diff_cumsum if diff_cumsum is not None else _diff_cumsum(db)
    if c is not None:
        off = db.offsets[amps]
        last = np.maximum(off + lens - 1, off)
        runs = np.where(lens > 0, 1 + c[last] - c[off], 0)
    else:
        runs = (lens > 0).astype(np.int64)
    return int((6 * lens + 4 + runs).sum())


def _diff_cumsum(db: Db):
    """Cumulative adjacent-difference counts over the code arena
    (c[x] = diffs among the first x adjacent pairs), or None for a
    degenerate arena."""
    if len(db.codes) <= 1:
        return None
    # int32 while counts fit (int64 would be 1.2 GB at a 150 Mnt arena)
    dt = np.int32 if len(db.codes) < (1 << 31) else np.int64
    c = np.zeros(len(db.codes), dtype=dt)
    np.cumsum(db.codes[1:] != db.codes[:-1], out=c[1:])
    return c


def _graft_on_card(device) -> bool:
    """Whether -f's graft takes the device engine whatever its sides:
    on a CUDA device unless SWARM_TPU_GRAFT_PROBE_MAX is set (the H100
    beat the host join on every corpus measured, from 11 light reads up:
    scripts/graft_dispatch.py), and in a run that asks for shards
    (swarm_tpu_torch/parallel: the sharded device engine)."""
    from .. import parallel

    return parallel.requested() or (
        device.type == "cuda" and
        "SWARM_TPU_GRAFT_PROBE_MAX" not in os.environ)


def _device_graft(device, min_side_keys: int) -> bool:
    """Whether -f's graft runs on the device engine: as _graft_on_card
    says, else (on the CPU, or with the variable set) when the smaller
    side has more variant keys than that threshold (default 2<<20,
    JAX's); the host join serves below it."""
    from .. import _native

    return _graft_on_card(device) or \
        min_side_keys > _native.graft_probe_max_table_keys()


def _fastidious(p, db, progress, st, index, swarmcount, largest):
    log = p.logfile
    n = len(db)
    boundary = p.opt_boundary
    # the d=1 engine's rows on the device, for the graft and no longer
    rows, index.packed_rows = index.packed_rows, None

    log.write("\n")
    log.write("Results before fastidious processing:\n")
    log.write(f"Number of swarms:  {swarmcount}\n")
    log.write(f"Largest swarm:     {largest}\n")
    log.write("\n")

    progress.init("Counting amplicons in heavy and light swarms", swarmcount)
    small_clusters = 0
    amps_small = 0
    nt_small = 0
    light_swarm = np.zeros(swarmcount, dtype=bool)
    for i in range(swarmcount):
        if st.swarm_mass[i] < boundary:
            light_swarm[i] = True
            amps_small += st.swarm_size[i]
            nt_small += st.swarm_sumlen[i]
            small_clusters += 1
        progress.update(i + 1)
    progress.done()

    amps_large = n - amps_small
    large_clusters = swarmcount - small_clusters

    log.write(f"Heavy swarms: {large_clusters}, with {amps_large} amplicons\n")
    log.write(f"Light swarms: {small_clusters}, with {amps_small} amplicons\n")
    metrics.record(**{"fastidious.light_amplicons": amps_small,
                      "fastidious.heavy_amplicons": amps_large})
    log.write(f"Total length of amplicons in light swarms: {nt_small}\n")

    if small_clusters == 0 or large_clusters == 0:
        log.write(
            "Only light or heavy swarms found - no need for further analysis.\n"
        )
        return largest, swarmcount

    # Bloom filter geometry (log-compatibility only: this pipeline
    # uses an exact hash join, so the Bloom filter is never materialized;
    # reference: src/algod1.cc:1337-1405)
    bits = p.opt_bloom_bits
    n_hash_functions = max(int(0.4 * bits), 1)
    bloom_length_in_bits = nt_small * 7 * bits

    memtotal = _memtotal()
    # the reference compares ITS peak RSS to the ceiling; ours includes
    # the Python/PyTorch runtime, so emulate the reference's envelope
    memused = _ref_memused_model(
        db, n, swarmcount, getattr(st, "network_links", 0)
    )

    if p.opt_ceiling != 0:
        if p.opt_ceiling * ONE_MEGABYTE < memused:
            fatal(ERROR_PREFIX, "Memory ceiling for Bloom filter is too low.")
        memrest = p.opt_ceiling * ONE_MEGABYTE - memused
        new_bits = 8 * memrest // (7 * nt_small)
        if new_bits < bits:
            if new_bits < 2:
                fatal(ERROR_PREFIX, "Insufficient memory remaining for Bloom filter.")
            log.write("Reducing memory used for Bloom filter due to --ceiling option.\n")
            bits = new_bits
            n_hash_functions = max(int(0.4 * bits), 1)
            bloom_length_in_bits = nt_small * 7 * bits

    bloom_length_in_bits = max(bloom_length_in_bits, 64)

    if memused + bloom_length_in_bits // 8 > memtotal:
        log.write(
            "WARNING: Memory usage will probably exceed total amount of memory available.\n"
        )
        log.write(
            "Try to reduce memory footprint using the --bloom-bits or --ceiling options.\n"
        )

    size_mb = bloom_length_in_bits / (8 * ONE_MEGABYTE)
    log.write(
        f"Bloom filter: bits={bits}, m={bloom_length_in_bits}, "
        f"k={n_hash_functions}, size={size_mb:.1f}MB\n"
    )

    swarmid_arr = st.swarmid
    amp_is_light = light_swarm[swarmid_arr]
    light_amps = np.nonzero(amp_is_light)[0]
    heavy_amps = np.nonzero(~amp_is_light)[0]

    # mark phase (log-compatible progress + exact variant counts)
    from ..progress import replay_range

    progress.init("Adding light swarm amplicons to Bloom filter", amps_small)
    from .. import _native as _nat

    # the native counter walks the arena per side; the cumsum sharing
    # only pays off on the pure-Python path
    dc = None if _nat.available() else _diff_cumsum(db)
    light_variants = _variant_counts(db, light_amps, dc)
    # reference: progress_update(++light_progress), values 1..amps_small
    # (src/algod1.cc:543); +1 shifts replay_range's 0..total-1 window
    replay_range(progress, amps_small + 1)
    progress.done()
    log.write(f"Generated {light_variants} variants from light swarms\n")

    progress.init("Checking heavy swarm amplicons against Bloom filter", amps_large)
    heavy_variants = _variant_counts(db, heavy_amps, dc)
    del dc

    # graft candidates: join heavy variant hashes against light variant
    # hashes; exact verification by comparing reconstructed midpoints.
    lengths_i64 = db.lengths.astype(np.int64)
    min_side_keys = min(
        int((7 * lengths_i64[heavy_amps] + 4).sum()),
        int((7 * lengths_i64[light_amps] + 4).sum()),
    )
    with metrics.span("fastidious.graft"):
        graft_candidates, graft_cand = _graft_candidates(
            db, index, rows, heavy_amps, light_amps, min_side_keys)
    graft_cand = np.where(graft_cand < 0, NO_SWARM, graft_cand)
    from ..ops.fastidious_torch import GraftEngine

    _timing("graft", index, "fastidious", GraftEngine.STEPS)
    st.graft_cand = graft_cand
    # reference: progress_update(++heavy_progress), values 1..amps_large
    # (src/algod1.cc:480)
    replay_range(progress, amps_large + 1)
    progress.done()

    log.write(f"Heavy variants: {heavy_variants}\n")
    metrics.record(graft_join_comparisons=int(graft_candidates))
    log.write(f"Got {graft_candidates} graft candidates\n")

    # attach in (parent, child) order
    pairs = [
        (int(graft_cand[child]), child)
        for child in range(n)
        if graft_cand[child] != NO_SWARM
    ]
    pairs.sort()
    progress.init("Grafting light swarms on heavy swarms", len(pairs))
    grafts = 0
    counter = 0
    for parent, child in pairs:
        child_swarm = int(st.swarmid[child])
        if st.swarm_attached[child_swarm]:
            st.graft_cand[child] = NO_SWARM
        else:
            heavy = int(st.swarmid[parent])
            _ensure_members(st)
            merged = list(st.swarm_members[heavy])
            merged.extend(st.swarm_members[child_swarm])
            st.swarm_members[heavy] = merged
            st.swarm_size[heavy] += st.swarm_size[child_swarm]
            st.swarm_singletons[heavy] += st.swarm_singletons[child_swarm]
            st.swarm_mass[heavy] += st.swarm_mass[child_swarm]
            st.swarm_sumlen[heavy] += st.swarm_sumlen[child_swarm]
            st.swarm_attached[child_swarm] = True
            largest = max(largest, st.swarm_size[heavy])
            swarmcount -= 1
            grafts += 1
        counter += 1
        progress.update(counter)
    progress.done()

    metrics.record(**{"fastidious.grafts": grafts})
    log.write(f"Made {grafts} grafts\n")
    log.write("\n")
    return largest, swarmcount


def _graft_candidates(db, index, rows, heavy_amps, light_amps,
                      min_side_keys):
    """(count, graft_cand) of the engine that takes the graft: the
    device's (or its sharded form) as _device_graft says, else the
    native host join, else the python join below."""
    from .. import _native

    if _device_graft(index.device, min_side_keys):
        # the device engine (ops/fastidious_torch.py), or its sharded
        # form (parallel/mesh.py), on the d=1 engine's packed rows when
        # it ran; it raises on any failure
        from .. import parallel
        from ..ops.fastidious_torch import GraftEngine

        shards = parallel.shards_for(index.device)
        if shards is not None:
            from ..parallel.mesh import ShardedGraftEngine

            engine = ShardedGraftEngine(db, shards, rows)
        else:
            engine = GraftEngine(db, index.device, rows)
        return engine.graft_candidates(heavy_amps, light_amps)
    # host paths (asymmetric probe / radix sort-join, see
    # _native.graft_join); the python join serves when the native join
    # declines
    res = _native.graft_join(
        db.codes, db.offsets, db.lengths, len(db),
        np.asarray(heavy_amps, dtype=np.int64),
        np.asarray(light_amps, dtype=np.int64),
    )
    return res if res is not None else _graft_join(
        db, index, heavy_amps, light_amps)


def _graft_join(db, index, heavy_amps, light_amps):
    """For each light amplicon, the smallest heavy amplicon at dist <= 2.

    Returns (candidate_event_count, graft_cand array). The event count
    equals the reference's graft_candidates counter: the number of
    (heavy, midpoint, light) triples with dist(h,m)=1 and m==variant of l
    — i.e. verified variant-hash join matches.
    """
    n = len(db)
    graft_cand = np.full(n, NO_SWARM, dtype=np.int64)
    if len(heavy_amps) == 0 or len(light_amps) == 0:
        return 0, graft_cand

    padded = index.padded
    lengths = index.lengths
    zob = index.zob

    _, hashes, valid = variant_hashes(padded, lengths, index.zob)

    light_hashes = hashes[light_amps]
    light_valid = valid[light_amps]
    flat_light = light_hashes.reshape(-1)
    flat_light_valid = light_valid.reshape(-1)
    keep = np.nonzero(flat_light_valid)[0]
    light_vals = flat_light[keep]
    order = np.argsort(light_vals, kind="stable")
    sorted_light = light_vals[order]
    # map back: which light amp and slot each sorted entry belongs to
    n_slots = hashes.shape[1]
    light_flat_amp = light_amps[keep // n_slots][order]
    light_flat_slot = (keep % n_slots)[order]

    heavy_hashes = hashes[heavy_amps]
    heavy_valid = valid[heavy_amps]

    h_amp_rel, h_slot, tbl_pos = _join(
        heavy_hashes, heavy_valid, sorted_light, np.arange(len(sorted_light))
    )
    if len(h_amp_rel) == 0:
        return 0, graft_cand

    h_amp = heavy_amps[h_amp_rel]
    l_amp = light_flat_amp[tbl_pos]
    l_slot = light_flat_slot[tbl_pos]

    # verify: midpoint of heavy == midpoint of light (as sequences)
    ok = _verify_midpoints(padded, lengths, h_amp, h_slot, l_amp, l_slot)
    h_amp, l_amp = h_amp[ok], l_amp[ok]
    count = int(len(h_amp))

    if count:
        sort_order = np.lexsort((h_amp, l_amp))
        l_sorted = l_amp[sort_order]
        h_sorted = h_amp[sort_order]
        first = np.ones(len(l_sorted), dtype=bool)
        first[1:] = l_sorted[1:] != l_sorted[:-1]
        graft_cand[l_sorted[first]] = h_sorted[first]
    return count, graft_cand


def _verify_midpoints(padded, lengths, h_amp, h_slot, l_amp, l_slot):
    """Check variant(h_amp, h_slot) == variant(l_amp, l_slot) exactly."""
    if len(h_amp) == 0:
        return np.zeros(0, dtype=bool)
    n, max_len = padded.shape
    row_h, len_h = _materialize(padded, lengths, h_amp, h_slot, max_len)
    row_l, len_l = _materialize(padded, lengths, l_amp, l_slot, max_len)
    idx = np.arange(row_h.shape[1])[None, :]
    within = idx < len_h[:, None]
    return (len_h == len_l) & np.all((row_h == row_l) | ~within, axis=1)


def _materialize(padded, lengths, amp, slot, max_len):
    """Reconstruct variant rows (padded to max_len+1) and their lengths."""
    from ..ops.neighbors import decode_slot

    var_type, pos, base = decode_slot(slot, max_len, padded, amp)
    src_len = lengths[amp]
    out_len = src_len + np.where(var_type == 1, -1, np.where(var_type == 2, 1, 0))

    width = max_len + 1
    idx = np.arange(width)[None, :]
    pos_col = pos[:, None]
    src_idx = np.where(
        var_type[:, None] == 1,
        idx + (idx >= pos_col),
        np.where(var_type[:, None] == 2, idx - (idx > pos_col), idx),
    )
    src_idx = np.clip(src_idx, 0, max_len - 1)
    rows = np.take_along_axis(
        padded[amp], np.minimum(src_idx, max_len - 1), axis=1
    )
    place_base = (var_type != 1)[:, None] & (idx == pos_col)
    rows = np.where(place_base, base[:, None].astype(np.uint8), rows)
    mask = idx < out_len[:, None]
    rows = np.where(mask, rows, np.uint8(0))
    return rows, out_len


def _write_uclust_python(p, db, progress, st, ua, aa, swarmcount):
    """Python uclust writer (graft path and pathological-header fallback).
    Caller has already emitted progress.init."""
    _ensure_members(st)
    out = []
    cluster_no = 0
    counter = 0
    for i in range(swarmcount):
        if st.swarm_attached[i]:
            continue
        seed = st.swarm_seed[i]
        seed_id = db.print_id(seed, ua, aa)
        qseq = db.sequence_codes(seed)
        out.append(
            f"C\t{cluster_no}\t{st.swarm_size[i]}\t*\t*\t*\t*\t*\t{seed_id}\t*\n"
        )
        out.append(
            f"S\t{cluster_no}\t{db.lengths[seed]}\t*\t*\t*\t*\t*\t{seed_id}\t*\n"
        )
        for amp in st.swarm_members[i][1:]:
            dseq = db.sequence_codes(amp)
            nwdiff, alen, cigar = nw(
                dseq, qseq, p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend
            )
            percentid = 100.0 * (alen - nwdiff) / alen
            out.append(
                f"H\t{cluster_no}\t{db.lengths[amp]}\t{percentid:.1f}\t+\t0\t0\t"
                f"{cigar if nwdiff > 0 else '='}\t"
                f"{db.print_id(amp, ua, aa)}\t{seed_id}\n"
            )
        cluster_no += 1
        progress.update(counter)
        counter += 1
    p.uclustfile.write("".join(out))
    progress.done()


def _output_results(p, db, progress, st, swarmcount_adjusted):
    from .. import _native

    ua = p.opt_usearch_abundance
    aa = p.opt_append_abundance
    swarmcount = len(st.swarm_seed)

    arena = _native.HeaderArena(db) if _native.available() else None
    attached_u8 = np.asarray(st.swarm_attached, dtype=np.uint8)
    no_grafts = not attached_u8.any()

    if not no_grafts and arena is not None and st.swarm_members is not None:
        # the graft splice mutated the per-swarm member lists; rebuild
        # the flat CSR so the native writers cover the grafted path too
        memb = [np.asarray(m, dtype=np.int64) for m in st.swarm_members]
        st.flat_members = (
            np.concatenate(memb) if memb else np.zeros(0, dtype=np.int64)
        )
        st.flat_bounds = np.zeros(len(memb) + 1, dtype=np.int64)
        if memb:
            np.cumsum([len(m) for m in memb], out=st.flat_bounds[1:])

    # swarms
    if (
        arena is not None
        and not p.opt_mothur
        and st.flat_members is not None
    ):
        progress.init("Writing swarms:   ", swarmcount)
        from ..cli import write_blob

        write_blob(
            p.outfile,
            _native.write_swarms_plain(
                arena, aa, ua, st.flat_members, st.flat_bounds, attached_u8
            ),
        )
        from ..progress import replay_range, replay_values

        if no_grafts:
            replay_range(progress, swarmcount + 1)
        else:
            replay_values(progress, np.nonzero(attached_u8 == 0)[0] + 1)
        progress.done()
    elif p.opt_mothur:
        _ensure_members(st)
        progress.init("Writing swarms:   ", swarmcount)
        out = [f"swarm_{p.opt_differences}\t{swarmcount_adjusted}"]
        for i in range(swarmcount):
            if st.swarm_attached[i]:
                continue
            out.append("\t")
            out.append(
                ",".join(db.print_id(m, ua, aa) for m in st.swarm_members[i])
            )
            progress.update(i + 1)
        out.append("\n")
        p.outfile.write("".join(out))
        progress.done()
    else:
        _ensure_members(st)
        progress.init("Writing swarms:   ", swarmcount)
        out = []
        for i in range(swarmcount):
            if st.swarm_attached[i]:
                continue
            out.append(" ".join(db.print_id(m, ua, aa) for m in st.swarm_members[i]))
            out.append("\n")
            progress.update(i + 1)
        p.outfile.write("".join(out))
        progress.done()

    # seeds
    if p.opt_seeds and arena is not None:
        progress.init("Writing seeds:    ", swarmcount)
        blob, n_written = _native.write_seeds_d1(
            db, arena, ua, st.swarm_seed, st.swarm_mass, attached_u8
        )
        from ..cli import write_blob

        write_blob(p.seeds_file, blob)
        from ..progress import replay_range

        replay_range(progress, n_written + 1)
        progress.done()
    elif p.opt_seeds:
        progress.init("Writing seeds:    ", swarmcount)
        order = sorted(
            range(swarmcount),
            key=lambda i: (-st.swarm_mass[i], db.headers[st.swarm_seed[i]]),
        )
        out = []
        counter = 1
        for i in order:
            if st.swarm_attached[i]:
                continue
            seed = st.swarm_seed[i]
            out.append(">")
            out.append(db.print_id_with_new_abundance(seed, st.swarm_mass[i], ua))
            out.append("\n")
            out.append(db.sequence_string(seed))
            out.append("\n")
            progress.update(counter)
            counter += 1
        p.seeds_file.write("".join(out))
        progress.done()

    # internal structure
    if (
        p.opt_internal_structure
        and arena is not None
        and st.flat_members is not None
    ):
        progress.init("Writing structure:", swarmcount)
        from ..cli import write_blob

        write_blob(
            p.internal_structure_file,
            _native.write_structure_d1(
                arena, ua, st.flat_members, st.flat_bounds, attached_u8,
                st.graft_cand, st.parent, st.generation,
            ),
        )
        from ..progress import replay_values

        # milestone stream parity: update(i) per NON-attached swarm
        # slot, same as the Python writer below
        replay_values(progress, np.nonzero(attached_u8 == 0)[0])
        progress.done()
    elif p.opt_internal_structure:
        _ensure_members(st)
        progress.init("Writing structure:", swarmcount)
        out = []
        cluster_no = 0
        for i in range(swarmcount):
            if st.swarm_attached[i]:
                continue
            for amp in st.swarm_members[i][1:]:
                graft_parent = int(st.graft_cand[amp])
                if graft_parent != NO_SWARM:
                    out.append(
                        f"{db.print_id_noabundance(graft_parent, ua)}\t"
                        f"{db.print_id_noabundance(amp, ua)}\t2\t{cluster_no + 1}\t"
                        f"{st.generation[graft_parent] + 1}\n"
                    )
                parent = int(st.parent[amp])
                if parent != NO_SWARM:
                    out.append(
                        f"{db.print_id_noabundance(parent, ua)}\t"
                        f"{db.print_id_noabundance(amp, ua)}\t1\t{cluster_no + 1}\t"
                        f"{st.generation[amp]}\n"
                    )
            cluster_no += 1
            progress.update(i)
        p.internal_structure_file.write("".join(out))
        progress.done()

    # uclust
    if p.opt_uclust_file and arena is not None and st.flat_members is not None:
        progress.init("Writing UCLUST:   ", swarmcount)
        blob = _native.write_uclust_d1(
            db, arena, aa, ua, st.flat_members, st.flat_bounds, attached_u8,
            st.swarm_seed, st.swarm_size,
            p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend,
            nthreads=p.opt_threads,
        )
        if blob is not None:
            from ..cli import write_blob

            write_blob(p.uclustfile, blob)
            from ..progress import replay_range

            replay_range(progress, int(np.sum(attached_u8 == 0)))
            progress.done()
        else:
            _write_uclust_python(p, db, progress, st, ua, aa, swarmcount)
    elif p.opt_uclust_file:
        progress.init("Writing UCLUST:   ", swarmcount)
        _write_uclust_python(p, db, progress, st, ua, aa, swarmcount)

    # stats
    if p.opt_statistics_file:
        progress.init("Writing stats:    ", swarmcount)
        if arena is not None:
            from ..cli import write_blob

            write_blob(
                p.statsfile,
                _native.write_stats_d1(
                    arena, ua, st.swarm_seed, st.swarm_size, st.swarm_mass,
                    st.swarm_singletons, st.swarm_maxgen, attached_u8
                ),
            )
            from ..progress import replay_range

            # reference counter: 0..kept-1 regardless of where the
            # attached swarms sit (src/algod1.cc:1045-1061)
            replay_range(progress, int(np.sum(attached_u8 == 0)))
        else:
            out = []
            counter = 0
            for i in range(swarmcount):
                if st.swarm_attached[i]:
                    continue
                seed = st.swarm_seed[i]
                out.append(
                    f"{st.swarm_size[i]}\t{st.swarm_mass[i]}\t"
                    f"{db.print_id_noabundance(seed, ua)}\t{db.abundances[seed]}\t"
                    f"{st.swarm_singletons[i]}\t{st.swarm_maxgen[i]}\t{st.swarm_maxgen[i]}\n"
                )
                progress.update(counter)
                counter += 1
            p.statsfile.write("".join(out))
        progress.done()
