"""d>=2 engines (reference: src/algo.cc).

Counterpart of swarm_tpu/models/general.py. Four engines, chosen by
SWARM_TPU_D2_ENGINE (default "auto"):

- "network": the torch D2NetworkEngine (qgram screen, exact diffs)
  feeding the native graph replay (swarm_native.c: algo_cluster_graph);
- "native": the all-host C seed/subseed loop (swarm_native.c:
  algo_cluster);
- "device": the Python seed/subseed loop below with DeviceAligner
  (ops/search_torch.py) on the run's torch device: seeds whose
  screened target list reaches DeviceAligner.MIN_DEVICE_BATCH get
  their alignment scores from the CUDA score kernels, and only pairs
  whose score is within the cutoff are rescored exactly on the host;
- "python": the same loop with host exact diffs only (the oracle).

The loop is sequential seed/subseed growth over an order-maintained
amplicon list, with two batched screens per subseed:
  1. qgram parity-profile lower bounds over the remaining pool;
  2. exact cost-space alignment diffs (search-kernel semantics) for
     survivors.
Both are pure functions of (subseed, target) so they batch freely; the
host replays the reference's array-rotation bookkeeping, which defines
member output order.
"""

import os
import time

import numpy as np
import torch

from .. import _native, metrics
from ..db import Db
from ..ops.neighbors import pad_codes
from ..ops.nw_scalar import nw
from ..ops.qgram import qgram_profiles
from ..ops.search import search_diffs_ref, set_bit_mode
from ..params import Parameters
from ..progress import Progress, replay_range, replay_values

ENGINES = ("auto", "network", "native", "device", "python")
#: the network engine serves n from these up in the 8-bit regime on a
#: CUDA device, the native engine below: NETWORK_MIN when the process
#: already holds the card (device.card_ready), else NETWORK_MIN_COLD.
#: scripts/dispatch_sweep.py on an NVIDIA H100 80GB HBM3 at 700 W
#: (PERF.md §5), `swarm -d D -o -s` at D = 2, 3, 4, 6 on
#: gen_corpus(length=150) and gen_corpus(length=400): with the card
#: held, the network engine won from 1,024 (the sweep's smallest) at
#: d = 2 and 3 and from 4,096 at every d (below, at d = 4 and 6, the
#: native diffs of its 8,000-16,000 pairs hold it back); in a fresh
#: process, whose first use of the card adds 0.1-1.1 s, the host won
#: up to 8,192 and the card from 16,384 at d = 2 and 6 (medians of
#: three fresh processes in turns, and two single-sample series; one
#: single sample of the 400 nt corpus at d = 2 had the host ahead at
#: 16,384)
NETWORK_MIN = 4_096
NETWORK_MIN_COLD = 16_384
#: the run's spans (metrics.py) of the -i, -u, -s, -o and -w writers
WRITER_SPANS = ("general.write_structure", "general.write_uclust",
                "general.write_stats", "general.write_swarms",
                "general.write_seeds")


def choose_engine(n: int, bit_mode: int, device: torch.device) -> str:
    """The engine for n amplicons: "network" in the 8-bit regime on a
    CUDA device from NETWORK_MIN amplicons (NETWORK_MIN_COLD in a
    process that does not hold the card yet), else "native"; "device"
    and "python" only when asked for."""
    engine = os.environ.get("SWARM_TPU_D2_ENGINE", "auto")
    if engine not in ENGINES:
        raise ValueError(
            f"SWARM_TPU_D2_ENGINE={engine!r}: swarm_tpu_torch runs "
            f"{', '.join(ENGINES)}")
    if engine == "auto":
        from ..device import card_ready

        at = NETWORK_MIN if card_ready() else NETWORK_MIN_COLD
        engine = "network" if (
            bit_mode == 8 and n >= at and device.type == "cuda"
        ) else "native"
    if engine == "network" and bit_mode != 8:
        # the network formulation needs the pure-pair 8-bit semantics
        # (the 16-bit artifact's diffs depend on the channel schedule,
        # src/search16.cc)
        engine = "native"
    return engine


def algo_run(p: Parameters, db: Db, progress: Progress,
             device: torch.device) -> None:
    n = len(db)
    d = p.opt_differences
    bit_mode = set_bit_mode(
        d, p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend)
    engine = choose_engine(n, bit_mode, device)

    progress.init("Find qgram vects: ", n)
    if engine == "network":
        from .. import parallel
        from ..ops.d2_network import D2NetworkEngine

        eng = D2NetworkEngine(db, d, device, threads=p.opt_threads,
                              shards=parallel.shards_for(device))
    elif engine == "native":
        # offset-based arena throughout: no [n, round_up(longest)]
        # matrix, so one multi-Mnt sequence costs only its own bytes
        profiles = _native.qgram_profiles_arena(
            db.codes, db.offsets, db.lengths
        )
    else:
        padded = pad_codes(
            db.codes, db.offsets, db.lengths, max(int(db.longest), 1))
        profiles = qgram_profiles(padded, db.lengths)
    # reference updates per sequence (src/db.cc:838); replay the same
    # milestone writes after the batched pass
    replay_range(progress, n)
    progress.done()

    if engine == "network":
        _algo_run_network(p, db, progress, eng, n, d)
    elif engine == "native":
        _algo_run_native(p, db, progress, None, profiles, bit_mode, n, d)
    else:
        device_aligner = None
        if engine == "device":
            from ..ops.search_torch import DeviceAligner

            device_aligner = DeviceAligner(padded, db.lengths, device)
        _algo_run_python(
            p, db, progress, padded, profiles, bit_mode, device_aligner)


def _algo_run_python(p, db, progress, padded, profiles, bit_mode,
                     device_aligner):
    """The Python seed/subseed loop. `device_aligner` (or None) screens
    a seed's target list on the device: pairs whose alignment cost
    already proves diff > d are rejected there, and the few survivors
    go through the exact host kernel (see ops/search_torch.py for the
    soundness argument)."""
    n = len(db)
    ua = p.opt_usearch_abundance
    aa = p.opt_append_abundance
    d = p.opt_differences
    abundances = db.abundances
    lengths = db.lengths
    cutoff = d * max(p.penalty_mismatch, p.penalty_gapopen + p.penalty_gapextend)
    t_run = time.perf_counter()
    #: host seconds in the device screen (launch, wait, copy back) and in
    #: the exact host rescoring; lists the aligner took / left on the host
    spent = {"device_scores": 0.0, "exact_diffs": 0.0}
    batches = {"device": 0, "host": 0}

    def _exact_diffs(seed_id: int, target_ids: np.ndarray, compute=None):
        """Diffs for the FULL ordered search_do target list.

        The reference binary's kernel boundary artifact makes each
        target's diffs depend on where the channel scheduler placed its
        blocks within the whole list (ops/search.py:search_diffs_ref),
        so even screened-out targets must stay in the list; `compute`
        only skips their DP."""
        t0 = time.perf_counter()
        qseq = padded[seed_id, : lengths[seed_id]]
        rows = padded[target_ids]
        lens = lengths[target_ids]
        batch_max = int(lens.max())
        _, diffs, _ = search_diffs_ref(
            qseq,
            rows[:, :batch_max],
            lens,
            p.penalty_mismatch,
            p.penalty_gapopen,
            p.penalty_gapextend,
            bit_mode,
            compute,
        )
        spent["exact_diffs"] += time.perf_counter() - t0
        return diffs

    def aligner(seed_id: int, target_ids: np.ndarray):
        if (
            device_aligner is None
            or len(target_ids) < device_aligner.MIN_DEVICE_BATCH
        ):
            batches["host"] += 1
            return _exact_diffs(seed_id, target_ids)
        batches["device"] += 1
        t0 = time.perf_counter()
        scr = device_aligner.scores(
            seed_id, target_ids,
            p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend,
            cutoff=cutoff,
        )
        spent["device_scores"] += time.perf_counter() - t0
        # sound prune vs the artifact kernel: an accepted pair's walked
        # path is a valid alignment with <= d diffs, whose true cost
        # bounds the ideal score by d*max(mm, go+ge)
        return _exact_diffs(seed_id, target_ids, compute=scr <= cutoff)

    # ordering state as parallel arrays (the reference's in-place
    # partitioned amplicon array, src/algo.cc:329-708); pool scans are
    # vectorized instead of per-element loops
    order = np.arange(n, dtype=np.int64)       # ampliconid per position
    diffest = np.zeros(n, dtype=np.int64)
    swarmid_arr = np.zeros(n, dtype=np.int64)
    gen_arr = np.zeros(n, dtype=np.int64)
    rad_arr = np.zeros(n, dtype=np.int64)
    _state = (order, diffest, swarmid_arr, gen_arr, rad_arr)
    ab_i64 = np.ascontiguousarray(abundances, dtype=np.int64)

    def rotate(target: int, pos: int) -> None:
        """Move position target to pos (pos <= target), shifting
        [pos, target) right — the reference's memmove rotation."""
        if target == pos:
            return
        for arr in _state:
            tmp = arr[target]
            seg = arr[pos:target].copy()
            arr[pos + 1 : target + 1] = seg
            arr[pos] = tmp

    structure_out = []
    uclust_out = []
    stats_out = []

    largestswarm = 0
    maxgenerations = 0
    swarmid = 0
    seeded = 0
    swarmed = 0

    progress.init("Clustering:       ", n)
    while seeded < n:
        swarmid += 1

        swarmsize = 1
        amplicons_copies = 0
        singletons = 0
        hits = []
        maxradius = 0
        maxgen = 1

        seedindex = seeded
        seeded += 1
        swarmid_arr[seedindex] = swarmid
        seedampliconid = int(order[seedindex])
        hits.append(seedampliconid)

        abundance = int(abundances[seedampliconid])
        amplicons_copies += abundance
        if abundance == 1:
            singletons += 1
        swarmed += 1

        # gen-1 candidates: whole remaining pool (abundance rule; the
        # pool region stays abundance-sorted, so the rule never filters
        # here — kept for exactness with -n semantics)
        t_pos, t_ids, _ = _native.d2_gen1_screen(
            profiles, order, ab_i64, diffest, swarmed,
            seedampliconid, abundance, p.opt_no_cluster_breaking, d,
        )
        targetindices = t_pos.tolist()
        targetampliconids = t_ids

        if targetindices:
            diffs = aligner(seedampliconid, targetampliconids)

            for t_id in range(len(targetampliconids)):
                diff = int(diffs[t_id])
                if diff > d:
                    continue
                target = targetindices[t_id]
                # rotate target to the first unswarmed position
                if target > swarmed:
                    rotate(target, swarmed)
                swarmid_arr[swarmed] = swarmid
                gen_arr[swarmed] = 1
                rad_arr[swarmed] = diff
                maxradius = max(maxradius, diff)
                poolampliconid = int(order[swarmed])
                hits.append(poolampliconid)

                if p.opt_internal_structure:
                    structure_out.append(
                        f"{db.print_id_noabundance(seedampliconid, ua)}\t"
                        f"{db.print_id_noabundance(poolampliconid, ua)}\t"
                        f"{diff}\t{swarmid}\t1\n"
                    )

                abundance = int(abundances[poolampliconid])
                amplicons_copies += abundance
                if abundance == 1:
                    singletons += 1
                swarmsize += 1
                swarmed += 1

            while seeded < swarmed:
                subseed_pos = seeded
                subseed_amp = int(order[subseed_pos])
                subseed_radius = int(rad_arr[subseed_pos])
                subseed_generation = int(gen_arr[subseed_pos])
                seeded += 1

                subseedabundance = int(abundances[subseed_amp])
                t_pos, t_ids = _native.d2_subseed_screen(
                    profiles, order, ab_i64, diffest, swarmed,
                    subseed_amp, subseed_radius + d, subseedabundance,
                    p.opt_no_cluster_breaking, d,
                )
                targetindices = t_pos.tolist()
                targetampliconids = t_ids

                if not len(targetindices):
                    continue

                diffs = aligner(subseed_amp, targetampliconids)

                for t_id in range(len(targetampliconids)):
                    diff = int(diffs[t_id])
                    if diff > d:
                        continue
                    target = targetindices[t_id]

                    # find correct position: keep the newest generation
                    # ordered by amplicon id (src/algo.cc:205-219)
                    pos = swarmed
                    targetampliconid = int(order[target])
                    while (
                        pos > seeded
                        and order[pos - 1] > targetampliconid
                        and gen_arr[pos - 1] > subseed_generation
                    ):
                        pos -= 1

                    if target > pos:
                        rotate(target, pos)
                    swarmid_arr[pos] = swarmid
                    gen_arr[pos] = subseed_generation + 1
                    maxgen = max(maxgen, subseed_generation + 1)
                    rad_arr[pos] = subseed_radius + diff
                    maxradius = max(maxradius, subseed_radius + diff)

                    poolampliconid = int(order[pos])
                    hits.append(poolampliconid)

                    if p.opt_internal_structure:
                        structure_out.append(
                            f"{db.print_id_noabundance(subseed_amp, ua)}\t"
                            f"{db.print_id_noabundance(poolampliconid, ua)}\t"
                            f"{diff}\t{swarmid}\t{subseed_generation + 1}\n"
                        )

                    abundance = int(abundances[poolampliconid])
                    amplicons_copies += abundance
                    if abundance == 1:
                        singletons += 1
                    swarmsize += 1
                    swarmed += 1

        largestswarm = max(largestswarm, swarmsize)
        maxgenerations = max(maxgenerations, maxgen)

        if p.uclustfile is not None:
            seed_id_str = db.print_id(seedampliconid, ua, aa)
            uclust_out.append(
                f"C\t{swarmid - 1}\t{swarmsize}\t*\t*\t*\t*\t*\t{seed_id_str}\t*\n"
            )
            uclust_out.append(
                f"S\t{swarmid - 1}\t{lengths[seedampliconid]}\t*\t*\t*\t*\t*\t"
                f"{seed_id_str}\t*\n"
            )
            qseq = db.sequence_codes(seedampliconid)
            for hit in hits[1:]:
                dseq = db.sequence_codes(hit)
                nwdiff, alen, cigar = nw(
                    dseq, qseq, p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend
                )
                percentid = 100.0 * (alen - nwdiff) / alen
                uclust_out.append(
                    f"H\t{swarmid - 1}\t{lengths[hit]}\t{percentid:.1f}\t+\t0\t0\t"
                    f"{cigar if nwdiff > 0 else '='}\t"
                    f"{db.print_id(hit, ua, aa)}\t{seed_id_str}\n"
                )

        if p.statsfile is not None:
            abundance = int(abundances[seedampliconid])
            stats_out.append(
                f"{swarmsize}\t{amplicons_copies}\t"
                f"{db.print_id_noabundance(seedampliconid, ua)}\t"
                f"{abundance}\t{singletons}\t{maxgen}\t{maxradius}\n"
            )
        progress.update(seeded)
    progress.done()

    if p.opt_internal_structure:
        p.internal_structure_file.write("".join(structure_out))
    if p.uclustfile is not None:
        p.uclustfile.write("".join(uclust_out))
    if p.statsfile is not None:
        p.statsfile.write("".join(stats_out))

    # swarms output
    if n != 0:
        out = []
        if p.opt_mothur:
            out.append(f"swarm_{p.opt_differences}\t{swarmid}\t")
            previous_id = swarmid_arr[0]
            out.append(db.print_id(int(order[0]), ua, aa))
            for i in range(1, n):
                current_id = swarmid_arr[i]
                out.append("," if current_id == previous_id else "\t")
                out.append(db.print_id(int(order[i]), ua, aa))
                previous_id = current_id
            out.append("\n")
        else:
            previous_id = swarmid_arr[0]
            out.append(db.print_id(int(order[0]), ua, aa))
            for i in range(1, n):
                current_id = swarmid_arr[i]
                out.append(" " if current_id == previous_id else "\n")
                out.append(db.print_id(int(order[i]), ua, aa))
                previous_id = current_id
            out.append("\n")
        p.outfile.write("".join(out))

    # seeds
    if p.opt_seeds and n != 0:
        _write_seeds(p, db, progress, order, swarmid_arr, n)

    p.logfile.write("\n")
    p.logfile.write(f"Number of swarms:  {swarmid}\n")
    p.logfile.write(f"Largest swarm:     {largestswarm}\n")
    p.logfile.write(f"Max generations:   {maxgenerations}\n")

    metrics.record(
        d2_device_batches=batches["device"], d2_host_batches=batches["host"])
    total = time.perf_counter() - t_run
    metrics.timing(
        "d2 seed loop (%s)" % (
            device_aligner.device.type if device_aligner else "host"),
        {**spent, "python loop + writers": total - sum(spent.values())})


def _algo_run_network(p, db, progress, eng, n, d):
    """Network-engine path: bulk device qgram screen + exact diffs
    produce the directed edge list; the graph-driven C replay
    (swarm_native.c: algo_cluster_graph) reproduces algo_cluster's
    attachment order exactly; output writers are shared. With
    SWARM_TPU_TIMING set, prints the seconds of the run's spans of the
    engine's steps, the replay and the writers."""
    want_structure = bool(p.opt_internal_structure or p.uclustfile is not None)
    adj_start, adj_count, adj_to, adj_diff, n_screened, n_survivors = (
        eng.build_adjacency(
            p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend,
            p.opt_no_cluster_breaking,
        )
    )
    with metrics.span("general.cluster_graph"):
        res = _native.algo_cluster_graph(
            adj_start, adj_count, adj_to, adj_diff, db.abundances,
            want_structure,
        )
    metrics.record(
        qgram_screen_comparisons=n * (n - 1) // 2,
        alignment_comparisons=n_survivors,
    )
    _write_d2_results(p, db, progress, res, n)
    spent = {step: metrics.seconds(f"d2_network.{step}")
             for step in ("screen", "to_host", "diffs", "csr")}
    spent["cluster_graph"] = metrics.seconds("general.cluster_graph")
    spent["writers"] = metrics.seconds(*WRITER_SPANS)
    metrics.timing(f"d2 network ({eng.device.type})", spent)


def _algo_run_native(p, db, progress, padded, profiles, bit_mode, n, d):
    """Native-engine path: the whole seed/subseed loop runs in C
    (swarm_native.c: algo_cluster); Python replays progress and formats
    the outputs from the returned arrays."""
    lengths = np.ascontiguousarray(db.lengths, dtype=np.int64)
    want_structure = bool(p.opt_internal_structure or p.uclustfile is not None)

    res = _native.algo_cluster(
        profiles, db.codes, db.offsets, lengths, db.abundances, d,
        p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend,
        bit_mode, p.opt_no_cluster_breaking, want_structure,
    )

    metrics.record(
        qgram_screen_comparisons=res["comparisons"]["gen1_screen"]
        + res["comparisons"]["subseed_scan"],
        alignment_comparisons=res["comparisons"]["alignments"],
    )
    _write_d2_results(p, db, progress, res, n)


def _write_d2_results(p, db, progress, res, n):
    """Format every d>=2 output stream from the engine result arrays
    (reference writers: src/algo.cc:608-694 and the inline uclust/stats
    streaming)."""
    ua = p.opt_usearch_abundance
    aa = p.opt_append_abundance
    lengths = np.ascontiguousarray(db.lengths, dtype=np.int64)

    progress.init("Clustering:       ", n)
    replay_values(progress, res["swarm_bound"])
    progress.done()

    order = res["order"]
    swarmid_arr = res["swarmid"]
    swarmcount = res["swarmcount"]

    if p.opt_internal_structure:
        with metrics.span("general.write_structure"):
            out = []
            sid = 0
            bounds = res["swarm_bound"]
            child_cum = np.cumsum(res["swarm_size"] - 1)
            for k in range(len(res["struct_parent"])):
                while sid < swarmcount and k >= child_cum[sid]:
                    sid += 1
                out.append(
                    f"{db.print_id_noabundance(int(res['struct_parent'][k]), ua)}\t"
                    f"{db.print_id_noabundance(int(res['struct_child'][k]), ua)}\t"
                    f"{int(res['struct_diff'][k])}\t{sid + 1}\t"
                    f"{int(res['struct_gen'][k])}\n"
                )
            p.internal_structure_file.write("".join(out))

    if p.uclustfile is not None:
        with metrics.span("general.write_uclust"):
            out = []
            child_off = 0
            for s in range(swarmcount):
                seed_amp = int(res["swarm_seed"][s])
                size = int(res["swarm_size"][s])
                seed_id_str = db.print_id(seed_amp, ua, aa)
                out.append(f"C\t{s}\t{size}\t*\t*\t*\t*\t*\t{seed_id_str}\t*\n")
                out.append(
                    f"S\t{s}\t{lengths[seed_amp]}\t*\t*\t*\t*\t*\t"
                    f"{seed_id_str}\t*\n"
                )
                qseq = db.sequence_codes(seed_amp)
                for k in range(child_off, child_off + size - 1):
                    hit = int(res["struct_child"][k])
                    dseq = db.sequence_codes(hit)
                    nwdiff, alen, cigar = nw(
                        dseq, qseq, p.penalty_mismatch, p.penalty_gapopen,
                        p.penalty_gapextend,
                    )
                    percentid = 100.0 * (alen - nwdiff) / alen
                    out.append(
                        f"H\t{s}\t{lengths[hit]}\t{percentid:.1f}\t+\t0\t0\t"
                        f"{cigar if nwdiff > 0 else '='}\t"
                        f"{db.print_id(hit, ua, aa)}\t{seed_id_str}\n"
                    )
                child_off += size - 1
            p.uclustfile.write("".join(out))

    if p.statsfile is not None:
        with metrics.span("general.write_stats"):
            out = []
            for s in range(swarmcount):
                seed_amp = int(res["swarm_seed"][s])
                out.append(
                    f"{int(res['swarm_size'][s])}\t{int(res['swarm_copies'][s])}\t"
                    f"{db.print_id_noabundance(seed_amp, ua)}\t"
                    f"{int(db.abundances[seed_amp])}\t"
                    f"{int(res['swarm_singletons'][s])}\t"
                    f"{int(res['swarm_maxgen'][s])}\t{int(res['swarm_maxrad'][s])}\n"
                )
            p.statsfile.write("".join(out))

    # swarms output
    if n != 0:
        with metrics.span("general.write_swarms"):
            if p.opt_mothur:
                out = [f"swarm_{p.opt_differences}\t{swarmcount}\t"]
                previous_id = swarmid_arr[0]
                out.append(db.print_id(int(order[0]), ua, aa))
                for i in range(1, n):
                    current_id = swarmid_arr[i]
                    out.append("," if current_id == previous_id else "\t")
                    out.append(db.print_id(int(order[i]), ua, aa))
                    previous_id = current_id
                out.append("\n")
                p.outfile.write("".join(out))
            else:
                bounds = np.concatenate(
                    ([0], np.asarray(res["swarm_bound"], dtype=np.int64))
                )
                attached = np.zeros(swarmcount, dtype=np.uint8)
                data = _native.write_swarms_plain(
                    _native.HeaderArena(db), aa, ua, order, bounds, attached
                )
                from ..cli import write_blob

                write_blob(p.outfile, data)

    if p.opt_seeds and n != 0:
        _write_seeds(p, db, progress, order, swarmid_arr, n)

    p.logfile.write("\n")
    p.logfile.write(f"Number of swarms:  {swarmcount}\n")
    p.logfile.write(f"Largest swarm:     {res['largest']}\n")
    p.logfile.write(f"Max generations:   {res['maxgen']}\n")


def _sort_seeds_stdcxx(db, seeds):
    """Sort [(seed, mass), ...] exactly as the reference's std::sort
    does (src/algo.cc:161-183): mass descending, strcmp == -1 ties,
    introsort-defined order for incomparable pairs."""
    mass = np.array([m for _, m in seeds], dtype=np.int64)
    seed = np.array([s for s, _ in seeds], dtype=np.int64)
    if _native.sort_seeds_stdcxx(mass, seed, _native.HeaderArena(db)):
        return list(zip(seed.tolist(), mass.tolist()))

    from ..stdcxx_sort import stdcxx_sort

    headers = db.headers

    def strcmp_glibc(a: bytes, b: bytes) -> int:
        """glibc strcmp: difference of the first differing unsigned bytes."""
        for x, y in zip(a, b):
            if x != y:
                return x - y
        return len(a) - len(b)

    def lt(lhs, rhs) -> bool:
        if lhs[1] != rhs[1]:
            return lhs[1] > rhs[1]
        return strcmp_glibc(headers[lhs[0]], headers[rhs[0]]) == -1

    seeds = list(seeds)
    stdcxx_sort(seeds, lt)
    return seeds


def _write_seeds(p, db, progress, order, swarmid_arr, n):
    """Collect per-swarm seeds+mass, sort, write (src/algo.cc:123-202).

    The reference's tie comparator tests `strcmp(...) == -1`, which with
    glibc is only true when the first differing bytes differ by exactly
    -1; other equal-mass pairs compare "equal" in BOTH directions, so
    the comparator is not a strict weak order and the output order of
    such ties is defined by std::sort's algorithm itself. We replicate
    libstdc++'s introsort exactly (C fast path sort_seeds_stdcxx;
    Python mirror in stdcxx_sort.py)."""
    with metrics.span("general.write_seeds"):
        ua = p.opt_usearch_abundance

        progress.init("Collecting seeds:    ", n)
        seeds = []
        mass = 0
        previous_id = swarmid_arr[0]
        seed = int(order[0])
        mass += int(db.abundances[seed])
        for i in range(1, n):
            current_id = swarmid_arr[i]
            if current_id != previous_id:
                seeds.append((seed, mass))
                mass = 0
                seed = int(order[i])
            mass += int(db.abundances[int(order[i])])
            previous_id = current_id
            progress.update(i)
        seeds.append((seed, mass))
        # the reference's collect_seeds never calls progress_done
        # (src/algo.cc:123-158): no "100%" line in -l mode, no newline on
        # stderr — the next phase's init overwrites the line in place

        progress.init("Sorting seeds:    ", len(seeds))
        seeds = _sort_seeds_stdcxx(db, seeds)
        progress.done()

        progress.init("Writing seeds:    ", len(seeds))
        out = []
        for ticker, (seed, swarm_mass) in enumerate(seeds):
            out.append(">")
            out.append(db.print_id_with_new_abundance(seed, swarm_mass, ua))
            out.append("\n")
            out.append(db.sequence_string(seed))
            out.append("\n")
            progress.update(ticker)
        p.seeds_file.write("".join(out))
        progress.done()
