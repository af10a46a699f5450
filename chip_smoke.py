#!/usr/bin/env python3
"""Bring-up check of swarm_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py          (from the root of a checkout)

Phases, each printing its own lines; any failure exits 1 before the
final line:

1. the card (nvidia-smi name and power limit), then the native host
   library and the CUDA kernels built from the checkout's sources, and
   the card's rate of int32 adds and mins (csrc/probe.cu);
2. kernel d2_diffs against its plain PyTorch version on the card,
   exactly (integer DP), on tie-heavy chain corpora, on a ragged-length
   corpus for every register variant B = 1..20 and two cases of the
   general variant, and on 2^20 tasks made of the d2_100k corpus'
   candidate pairs; the last timed;
3. kernels banded_scores and full_scores (one seed of the dense-cloud
   corpus against 4,096 targets of ~400 nt) against their plain
   versions on the card, exactly, for bands B = 4, 20, 63 and three
   penalty sets; the banded scores also against the full-row kernel
   under the screen's contract (equal where <= cutoff, both above it
   elsewhere); both timed, banded_scores at three shapes (the list, a
   list of one in-band target, the list repeated 64 times) queued
   behind a busy kernel so that the host's enqueue time is not in the
   reading, beside an empty kernel's launch time; full_scores also on
   seeds and targets whose lengths sit on the edges of its schedule (1,
   31, 32, 33, around 32 * C for every strip width C, two passes, an
   empty row, a one-element list), banded_scores on every band B =
   1..20, 21, 40, 63 over ragged lengths and on lengths at the edges of
   the band;
4. the d=1 kernels d1_keygen (its count and pack pass, which packs the
   code arena into ragged rows, and its emit pass), d1_partition,
   d1_join and d1_verify against their plain versions on the card,
   exactly (packed words, keys, the partitioned keys and owners and
   bucket ends, and flags element for element; candidate pairs in the
   kernel's order, and as a sorted multiset against the pairs of the
   sorted keys), on rows at the edges of the kernels, on one run of 125
   rows sharing a key, on a run of 4,504 (a bucket beyond the join's
   shared-memory tile: its oversized variant), on rows of mixed lengths
   at the edges of the ragged layout (1 to 5,003 nt), and on the d1_1m
   and d1_mixed_1m corpora, which are also timed: each kernel's passes
   (d1_verify alone behind a busy kernel and as its wrapper's call
   reads), the pack with its bound, torch.sort + torch.take of the keys
   (the parent's grouping step, d1_partition's library call) with both peaks
   of device memory, the plain versions, and the arena's copy to the
   card from pageable and from pinned memory;
5. the graft kernels graft_keygen (count and emit), graft_join and
   graft_verify against their plain versions on the card, exactly (keys
   and payloads; the join's counts and records a chunk, its pairs in the
   kernel's order, both sides unwritten; flags and each light row's
   smallest heavy one, on the join's pairs and on 4,096 pairs of random
   keys), with the sides partitioned by d1_partition, and the engine
   against the native host join: on ragged edge rows (1 to 5,003 nt),
   rows two edits from a base row with the edits on the verify's word
   edges (graft_edge_rows: positions 15, 16, 31, 32 and the last,
   appended bases, deletions inside runs, rows of 1 to 5,006 nt), a run
   of 4,204 rows sharing a variant (a light bucket beyond the join's
   1,024-element table, so tiled), an empty side (graft_verify timed
   alone on each side with pairs), and the sides that a `-d 1 -f` run of each
   fastidious corpus hands the engine, which are also timed (each
   kernel's passes, keygen's emit a side, also with its total read back
   in each call, the verify alone behind a busy kernel and as its
   wrapper's call reads, the plain versions, d1_partition of both
   sides, and torch.sort + torch.take of both sides' keys as the join's
   library yardstick); graft_join also on skewed buckets (small ones of
   ~6 tables against big ones of ~50 chunks) and on random sides at the
   asymmetric corpus' scale (its 199 M big keys against 1 small key and
   against its 4.1 M), timed;
6. main paths through swarm_tpu_torch.main.run, each with a warm-up
   run, then one timed run with every kernel's launch count set to 0
   before it and read after it, then the port's native C engine
   (SWARM_TPU_D2_ENGINE=native at d >= 2, SWARM_TPU_D1_NATIVE_MAX above
   n at d = 1), whose output files the run's must equal byte for byte:
   - d2_100k (99,831 amplicons of 142-158 nt) and d2_long (19,991 of
     ~400 nt): `swarm -d 2`, the network engine, kernel d2_diffs;
   - d2_device (20,808 amplicons of ~400 nt in dense clouds): `swarm
     -d 2` under SWARM_TPU_D2_ENGINE=device, kernel banded_scores;
   - d2_wide (5,204 amplicons, `-d 5 -m 1 -p 20 -g 1 -e 1`, band 70):
     the same engine, kernel full_scores;
   - d1_1m (gen_corpus of 1,000,000 amplicons of ~150 nt) with `-d 1
     -o -s`, d1_full_100k (the d2_100k corpus) with `-d 1 -o -s -u -i
     -w` and d1_mixed_1m (mixed_length_corpus of 1,000,000 amplicons of
     ~60 to ~5,000 nt, ~187 nt a row) with `-d 1 -o -s -i`: the d=1
     partitioned-join engine on ragged rows, kernels d1_keygen,
     d1_partition, d1_join and d1_verify;
   - d1_fastidious_200k (fastidious_corpus of 200,000 amplicons of
     ~150 nt, a quarter of them light satellites) and
     d1_fastidious_asym_200k (the same clouds with ~4,000 light
     satellites) with `-d 1 -f -y 12 -o -s -i` (bench.py's config 4 and
     writers): the d=1 engine, then the device graft, kernels
     graft_keygen, graft_join and graft_verify; the native oracle runs
     the host graft join (SWARM_TPU_GRAFT_PROBE_MAX above its keys), and
     so does one more run of the port, its d=1 engine on the card (the
     -f path before the device graft), whose files must also equal the
     oracle's.

The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Needs one CUDA device, nvcc and a C
compiler. Imports no JAX.

To compare two versions of the port on one card, run each in turns:

    python3 chip_smoke.py --quick [--tree OTHER_CHECKOUT]

runs only the timed kernel phases (2 to 5 at their timed shapes) and
the d2_100k, d2_device, d2_wide, d1_1m, d1_mixed_1m and
d1_fastidious_200k main paths of the package under OTHER_CHECKOUT
(default: this checkout), and ends with one JSON line
{"quick": {card, tree, kernels, main_paths}} instead of the two above.
"""

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent

# read when swarm_tpu_torch.progress is imported: per-phase times on stderr
os.environ["SWARM_TPU_TIMING"] = "1"
os.environ["SWARM_TPU_DB_CACHE"] = "0"

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate, and the float32 rate outside the tensor cores (an FMA counted as
# two), which stands in for the int32 work of these kernels: the data
# sheet has no int32 row, and int32 add and min run at a lower rate,
# which phase_probe measures
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: arithmetic per DP cell: the fewest instructions the function is known
#: to need, read from the compiled code of the kernels here. Score cell:
#: a compare, a three-way min, two add-mins, two adds. Diff cell (cost,
#: tie-break order and carried count in one word): a three-way min, two
#: add-mins, three logic operations, two adds. The recurrences written
#: out plainly (compares, selects, clamps) come to 12 and 35.
OPS_PER_SCORE_CELL = 6
OPS_PER_DIFF_CELL = 8
#: integer operations of the d=1 keygen as written (csrc/d1_join.cu): a
#: base costs ~16 over the two walks of its row (decode, two hash terms,
#: two powers, two prefix sums, the run test) and a key ~6 more (two
#: subtractions and a multiply-add a half); the count pass is ~half an
#: operation a base. The join and the verify do a few operations a byte.
OPS_PER_KEYGEN_BASE = 16
OPS_PER_KEY = 6
OPS_PER_JOIN_ELEMENT = 4
#: the partition: a key's bucket (two multiplies, a xor, a shift) and
#: digit, and its rank, once in each of two passes' two kernels
OPS_PER_PARTITION_KEY = 16
OPS_PER_VERIFY_WORD = 12
#: the graft keygen (csrc/graft.cu) as written: a position costs ~100
#: integer operations over its row's two walks (three table reads and
#: three XOR scans of 64 bits, then six keys), ~15 a key; the verify a
#: few a base compared
OPS_PER_GRAFT_KEY = 15
OPS_PER_GRAFT_BASE = 4


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, busy=None):
    """Milliseconds of one call of fn, by CUDA events around `reps`
    calls. With `busy` (busy_kernel) the calls are queued behind a
    kernel that holds the card for some milliseconds, so they run back
    to back and the host's time to enqueue them is not in the reading:
    a wrapper's Python costs more than a kernel of a few microseconds
    runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if busy is not None:
        busy()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def busy_kernel(dev):
    """A launcher of csrc/probe.cu's kernel: as it stands it holds the
    card for some milliseconds; with iters=0 it is an empty kernel."""
    import torch

    from swarm_tpu_torch._build import load

    lib = load()
    n_blocks = 132 * 8
    out = torch.empty(n_blocks * 256, dtype=torch.int32, device=dev)

    def launch(iters=1 << 16, blocks=n_blocks):
        stream = torch.cuda.current_stream().cuda_stream
        if lib.swarm_probe_int32_rate(blocks, iters, 3, out.data_ptr(),
                                      stream):
            raise AssertionError("probe kernel failed to launch")

    return launch


def launch_floor_ms(busy):
    """Milliseconds of an empty kernel (one block, no steps of
    csrc/probe.cu) queued behind the busy kernel: what any launch
    costs the card."""
    return cuda_ms(lambda: busy(iters=0, blocks=1), 200, busy)


def alone_and_wrapper_ms(call, busy, reset=None):
    """(alone_ms, wrapper_ms) of one call: queued behind the busy kernel,
    `reset` run once before (the kernel's own time), and with `reset`
    inside each call and no busy kernel, as the verifies were first
    timed (the wrapper's host time in the reading where it outlasts the
    kernel)."""
    if reset is not None:
        reset()
    alone = cuda_ms(call, 20, busy)
    if reset is None:
        return alone, cuda_ms(call, 10)
    return alone, cuda_ms(lambda: (reset(), call()), 10)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_probe(dev):
    """The card's rate of int32 adds and mins."""
    from swarm_tpu_torch._build import load

    blocks, iters = 132 * 8, 4096
    launch = busy_kernel(dev)
    ms = cuda_ms(lambda: launch(iters, blocks), 5)
    ops = load().swarm_probe_int32_ops(blocks, iters)
    say(f"probe int32 rate: {blocks} blocks x 256 threads, 8 independent "
        f"chains of {iters} steps (two adds and a min each): ops={ops} "
        f"ms={ms:.4f} int32_tops_per_s={ops / ms / 1e9:.2f} "
        f"(bounds use {PEAK_OPS_PER_S / 1e12:.0f}, the float32 rate)")


def phase_d2_diffs_bands(dev):
    """d2_diffs against its plain version for every register variant
    (B = 1..20) and the general variant, on a ragged-length corpus;
    returns max_abs_err."""
    import numpy as np
    import torch

    from swarm_tpu_torch._build import load
    from swarm_tpu_torch.corpora import D2_DIFFS_BAND_CASES, ragged_rows
    from swarm_tpu_torch.ops.d2_diffs import d2_diffs, d2_diffs_reference

    lib = load()
    worst = 0
    packed = []
    for B, d, (mm, go, ge) in D2_DIFFS_BAND_CASES:
        rows_np, lens_np = ragged_rows(100 + B, 96, 61 + B, B + 2)
        rows = torch.from_numpy(rows_np).to(dev)
        lens = torch.from_numpy(lens_np).to(dev)
        n = len(lens_np)
        tq = torch.arange(n, device=dev).repeat_interleave(n)
        td = torch.arange(n, device=dev).repeat(n)
        got = d2_diffs(rows, lens, tq, td, B, mm, go, ge, d)
        want = d2_diffs_reference(rows[tq], rows[td], lens[tq], lens[td], B,
                                  rows.shape[1], mm, go, ge, d)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        packed.append(lib.swarm_d2_packed(
            -(-rows.shape[1] // 16) * 16, B, mm, go, ge, d))
        say(f"kernel d2_diffs ragged corpus B={B} d={d} scores={(mm, go, ge)} "
            f"variant={'register' if packed[-1] else 'general'} "
            f"lengths={int(lens_np.min())}..{int(lens_np.max())} "
            f"tasks={tq.numel()} accepted={int((want >= 0).sum())} "
            f"max_abs_err={err}")
        if err:
            raise AssertionError(
                f"d2_diffs kernel disagrees with its plain version at B={B}")
        if not (want >= 0).any() or not (want < 0).any():
            raise AssertionError(f"ragged corpus at B={B} decides nothing")
    if packed != [1] * 20 + [0, 0]:
        raise AssertionError(f"unexpected d2_diffs variants: {packed}")
    return worst


def phase_full_scores_edges(dev):
    """full_scores against its plain version where the lengths sit on
    the edges of the kernel's schedule; returns max_abs_err."""
    import torch

    from swarm_tpu_torch.corpora import score_edge_cases
    from swarm_tpu_torch.ops import nw_scores

    built = nw_scores.built_full_strips()
    if built != nw_scores.FULL_STRIPS:
        raise AssertionError(f"the library's strips {built} are not "
                             f"FULL_STRIPS {nw_scores.FULL_STRIPS}")
    worst = n_cases = n_pairs = 0
    for i, (name, padded, lengths, seed_id, ids) in enumerate(
            score_edge_cases(nw_scores.FULL_STRIPS)):
        mm, go, ge = ((4, 12, 4), (18, 24, 13), (1, 1, 1))[i % 3]
        padded, lengths, ids = (torch.from_numpy(x).to(dev)
                                for x in (padded, lengths, ids))
        if i % 2:
            ids = ids.to(torch.int32)
        got = nw_scores.full_scores(padded, lengths, seed_id, ids, mm, go, ge)
        want = nw_scores.nw_scores_reference(
            padded, lengths, seed_id, ids, mm, go, ge)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        n_cases += 1
        n_pairs += ids.numel()
        if err:
            say(f"kernel full_scores edge case {name} scores={(mm, go, ge)} "
                f"lengths={lengths.tolist()} got={got.tolist()} "
                f"want={want.tolist()}")
            raise AssertionError(
                f"full_scores kernel disagrees with its plain version on "
                f"edge case {name}")
    say(f"kernel full_scores edge cases: cases={n_cases} pairs={n_pairs} "
        f"strips={nw_scores.FULL_STRIPS} max_abs_err={worst}")
    return worst


def phase_banded_scores_edges(dev):
    """banded_scores against its plain version on every band over ragged
    lengths and where the lengths sit on the edges of the band; returns
    max_abs_err."""
    import torch

    from swarm_tpu_torch.corpora import band_edge_cases
    from swarm_tpu_torch.ops import nw_scores

    worst = n_cases = n_pairs = n_inf = 0
    for name, padded, lengths, seed_id, ids, B, (mm, go, ge) in \
            band_edge_cases():
        padded, lengths, ids = (torch.from_numpy(x).to(dev)
                                for x in (padded, lengths, ids))
        nb = ids.numel()
        got = nw_scores.banded_scores(
            padded, lengths, seed_id, ids, mm, go, ge, B)
        tid = ids.long()
        want = nw_scores.banded_scores_reference(
            padded[seed_id].expand(nb, -1), padded[tid],
            lengths[seed_id].expand(nb), lengths[tid], mm, go, ge, B)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if nb else 0
        worst = max(worst, err)
        n_cases += 1
        n_pairs += nb
        n_inf += int((want == nw_scores.INF).sum())
        if err or got.shape != want.shape:
            say(f"kernel banded_scores edge case {name} B={B} "
                f"scores={(mm, go, ge)} lengths={lengths.tolist()} "
                f"got={got.tolist()} want={want.tolist()}")
            raise AssertionError(
                f"banded_scores kernel disagrees with its plain version on "
                f"edge case {name}")
    say(f"kernel banded_scores edge cases: cases={n_cases} pairs={n_pairs} "
        f"outside_the_band={n_inf} max_abs_err={worst}")
    return worst


def phase_d2_diffs_ties(dev, work):
    """d2_diffs against its plain version on tie-heavy chain corpora;
    returns max_abs_err."""
    import numpy as np
    import torch

    from swarm_tpu_torch.corpora import (
        D2_DIFFS_KERNEL_CASES, chain_corpus, make_db)
    from swarm_tpu_torch.ops.d2_diffs import (
        DeviceDiffEngine, d2_diffs, d2_diffs_reference)

    worst = 0
    for seed, d, (mm, go, ge) in D2_DIFFS_KERNEL_CASES:
        case_dir = work / f"tie_corpus_{seed}"
        case_dir.mkdir()
        db = make_db(case_dir, chain_corpus(seed, 50, 48, d + 1))
        eng = DeviceDiffEngine(db, d, dev)
        pa, pb = np.triu_indices(len(db), k=1)
        tq = torch.from_numpy(np.concatenate([pa, pb]).astype(np.int64)).to(dev)
        td = torch.from_numpy(np.concatenate([pb, pa]).astype(np.int64)).to(dev)
        B = eng.band_for_exact(d * max(mm, go + ge), go, ge)
        got = d2_diffs(eng.rows, eng.lens, tq, td, B, mm, go, ge, d)
        want = d2_diffs_reference(eng.rows[tq], eng.rows[td], eng.lens[tq],
                                  eng.lens[td], B, eng.Lmax, mm, go, ge, d)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        say(f"kernel d2_diffs tie corpus seed={seed} d={d} "
            f"scores={(mm, go, ge)} B={B} tasks={tq.numel()} "
            f"accepted={int((want >= 0).sum())} max_abs_err={err}")
        if err:
            raise AssertionError("d2_diffs kernel disagrees with its plain "
                                 "version on a tie corpus")
    return worst


def phase_d2_diffs_at_scale(dev, fasta):
    """d2_diffs on 2^20 directed tasks from the d2_100k candidate pairs;
    returns the kernel's row of numbers."""
    import numpy as np
    import torch

    from swarm_tpu_torch.corpora import read_db
    from swarm_tpu_torch.ops.d2_diffs import (
        DeviceDiffEngine, d2_diffs, d2_diffs_reference)
    from swarm_tpu_torch.ops.d2_network import D2NetworkEngine

    db = read_db(fasta)
    pa, pb, _ = D2NetworkEngine(db, 2, dev).candidate_pairs()
    eng = DeviceDiffEngine(db, 2, dev)
    # every directed task of the screen's pairs, repeated up to 2^20
    n_real = 2 * len(pa)
    reps = -(-(1 << 20) // n_real)
    tq = np.tile(np.concatenate([pa, pb]), reps)[: 1 << 20]
    td = np.tile(np.concatenate([pb, pa]), reps)[: 1 << 20]
    tq = torch.from_numpy(tq).to(dev)
    td = torch.from_numpy(td).to(dev)
    mm, go, ge, d = 18, 24, 13, 2  # default scores (params.py)
    B = eng.band_for_exact(d * max(mm, go + ge), go, ge)
    got = d2_diffs(eng.rows, eng.lens, tq, td, B, mm, go, ge, d)
    qrows, drows = eng.rows[tq], eng.rows[td]
    qlen, dlen = eng.lens[tq], eng.lens[td]
    want = d2_diffs_reference(qrows, drows, qlen, dlen, B, eng.Lmax,
                              mm, go, ge, d)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    ms = cuda_ms(lambda: d2_diffs(eng.rows, eng.lens, tq, td, B, mm, go,
                                  ge, d), 10)
    plain_ms = cuda_ms(lambda: d2_diffs_reference(
        qrows, drows, qlen, dlen, B, eng.Lmax, mm, go, ge, d), 2)
    # the work of these tasks: a task whose lengths differ by more than
    # B is rejected before its DP; the others walk dlen rows of 2B+1
    # slots. Bytes: both rows of a task once, its two indices and
    # lengths, its result
    active = (qlen > 0) & (dlen > 0) & ((qlen - dlen).abs() <= B)
    cells = int((dlen.long() * active).sum()) * (2 * B + 1)
    n_bytes = int((qlen.long() + dlen.long()).sum()) + tq.numel() * (16 + 8 + 4)
    bound_ms, bound_by = bound(n_bytes, cells * OPS_PER_DIFF_CELL)
    say(f"kernel d2_diffs d2_100k sample: tasks={tq.numel()} (the screen's "
        f"{n_real} directed tasks, repeated) Lmax={eng.Lmax} B={B} "
        f"accepted={int((want >= 0).sum())} max_abs_err={err} "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} cells={cells} "
        f"bytes={n_bytes} bound_ms={bound_ms:.4f} ({bound_by})")
    if err:
        raise AssertionError("d2_diffs kernel disagrees with its plain "
                             "version at d2_100k shapes")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_nw_scores(dev, fasta):
    """banded_scores and full_scores against their plain versions on one
    seed of the dense-cloud corpus and 4,096 targets; returns the two
    kernels' rows of numbers (timed at default scores, d = 2: B = 4)."""
    import numpy as np
    import torch

    from swarm_tpu_torch.corpora import read_db
    from swarm_tpu_torch.ops import nw_scores
    from swarm_tpu_torch.ops.neighbors import pad_codes
    from swarm_tpu_torch.ops.search_torch import DeviceAligner

    db = read_db(fasta)
    padded = pad_codes(db.codes, db.offsets, db.lengths, int(db.longest))
    al = DeviceAligner(padded, db.lengths, dev)
    # the most abundant amplicon is a centre; its family's records sit
    # among the others in seeded random order, so 4,096 ids taken at a
    # stride hold near and far targets
    seed_id = 0
    rng = np.random.default_rng(20260818)
    ids_np = np.sort(rng.choice(np.arange(1, len(db)), 4096, replace=False))
    ids = torch.from_numpy(ids_np.astype(np.int64)).to(dev)
    rows, lens = al.padded[ids], al.lengths[ids]
    nb = ids.numel()
    ql = int(al.lengths[seed_id])
    qrows = al.padded[seed_id].expand(nb, -1)
    qlens = al.lengths[seed_id].expand(nb)
    io_bytes = int(lens.long().sum()) + ql + nb * (8 + 4 + 4)

    result = {}
    worst_full = worst_band = 0
    for mm, go, ge in ((4, 12, 4), (3, 6, 2), (18, 24, 13)):
        full = nw_scores.full_scores(
            al.padded, al.lengths, seed_id, ids, mm, go, ge)
        full_plain = nw_scores.nw_scores_reference(
            al.padded, al.lengths, seed_id, ids, mm, go, ge)
        torch.cuda.synchronize()
        err = int((full.long() - full_plain.long()).abs().max())
        worst_full = max(worst_full, err)
        say(f"kernel full_scores scores={(mm, go, ge)} targets={nb} "
            f"qlen={ql} min={int(full.min())} max={int(full.max())} "
            f"max_abs_err={err}")
        if err:
            raise AssertionError("full_scores kernel disagrees with its "
                                 "plain version")
        for B in (4, 20, 63):
            got = nw_scores.banded_scores(
                al.padded, al.lengths, seed_id, ids, mm, go, ge, B)
            want = nw_scores.banded_scores_reference(
                qrows, rows, qlens, lens, mm, go, ge, B)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst_band = max(worst_band, err)
            cutoff = go + B * ge - 1  # the largest cutoff B is enough for
            inside = full <= cutoff
            ok = bool((got[inside] == full[inside]).all()) and bool(
                (got[~inside] > cutoff).all())
            say(f"kernel banded_scores scores={(mm, go, ge)} B={B} "
                f"targets={nb} within_cutoff={int(inside.sum())} "
                f"max_abs_err={err} contract_vs_full_row={ok}")
            if err:
                raise AssertionError("banded_scores kernel disagrees with "
                                     "its plain version")
            if not ok:
                raise AssertionError("banded_scores breaks its contract "
                                     "against the full-row kernel")

    mm, go, ge, B = 18, 24, 13, 4  # default scores at d = 2
    busy = busy_kernel(dev)
    floor_ms = launch_floor_ms(busy)
    say(f"launch floor: an empty kernel (1 block, 0 steps of csrc/probe.cu) "
        f"launch_floor_ms={floor_ms:.5f}")

    def banded(some_ids):
        return nw_scores.banded_scores(
            al.padded, al.lengths, seed_id, some_ids, mm, go, ge, B)

    in_band = (lens > 0) & ((lens - ql).abs() <= B)
    # (i) the list; (ii) one in-band target: the floor one pair's
    # recurrence sets; (iii) the list 64 times over: enough to fill the card
    short = banded(ids)
    ms = cuda_ms(lambda: banded(ids), 20, busy)
    one_id = ids[in_band][:1]
    chain_ms = cuda_ms(lambda: banded(one_id), 20, busy)
    many_ids = ids.repeat(64)
    err = int((banded(many_ids).long() - short.repeat(64).long()).abs().max())
    worst_band = max(worst_band, err)
    saturated_ms = cuda_ms(lambda: banded(many_ids), 10, busy)
    plain_ms = cuda_ms(lambda: nw_scores.banded_scores_reference(
        qrows, rows, qlens, lens, mm, go, ge, B), 2)
    cells = int((lens.long() * in_band).sum()) * (2 * B + 1)
    bound_ms, bound_by = bound(io_bytes, cells * OPS_PER_SCORE_CELL)
    saturated_bound_ms, _ = bound(64 * io_bytes,
                                  64 * cells * OPS_PER_SCORE_CELL)
    say(f"kernel banded_scores timed: targets={nb} in_band="
        f"{int(in_band.sum())} B={B} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} cells={cells} bytes={io_bytes} "
        f"bound_ms={bound_ms:.5f} ({bound_by}) one_target_chain_ms="
        f"{chain_ms:.4f} targets_x64={many_ids.numel()} saturated_ms="
        f"{saturated_ms:.4f} saturated_bound_ms={saturated_bound_ms:.5f} "
        f"share={saturated_bound_ms / saturated_ms:.3f} "
        f"x64_equals_list_tiled_max_abs_err={err}")
    if err:
        raise AssertionError("banded_scores on the list repeated 64 times "
                             "is not the list's scores tiled")
    result["banded_scores"] = {
        "max_abs_err": worst_band, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "chain_ms": chain_ms, "saturated_ms": saturated_ms,
        "saturated_bound_ms": saturated_bound_ms,
        "launch_floor_ms": floor_ms}

    ms = cuda_ms(lambda: nw_scores.full_scores(
        al.padded, al.lengths, seed_id, ids, mm, go, ge), 10)
    plain_ms = cuda_ms(lambda: nw_scores.nw_scores_reference(
        al.padded, al.lengths, seed_id, ids, mm, go, ge), 2)
    cells = int(lens.long().sum()) * ql
    bound_ms, bound_by = bound(io_bytes, cells * OPS_PER_SCORE_CELL)
    say(f"kernel full_scores timed: targets={nb} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} cells={cells} bytes={io_bytes} "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    result["full_scores"] = {
        "max_abs_err": worst_full, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return result


def _d1_rows(db, dev):
    """(codes, offsets, lengths, row_word, n_words) of a Db: its code
    arena and ragged layout as the d=1 engine puts them on `dev`."""
    from swarm_tpu_torch.ops.neighbors_sortjoin import SortJoinNeighborEngine

    return SortJoinNeighborEngine(db, dev).arena()


def _sorted_keys(keys, owners):
    import torch

    skeys, order = torch.sort(keys)
    return skeys, torch.take(owners, order)


def _dedup(cand):
    import torch

    return torch.unique_consecutive(torch.sort(cand).values)


def d1_check(name, rows):
    """d1_keygen (its count and pack pass, then its emit pass),
    d1_partition, d1_join and d1_verify against their plain versions on
    the same card tensors; returns the max_abs_err of each and the
    pipeline's tensors."""
    import torch

    from swarm_tpu_torch.ops import neighbors_sortjoin as sj

    codes, offsets, lengths, row_word, n_words = rows

    def err(got, want):
        if got.shape != want.shape:
            return float("inf")
        return int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0

    counts, words = sj.keygen_count(codes, offsets, lengths, row_word,
                                    n_words)
    ends, total = sj._cumsum_total(counts)
    keys, owners = sj.keygen_emit(words, row_word, lengths, ends, total)
    want_words, want_layout = sj.pack_ragged(codes, offsets, lengths)
    want_keys, want_owners, want_counts = sj.ragged_keys_reference(
        want_words, want_layout, lengths)
    e_keygen = max(err(words, want_words), err(row_word, want_layout),
                   err(counts, want_counts), err(owners, want_owners),
                   *(err(a, b) for a, b in zip(sj.split_keys(keys),
                                               sj.split_keys(want_keys))))
    del want_keys, want_owners, want_counts, want_words
    bits = sj.bucket_bits(keys.numel())
    want = sj.partition_reference(keys, owners, bits)
    part = sj.partition(keys.clone(), owners.clone(), bits)
    e_part = max(err(part[0], want[0]), err(part[1], want[1]),
                 err(part[2], want[2]),
                 *(err(a, b) for a, b in zip(sj.split_keys(part[0]),
                                             sj.split_keys(want[0]))))
    del want
    pkeys, powners, bucket_ends = part
    sizes = torch.diff(bucket_ends, prepend=bucket_ends.new_zeros(1))
    cand = sj.join_pairs(pkeys, powners, bucket_ends)
    skeys, sowners = _sorted_keys(keys, owners)
    e_join = max(
        err(cand, sj.join_buckets_reference(pkeys, powners, bucket_ends)),
        err(torch.sort(cand).values, torch.sort(
            sj.join_pairs_reference(skeys, sowners)).values),
        err(sj.join_count(pkeys, powners, bucket_ends)[0], torch.bincount(
            torch.searchsorted(bucket_ends,
                               sj._join_links(pkeys, powners)[0],
                               right=True), minlength=bucket_ends.numel())))
    del skeys, sowners
    uniq = _dedup(cand)
    ok = sj.verify_pairs(words, row_word, lengths, uniq)
    e_verify = err(ok, sj.verify_ragged_reference(words, row_word, lengths,
                                                  uniq))
    torch.cuda.synchronize()
    say(f"kernels d1 {name}: rows={lengths.numel()} lengths="
        f"{int(lengths.min())}..{int(lengths.max())} words={n_words} "
        f"keys={keys.numel()} bucket_bits={bits} largest_bucket="
        f"{int(sizes.max())} oversized_buckets="
        f"{int((sizes > sj.join_cap()).sum())} empty_buckets="
        f"{int((sizes == 0).sum())} candidates={cand.numel()} "
        f"unique={uniq.numel()} at_distance_1={int(ok.sum())} "
        f"max_abs_err keygen={e_keygen} partition={e_part} join={e_join} "
        f"verify={e_verify}")
    if e_keygen or e_part or e_join or e_verify:
        raise AssertionError(f"a d=1 kernel disagrees with its plain version "
                             f"on {name}")
    if not ok.any():
        raise AssertionError(f"{name}: no pair at distance 1 to verify")
    return {"d1_keygen": e_keygen, "d1_partition": e_part,
            "d1_join": e_join, "d1_verify": e_verify}, \
        (words, ends, keys, owners, pkeys, powners, bucket_ends, cand, uniq,
         ok)


def _h2d_ms(db, dev):
    """(pageable_ms, pinned_ms): host-clock milliseconds to copy the code
    arena to the card from pageable memory, and by pin_memory() and a
    copy from pinned memory; the median of five each, in turns."""
    import numpy as np
    import torch

    host = torch.from_numpy(db.codes)
    times = {"pageable": [], "pinned": []}
    for _ in range(5):
        for how in times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            src = host.pin_memory() if how == "pinned" else host
            src.to(dev, non_blocking=how == "pinned")
            torch.cuda.synchronize()
            times[how].append((time.perf_counter() - t0) * 1e3)
    return tuple(float(np.median(times[how])) for how in times)


def _partition_ms(keys, owners, bits, reps):
    """Milliseconds of d1_partition's launches on fresh copies of the keys
    (it partitions in place), as the wrapper makes them: each pass's
    count kernel, torch.cumsum and scatter kernel, then the bounds
    kernel, by a CUDA event after each, the mean of `reps` runs after a
    warm-up; returns {"count", "cumsum", "scatter", "bounds", "total"},
    count, cumsum and scatter summed over the passes."""
    import torch

    from swarm_tpu_torch._build import load
    from swarm_tpu_torch.ops import neighbors_sortjoin as sj

    lib = load()
    m = keys.numel()
    n_tiles = -(-m // lib.swarm_d1_partition_tile())
    stream = torch.cuda.current_stream().cuda_stream
    work = (torch.empty_like(keys), torch.empty_like(owners))
    spare = (torch.empty_like(keys), torch.empty_like(owners))
    out = dict.fromkeys(("count", "cumsum", "scatter", "bounds"), 0.0)

    def check(err):
        if err:
            raise AssertionError(f"d1_partition launch failed: CUDA error "
                                 f"{err}")

    for rep in range(reps + 1):
        work[0].copy_(keys)
        work[1].copy_(owners)
        stamps = []

        def mark(what):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps.append((what, ev))

        mark(None)
        src, dst = work, spare
        for shift, width in sj.digit_passes(bits):
            counts = torch.empty((1 << width) * n_tiles, dtype=torch.int32,
                                 device=keys.device)
            check(lib.swarm_d1_partition_count(
                src[0].data_ptr(), m, bits, shift, width, counts.data_ptr(),
                stream))
            mark("count")
            ends = torch.cumsum(counts, dim=0, dtype=torch.int32)
            mark("cumsum")
            check(lib.swarm_d1_partition_scatter(
                src[0].data_ptr(), src[1].data_ptr(), m, bits, shift, width,
                ends.data_ptr(), dst[0].data_ptr(), dst[1].data_ptr(),
                stream))
            mark("scatter")
            src, dst = dst, src
        bucket_ends = torch.empty(1 << bits, dtype=torch.int64,
                                  device=keys.device)
        check(lib.swarm_d1_partition_bounds(
            src[0].data_ptr(), m, bits, bucket_ends.data_ptr(), stream))
        mark("bounds")
        torch.cuda.synchronize()
        if rep:
            for (_, a), (what, b) in zip(stamps, stamps[1:]):
                out[what] += a.elapsed_time(b) / reps
    out["total"] = sum(out.values())
    return out


def d1_timed(name, fasta, dev):
    """The d=1 kernels against their plain versions on a corpus and
    timed there; returns (the three kernels' rows of numbers, the
    corpus' own numbers)."""
    import torch

    from swarm_tpu_torch.corpora import read_db
    from swarm_tpu_torch.ops import neighbors_sortjoin as sj

    t0 = time.perf_counter()
    db = read_db(fasta)
    pageable_ms, pinned_ms = _h2d_ms(db, dev)
    rows = _d1_rows(db, dev)
    codes, offsets, lengths, row_word, n_words = rows
    n = lengths.numel()
    say(f"kernels d1 {name}: read {n} rows ({codes.numel()} bases) in "
        f"{time.perf_counter() - t0:.1f}s; H2D of the arena: "
        f"pageable_ms={pageable_ms:.3f} pinned_ms={pinned_ms:.3f}")
    errs, (words, ends, keys, owners, pkeys, powners, bucket_ends, cand,
           uniq, ok) = d1_check(name, rows)

    n_keys = keys.numel()
    bits = sj.bucket_bits(n_keys)
    # the yardstick of the grouping step: what the parent's engine ran
    sort_ms = cuda_ms(lambda: _sorted_keys(keys, owners), 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    _sorted_keys(keys, owners)
    torch.cuda.synchronize()
    sort_peak = torch.cuda.max_memory_allocated() - base_bytes
    torch.cuda.reset_peak_memory_stats()
    sj.partition(keys.clone(), owners.clone(), bits)
    torch.cuda.synchronize()
    part_peak = torch.cuda.max_memory_allocated() - base_bytes
    part = _partition_ms(keys, owners, bits, 5)
    part_plain_ms = cuda_ms(lambda: sj.partition_reference(keys, owners,
                                                           bits), 1)
    n_buckets = bucket_ends.numel()
    n_bytes = n_keys * 24 + n_buckets * 8  # the pairs in and out, the ends
    bound_ms, bound_by = bound(n_bytes, OPS_PER_PARTITION_KEY * n_keys)
    passes = sj.digit_passes(bits)
    say(f"kernel d1_partition timed {name}: keys={n_keys} bucket_bits={bits} "
        f"passes={passes} count_ms={part['count']:.4f} "
        f"cumsum_ms={part['cumsum']:.4f} scatter_ms={part['scatter']:.4f} "
        f"bounds_ms={part['bounds']:.4f} kernel_ms={part['total']:.4f} "
        f"plain_ms={part_plain_ms:.3f} library_ms={sort_ms:.3f} (torch.sort "
        f"of the int64 keys and torch.take of the owners) bytes={n_bytes} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) peak_bytes_above_the_keys: "
        f"partition={part_peak} sort={sort_peak}")
    result = {"d1_partition": {
        "max_abs_err": errs["d1_partition"], "ms": part["total"],
        "plain_ms": part_plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": sort_ms,
        "count_ms": part["count"], "cumsum_ms": part["cumsum"],
        "scatter_ms": part["scatter"], "bounds_ms": part["bounds"],
        "passes": len(passes), "bucket_bits": bits,
        "peak_bytes": part_peak, "library_peak_bytes": sort_peak}}
    del keys, owners
    count_ms = cuda_ms(lambda: sj.keygen_count(
        codes, offsets, lengths, row_word, n_words), 10)
    emit_ms = cuda_ms(lambda: sj.keygen_emit(
        words, row_word, lengths, ends, n_keys), 5)
    pack_plain_ms = cuda_ms(lambda: sj.pack_ragged(codes, offsets, lengths),
                            1)
    plain_ms = pack_plain_ms + cuda_ms(lambda: sj.ragged_keys_reference(
        words, row_word, lengths), 1)
    bases = codes.numel()
    row_bytes = n * (8 + 4 + 8)  # offsets, lengths, row_word
    pack_bytes = bases + row_bytes + 4 * n_words + 4 * n
    pack_bound_ms, _ = bound(pack_bytes, 0)
    n_bytes = bases + row_bytes + 4 * n_words + n_keys * 12
    n_ops = OPS_PER_KEYGEN_BASE * bases + OPS_PER_KEY * n_keys
    bound_ms, bound_by = bound(n_bytes, n_ops)
    say(f"kernel d1_keygen timed {name}: rows={n} bases={bases} "
        f"words={n_words} keys={n_keys} count_pack_ms={count_ms:.4f} "
        f"(bytes={pack_bytes} bound_ms={pack_bound_ms:.4f}) "
        f"emit_ms={emit_ms:.4f} kernel_ms={count_ms + emit_ms:.4f} "
        f"plain_ms={plain_ms:.3f} (pack {pack_plain_ms:.3f}) "
        f"bytes={n_bytes} ops={n_ops} bound_ms={bound_ms:.4f} ({bound_by})")
    result["d1_keygen"] = {
        "max_abs_err": errs["d1_keygen"], "ms": count_ms + emit_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "count_pack_ms": count_ms, "emit_ms": emit_ms,
        "pack_bound_ms": pack_bound_ms, "pack_plain_ms": pack_plain_ms}

    jcounts, record = sj.join_count(pkeys, powners, bucket_ends)
    jends = torch.cumsum(jcounts, dim=0, dtype=torch.int64)
    n_cand = cand.numel()
    count_ms = cuda_ms(lambda: sj.join_count(pkeys, powners, bucket_ends), 10)
    emit_ms = cuda_ms(lambda: sj.join_emit(pkeys, powners, bucket_ends,
                                           record, jends, n_cand), 10)
    plain_ms = cuda_ms(lambda: sj.join_buckets_reference(
        pkeys, powners, bucket_ends), 1)
    n_bytes = n_keys * 12 + n_buckets * 8 + n_cand * 8
    n_ops = OPS_PER_JOIN_ELEMENT * n_keys
    bound_ms, bound_by = bound(n_bytes, n_ops)
    sizes = torch.diff(bucket_ends, prepend=bucket_ends.new_zeros(1))
    say(f"kernel d1_join timed {name}: keys={n_keys} buckets={n_buckets} "
        f"largest_bucket={int(sizes.max())} candidates={n_cand} "
        f"count_ms={count_ms:.4f} emit_ms={emit_ms:.4f} "
        f"kernel_ms={count_ms + emit_ms:.4f} plain_ms={plain_ms:.3f} "
        f"bytes={n_bytes} ops={n_ops} bound_ms={bound_ms:.4f} ({bound_by})")
    result["d1_join"] = {
        "max_abs_err": errs["d1_join"], "ms": count_ms + emit_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "count_ms": count_ms, "emit_ms": emit_ms}
    del pkeys, powners, bucket_ends

    dedup_ms = cuda_ms(lambda: _dedup(cand), 5)
    busy = busy_kernel(dev)
    floor_ms = launch_floor_ms(busy)
    ms, wrapper_ms = alone_and_wrapper_ms(
        lambda: sj.verify_pairs(words, row_word, lengths, uniq), busy)
    plain_ms = cuda_ms(lambda: sj.verify_ragged_reference(
        words, row_word, lengths, uniq), 1)
    a, b = sj.pair_ids(uniq)
    read = torch.unique(torch.cat([a, b]))
    sizes = sj.row_sizes(lengths.long())
    n_bytes = uniq.numel() * 9 + int(sizes[read].sum()) * 4 + \
        read.numel() * (4 + 8)
    walked = int(sj.row_sizes(torch.minimum(lengths[a], lengths[b]).long())
                 .sum())
    n_ops = OPS_PER_VERIFY_WORD * walked
    bound_ms, bound_by = bound(n_bytes, n_ops)
    say(f"kernel d1_verify timed {name}: pairs={uniq.numel()} "
        f"rows_read={read.numel()} words_walked={walked} "
        f"at_distance_1={int(ok.sum())} kernel_ms={ms:.4f} (alone, "
        f"behind the busy kernel) wrapper_ms={wrapper_ms:.4f} "
        f"launch_floor_ms={floor_ms:.5f} plain_ms={plain_ms:.3f} "
        f"dedup_ms={dedup_ms:.3f} bytes={n_bytes} ops={n_ops} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    result["d1_verify"] = {
        "max_abs_err": errs["d1_verify"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "wrapper_ms": wrapper_ms, "launch_floor_ms": floor_ms,
        "dedup_ms": dedup_ms}
    return result, {"h2d_pageable_ms": pageable_ms,
                    "h2d_pinned_ms": pinned_ms}


def phase_d1_kernels(dev, corpus, edges):
    """The d=1 kernels against their plain versions (with `edges`, also
    on the edge rows, the 125-row run and the ragged edge rows) and
    timed on the d1_1m and d1_mixed_1m corpora; returns the three
    kernels' rows of numbers (d1_1m's, with d1_mixed_1m's beside them
    under "d1_mixed_1m")."""
    from swarm_tpu_torch.corpora import (
        d1_edge_rows, insertion_run, make_db, ragged_edge_rows, rows_records)

    worst = dict.fromkeys(D1_KERNELS, 0)
    if edges:
        with tempfile.TemporaryDirectory(prefix="d1_edges_") as tmp:
            for case, rows in (("edge_rows", d1_edge_rows()),
                               ("insertion_run", insertion_run()),
                               ("long_insertion_run",
                                insertion_run(length=LONG_RUN)),
                               ("ragged_edge_rows", ragged_edge_rows())):
                (Path(tmp) / case).mkdir()
                db = make_db(Path(tmp) / case, rows_records(rows))
                errs, _ = d1_check(case, _d1_rows(db, dev))
                worst = {k: max(worst[k], errs[k]) for k in worst}

    result, h2d = d1_timed("d1_1m", corpus["d1_1m"], dev)
    mixed, mixed_h2d = d1_timed("d1_mixed_1m", corpus["d1_mixed_1m"], dev)
    for kernel, row in result.items():
        row["max_abs_err"] = max(row["max_abs_err"], worst[kernel],
                                 mixed[kernel]["max_abs_err"])
        row["d1_mixed_1m"] = mixed[kernel]
    result["d1_keygen"].update(h2d)
    result["d1_keygen"]["d1_mixed_1m"].update(mixed_h2d)
    return result


def _graft_rows(db, dev):
    """(words, row_word, lengths): the ragged rows as the graft engine
    packs them on `dev` (the arena through d1_keygen's count pass)."""
    from swarm_tpu_torch.ops import fastidious_torch as ft

    return ft.GraftEngine(db, dev).packed_rows()


def join_check(skeys, spays, s_buckets, bkeys, bpays, b_buckets):
    """(max_abs_err, pairs): graft_join's count pass (counts and records a
    chunk) against join_record_reference, its pairs element for element
    against join_reference, and neither side written."""
    import torch

    from swarm_tpu_torch.ops import fastidious_torch as ft
    from swarm_tpu_torch.ops import neighbors_sortjoin as sj

    def err(got, want):
        if got.shape != want.shape:
            return float("inf")
        return int((got - want).abs().max()) if got.numel() else 0

    before = [x.clone() for x in (skeys, spays, bkeys, bpays)]
    counts, record = ft.join_count(skeys, s_buckets, bkeys, b_buckets)
    ends, total = sj._cumsum_total(counts)
    pairs = ft.join_emit(spays, bpays, record, ends, total)
    want_counts, want = ft.join_record_reference(skeys, s_buckets, bkeys,
                                                 b_buckets)
    e = torch.arange(bkeys.numel(), device=bkeys.device)
    valid = e % ft.JOIN_CHUNK < want.n_rec.long()[e // ft.JOIN_CHUNK]
    worst = max(err(counts, want_counts),
                err(record.n_rec.long(), want.n_rec.long()),
                max((err(a, b) for a, b in zip(
                    sj.split_keys(record.rec[valid]),
                    sj.split_keys(want.rec[valid]))), default=0),
                max((err(a, b) for a, b in zip(
                    sj.split_keys(pairs),
                    sj.split_keys(ft.join_reference(skeys, spays, bkeys,
                                                    bpays)))), default=0),
                max(int(not torch.equal(x, y)) for x, y in zip(
                    before, (skeys, spays, bkeys, bpays))))
    return worst, pairs


def graft_check(name, db, heavy, light, dev, small_is_heavy=None):
    """graft_keygen (count and emit, both sides), graft_join (the sides
    partitioned by d1_partition into the same buckets; counts, records,
    pairs, both sides unwritten) and graft_verify (flags, each light
    row's smallest heavy one; on the join's pairs and on RANDOM_PAIRS
    pairs of random keys of the two sides, whose variants mostly differ,
    in length too) against their plain versions on the same card
    tensors, and the engine against the native host join; returns the
    max_abs_err of each and the tensors (the join's pairs and their
    flags). The kernels take the side of fewer keys as the small one, as
    the engine does, unless `small_is_heavy` says which."""
    import numpy as np
    import torch

    from swarm_tpu_torch import _native
    from swarm_tpu_torch.ops import fastidious_torch as ft
    from swarm_tpu_torch.ops import neighbors_sortjoin as sj

    def err(got, want):
        if got.shape != want.shape:
            return float("inf")
        return int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0

    def key_err(got, want):  # the halves, each within int64's range
        return max(err(a, b) for a, b in zip(sj.split_keys(got),
                                             sj.split_keys(want)))

    words, row_word, lengths = _graft_rows(db, dev)
    zob_np = ft.make_zobrist_pair(int(db.lengths.max()))
    zob = ft.zobrist_tensor(zob_np, dev)
    zob_plain = ft.zobrist_tensor(zob_np, "cpu").to(dev)
    lens = db.lengths.astype(np.int64)
    if small_is_heavy is None:
        small_is_heavy = (7 * lens[heavy] + 4).sum() <= \
            (7 * lens[light] + 4).sum()
    sides = []
    e_keygen = 0
    for amps in ((heavy, light) if small_is_heavy else (light, heavy)):
        ids = torch.from_numpy(np.asarray(amps, dtype=np.int64)).to(dev)
        counts = ft.keygen_count(words, row_word, lengths, ids)
        ends, total = sj._cumsum_total(counts)
        keys, pays = ft.keygen_emit(words, row_word, lengths, ids, zob, ends,
                                    total)
        want_keys, want_counts = ft.variant_keys_reference(
            words, row_word, lengths, ids, zob_plain)
        e_keygen = max(e_keygen, err(counts, want_counts),
                       err(counts, ft.variant_counts_reference(
                           words, row_word, lengths, ids)),
                       key_err(keys, want_keys),
                       err(pays, torch.arange(total, device=dev)))
        del want_keys
        sides.append([ids, ends, keys, pays])
    (s_ids, s_ends, skeys, spays), (b_ids, b_ends, bkeys, bpays) = sides
    bits = sj.bucket_bits(skeys.numel() + bkeys.numel())
    skeys, spays, s_buckets = sj.partition(skeys, spays, bits)
    bkeys, bpays, b_buckets = sj.partition(bkeys, bpays, bits)
    e_join, pairs = join_check(skeys, spays, s_buckets, bkeys, bpays,
                               b_buckets)
    checked = torch.cat([pairs, random_pairs(skeys.numel(), bkeys.numel(),
                                             dev)])
    best = torch.full((len(db),), 2**31 - 1, dtype=torch.int32, device=dev)
    want_best = best.clone()
    ok = ft.verify(words, row_word, lengths, s_ids, s_ends, b_ids, b_ends,
                   checked, small_is_heavy, best)
    want_ok = ft.verify_reference(words, row_word, lengths, s_ids, s_ends,
                                  b_ids, b_ends, checked)
    ft.best_reference(s_ids, s_ends, b_ids, b_ends, checked[want_ok],
                      small_is_heavy, want_best)
    e_verify = max(err(ok, want_ok), err(best, want_best))
    random_ok = int(ok[pairs.numel():].sum())
    ok = ok[:pairs.numel()]
    count, cand = ft.GraftEngine(db, dev).graft_candidates(heavy, light)
    native = _native.graft_join(db.codes, db.offsets, db.lengths, len(db),
                                heavy, light)
    n_count, n_cand = native if native is not None else (
        0, np.full(len(db), -1))
    # the native joins emit no deletion of a 1-nt row, so they do not
    # count the empty midpoint of a heavy and a light 1-nt row; the
    # engine counts it, as swarm_tpu's GraftEngine does
    one = db.lengths == 1
    empty_midpoints = int(one[heavy].sum()) * int(one[light].sum())
    torch.cuda.synchronize()
    sizes = torch.diff(s_buckets, prepend=s_buckets.new_zeros(1))
    say(f"kernels graft {name}: rows={len(db)} heavy={len(heavy)} "
        f"light={len(light)} small_side={'heavy' if small_is_heavy else 'light'}"
        f" keys={skeys.numel()}+{bkeys.numel()} bucket_bits={bits} "
        f"largest_small_bucket={int(sizes.max()) if sizes.numel() else 0} "
        f"empty_small_buckets={int((sizes == 0).sum())} "
        f"pairs={pairs.numel()} verified={int(ok.sum())} random_pairs="
        f"{checked.numel() - pairs.numel()} (verified {random_ok}) "
        f"engine_count="
        f"{count} native_count={n_count} (empty midpoints it does not "
        f"count: {empty_midpoints}) max_abs_err keygen={e_keygen} "
        f"join={e_join} verify={e_verify}")
    if e_keygen or e_join or e_verify:
        raise AssertionError(f"a graft kernel disagrees with its plain "
                             f"version on {name}")
    if count != n_count + empty_midpoints or \
            not np.array_equal(cand, n_cand):
        raise AssertionError(f"{name}: the graft engine disagrees with the "
                             f"native join")
    return {"graft_keygen": e_keygen, "graft_join": e_join,
            "graft_verify": e_verify}, (words, row_word, lengths, zob,
                                        small_is_heavy, sides, skeys, spays,
                                        s_buckets, bkeys, bpays, b_buckets,
                                        pairs, ok)


def random_pairs(s_keys, b_keys, dev):
    """RANDOM_PAIRS pairs (spay << 32) | bpay of random payloads of two
    sides of s_keys and b_keys keys (none if a side has none)."""
    import torch

    if not s_keys or not b_keys:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(RANDOM_PAIRS["seed"])
    n = RANDOM_PAIRS["pairs"]
    return (torch.randint(0, s_keys, (n,), generator=g, device=dev) << 32) \
        | torch.randint(0, b_keys, (n,), generator=g, device=dev)


def verify_timed(busy, words, row_word, lengths, s_ids, s_ends, b_ids,
                 b_ends, pairs, small_is_heavy):
    """(alone_ms, wrapper_ms) of graft_verify on `pairs`: queued behind
    the busy kernel with `best` filled once before, and as first timed
    (`best` filled inside each call, no busy kernel)."""
    import torch

    from swarm_tpu_torch.ops import fastidious_torch as ft

    best = torch.empty(lengths.numel(), dtype=torch.int32,
                       device=lengths.device)
    return alone_and_wrapper_ms(
        lambda: ft.verify(words, row_word, lengths, s_ids, s_ends, b_ids,
                          b_ends, pairs, small_is_heavy, best), busy,
        lambda: best.fill_(2**31 - 1))


def _graft_sides(name, fasta, work):
    """(db, heavy, light) that a `-d 1 -f` run of the port hands its graft
    engine, by one run of the main path's flags."""
    from swarm_tpu_torch.ops import fastidious_torch as ft

    seen = []
    real = ft.GraftEngine.graft_candidates

    def capture(self, heavy, light):
        seen.append((self.db, heavy, light))
        return real(self, heavy, light)

    ft.GraftEngine.graft_candidates = capture
    try:
        run_cli(MAIN_PATHS[name][2] + ["-l", "log.txt", str(fasta)],
                work / f"{name}_sides")
    finally:
        ft.GraftEngine.graft_candidates = real
    if len(seen) != 1:
        raise AssertionError(f"{name}: the graft engine ran {len(seen)} "
                             f"times")
    return seen[0]


def join_timed(name, max_abs_err, skeys, spays, s_buckets, bkeys, bpays,
               b_buckets, extra=None, note=""):
    """graft_join timed on partitioned sides: the count pass, the emit
    pass, the plain version, and the bound, with the items (chunks of the
    big side) and the largest; returns the kernel's row of numbers (with
    `extra`)."""
    import torch

    from swarm_tpu_torch.ops import fastidious_torch as ft
    from swarm_tpu_torch.ops import neighbors_sortjoin as sj

    jcount_ms = cuda_ms(lambda: ft.join_count(skeys, s_buckets, bkeys,
                                              b_buckets), 10)
    counts, record = ft.join_count(skeys, s_buckets, bkeys, b_buckets)
    jends, n_pairs = sj._cumsum_total(counts)
    jemit_ms = cuda_ms(lambda: ft.join_emit(spays, bpays, record, jends,
                                            n_pairs), 10)
    pairs = ft.join_emit(spays, bpays, record, jends, n_pairs)
    jplain_ms = cuda_ms(lambda: ft.join_reference(skeys, spays, bkeys,
                                                  bpays), 1)
    n_buckets = s_buckets.numel()
    sizes = torch.diff(s_buckets, prepend=s_buckets.new_zeros(1))
    b_sizes = torch.diff(b_buckets, prepend=b_buckets.new_zeros(1))
    # each key of a bucket that both sides hold (no other key can pair)
    # and each bucket end read once; the payload of each key that pairs
    # read once; each pair written once
    both = (sizes > 0) & (b_sizes > 0)
    n_keys = int((sizes + b_sizes)[both].sum())
    paired = torch.unique(pairs >> 32).numel() + \
        torch.unique(pairs & sj.MASK32).numel()
    n_bytes = n_keys * 8 + 2 * n_buckets * 8 + paired * 4 + n_pairs * 8
    bound_ms, bound_by = bound(n_bytes, OPS_PER_JOIN_ELEMENT * n_keys)
    # the items: chunks of the big side, each with the small span of the
    # buckets it touches
    first, last = ft.join_items(b_buckets, bkeys.numel())
    span = s_buckets[last] - torch.where(
        first > 0, s_buckets[(first - 1).clamp(min=0)], 0)
    items, largest = first.numel(), int(span.max()) if first.numel() else 0
    tiled = int((span > ft.JOIN_TILE).sum())
    records = int(record.n_rec.long().sum())
    ms = jcount_ms + jemit_ms
    library = (extra or {}).get("library_ms")
    say(f"kernel graft_join timed {name}: keys={skeys.numel()}+"
        f"{bkeys.numel()} buckets={n_buckets} largest_buckets="
        f"{int(sizes.max())}+{int(b_sizes.max())} empty_small_buckets="
        f"{int((sizes == 0).sum())} items={items} (chunks of "
        f"{ft.JOIN_CHUNK}) largest_item={ft.JOIN_CHUNK}+{largest} "
        f"tiled_items={tiled} records={records} pairs={n_pairs} "
        f"paired_keys={paired} count_ms={jcount_ms:.4f} "
        f"emit_ms={jemit_ms:.4f} kernel_ms={ms:.4f} plain_ms={jplain_ms:.3f} "
        + (f"library_ms={library:.3f} (torch.sort of both sides' int64 "
           f"keys and torch.take of their payloads) " if library else "")
        + f"{note + ' ' if note else ''}bytes={n_bytes} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": jplain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "count_ms": jcount_ms, "emit_ms": jemit_ms, "pairs": n_pairs,
            "items": items, "largest_item_small": largest,
            "tiled_items": tiled, "records": records, **(extra or {})}


def graft_join_skewed(dev):
    """graft_join on skewed buckets (SKEWED_JOIN): four buckets, each
    small one beyond a table, each big one tens of thousands of keys
    (tens of chunks), against its plain versions and timed; returns its
    row."""
    import numpy as np
    import torch

    from swarm_tpu_torch.ops import fastidious_torch as ft
    from swarm_tpu_torch.ops import neighbors_sortjoin as sj

    rng = np.random.default_rng(SKEWED_JOIN["seed"])
    values = rng.integers(-(1 << 62), 1 << 62, SKEWED_JOIN["distinct"])
    sides = []
    for n in (SKEWED_JOIN["small"], SKEWED_JOIN["big"]):
        keys = torch.from_numpy(values[rng.integers(0, values.size, n)])
        sides.append(sj.partition(keys.to(dev), torch.arange(
            n, dtype=torch.int32, device=dev), SKEWED_JOIN["bits"]))
    (skeys, spays, s_buckets), (bkeys, bpays, b_buckets) = sides
    worst, _ = join_check(skeys, spays, s_buckets, bkeys, bpays, b_buckets)
    torch.cuda.synchronize()
    sizes = torch.diff(s_buckets, prepend=s_buckets.new_zeros(1))
    if worst or int(sizes.min()) <= ft.JOIN_TILE:
        raise AssertionError("graft_join disagrees with its plain version "
                             "on skewed buckets")
    return join_timed("skewed_buckets", 0, skeys, spays, s_buckets, bkeys,
                      bpays, b_buckets)


def graft_join_random(dev):
    """graft_join on random sides (RANDOM_JOIN) against its plain
    versions and timed: the asymmetric cell's count of big keys against
    one small key (the count pass with next to no table) and against its
    count of small ones; returns their rows by name."""
    import torch

    from swarm_tpu_torch.ops import neighbors_sortjoin as sj

    g = torch.Generator(device=dev)
    g.manual_seed(RANDOM_JOIN["seed"])

    def draw(n):
        return torch.randint(-(2**62), 2**62, (n,), device=dev, generator=g)

    big = draw(RANDOM_JOIN["big"])
    smalls = []
    for n in RANDOM_JOIN["small"]:
        keys = draw(n)
        keys[:n // 100] = big[:n // 100]
        smalls.append(keys)

    def side(keys):
        return sj.partition(keys, torch.arange(
            keys.numel(), dtype=torch.int32, device=dev), RANDOM_JOIN["bits"])

    bkeys, bpays, b_buckets = side(big)
    rows = {}
    for keys in smalls:
        skeys, spays, s_buckets = side(keys)
        name = f"random_{skeys.numel()}_small_{bkeys.numel()}_big"
        worst, _ = join_check(skeys, spays, s_buckets, bkeys, bpays,
                              b_buckets)
        torch.cuda.synchronize()
        if worst:
            raise AssertionError(f"graft_join disagrees with its plain "
                                 f"version on {name}")
        rows[name] = join_timed(name, 0, skeys, spays, s_buckets, bkeys,
                                bpays, b_buckets)
    return rows


def graft_timed(name, fasta, dev, work):
    """The graft kernels against their plain versions on the sides a
    main path's run gives them, and timed there; returns the three
    kernels' rows of numbers."""
    import torch

    from swarm_tpu_torch.ops import fastidious_torch as ft
    from swarm_tpu_torch.ops import neighbors_sortjoin as sj

    db, heavy, light = _graft_sides(name, fasta, work)
    errs, (words, row_word, lengths, zob, small_is_heavy, sides, skeys,
           spays, s_buckets, bkeys, bpays, b_buckets, pairs, ok) = \
        graft_check(name, db, heavy, light, dev)
    (s_ids, s_ends, _, _), (b_ids, b_ends, _, _) = sides
    n_keys = skeys.numel() + bkeys.numel()
    bases = int(lengths[s_ids].long().sum() + lengths[b_ids].long().sum())
    rows = s_ids.numel() + b_ids.numel()
    row_words = int(sj.row_sizes(lengths[s_ids].long()).sum()
                    + sj.row_sizes(lengths[b_ids].long()).sum())

    def counts():
        for ids in (s_ids, b_ids):
            ft.keygen_count(words, row_word, lengths, ids)

    def emit(ids, ends, total=None):
        # total None: read back in each call, a synchronisation that puts
        # the wrapper's host time in the reading
        return lambda: ft.keygen_emit(
            words, row_word, lengths, ids, zob, ends,
            int(ends[-1]) if total is None else total)

    zob_plain = ft.zobrist_tensor(ft.make_zobrist_pair(int(db.lengths.max())),
                                  "cpu").to(dev)
    count_ms = cuda_ms(counts, 10)
    # each side's emit, its total read before; then read back in each call
    side_ms = [cuda_ms(emit(ids, ends, int(ends[-1])), 5)
               for ids, ends in ((s_ids, s_ends), (b_ids, b_ends))]
    synced_ms = [cuda_ms(emit(ids, ends), 5)
                 for ids, ends in ((s_ids, s_ends), (b_ids, b_ends))]
    emit_ms = sum(side_ms)
    plain_ms = cuda_ms(lambda: [ft.variant_keys_reference(
        words, row_word, lengths, ids, zob_plain) for ids in (s_ids, b_ids)],
        1)
    # each row's words, id, start, length and key end once; the table;
    # each key and its payload written once
    n_bytes = 4 * row_words + rows * (8 + 8 + 4 + 8) + zob.numel() * 4 + \
        n_keys * 12
    bound_ms, bound_by = bound(n_bytes, OPS_PER_GRAFT_KEY * n_keys)
    say(f"kernel graft_keygen timed {name}: rows={rows} "
        f"({s_ids.numel()}+{b_ids.numel()}) bases={bases} keys={n_keys} "
        f"({skeys.numel()}+{bkeys.numel()}) longest={int(db.lengths.max())} "
        f"count_ms={count_ms:.4f} emit_ms={emit_ms:.4f} "
        f"(small side {side_ms[0]:.4f}, big side {side_ms[1]:.4f}; with the "
        f"total read back in each call {synced_ms[0]:.4f} + "
        f"{synced_ms[1]:.4f}) kernel_ms={count_ms + emit_ms:.4f} "
        f"plain_ms={plain_ms:.3f} bytes={n_bytes} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    result = {"graft_keygen": {
        "max_abs_err": errs["graft_keygen"], "ms": count_ms + emit_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "count_ms": count_ms, "emit_ms": emit_ms,
        "emit_sides_ms": side_ms, "emit_synced_sides_ms": synced_ms,
        "keys": n_keys}}

    part_ms = cuda_ms(lambda: [sj.partition(k.clone(), p.clone(),
                                            s_buckets.numel().bit_length() - 1)
                               for k, p in ((skeys, spays), (bkeys, bpays))],
                      3)
    all_keys, all_pays = torch.cat([skeys, bkeys]), torch.cat([spays, bpays])
    sort_ms = cuda_ms(lambda: _sorted_keys(all_keys, all_pays), 3)
    del all_keys, all_pays
    result["graft_join"] = join_timed(
        name, errs["graft_join"], skeys, spays, s_buckets, bkeys, bpays,
        b_buckets, {"library_ms": sort_ms, "partition_ms": part_ms},
        f"partition_ms={part_ms:.4f} (d1_partition of both sides)")

    busy = busy_kernel(dev)
    floor_ms = launch_floor_ms(busy)
    ms, wrapper_ms = verify_timed(busy, words, row_word, lengths, s_ids,
                                  s_ends, b_ids, b_ends, pairs,
                                  small_is_heavy)
    plain_ms = cuda_ms(lambda: ft.verify_reference(
        words, row_word, lengths, s_ids, s_ends, b_ids, b_ends, pairs), 1)
    s_amp, _ = ft.decode_payloads(s_ids, s_ends, pairs >> 32)
    b_amp, _ = ft.decode_payloads(b_ids, b_ends, pairs & sj.MASK32)
    read = torch.unique(torch.cat([s_amp, b_amp]))
    compared = int(torch.minimum(lengths[s_amp], lengths[b_amp]).long().sum())
    lights = torch.unique((b_amp if small_is_heavy else s_amp)[ok]).numel()
    # each pair read and its flag written; each row a pair touches: its
    # words, length, id and the two key ends around it; each light row's
    # best written once
    n_bytes = pairs.numel() * 9 + 4 * int(sj.row_sizes(
        lengths[read].long()).sum()) + read.numel() * (4 + 8 + 16) + \
        4 * lights
    bound_ms, bound_by = bound(n_bytes, OPS_PER_GRAFT_BASE * compared)
    say(f"kernel graft_verify timed {name}: pairs={pairs.numel()} "
        f"rows_read={read.numel()} bases_compared={compared} "
        f"verified={int(ok.sum())} kernel_ms={ms:.4f} (alone, behind the "
        f"busy kernel) wrapper_ms={wrapper_ms:.4f} launch_floor_ms="
        f"{floor_ms:.5f} plain_ms={plain_ms:.3f} bytes={n_bytes} "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    result["graft_verify"] = {
        "max_abs_err": errs["graft_verify"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "wrapper_ms": wrapper_ms, "launch_floor_ms": floor_ms,
        "pairs": pairs.numel()}
    return result


def graft_edges(dev):
    """The graft kernels against their plain versions on the ragged edge
    rows, the word-edge rows of graft_edge_rows, a long insertion run
    whose light bucket outgrows the join's table, and an empty side;
    graft_verify timed alone on each side's pairs. Returns the worst
    max_abs_err of each kernel and the verify's {side: (pairs, alone
    ms)}."""
    import numpy as np

    from swarm_tpu_torch.corpora import (
        graft_edge_rows, insertion_run, make_db, ragged_edge_rows,
        record_index, rows_records)

    def every(k):
        return lambda db: np.arange(len(db)) % k != 0 if k else \
            np.zeros(len(db), dtype=bool)

    edge_rows, edge_light = graft_edge_rows()
    worst = dict.fromkeys(GRAFT_KERNELS, 0)
    timed = {}
    busy = busy_kernel(dev)
    with tempfile.TemporaryDirectory(prefix="graft_edges_") as tmp:
        for case, rows, light_of in (
                ("ragged_edge_rows", ragged_edge_rows(), every(2)),
                ("graft_edge_rows", edge_rows,
                 lambda db: edge_light[record_index(db)]),
                ("long_insertion_run", insertion_run(length=LONG_GRAFT_RUN),
                 every(500)),
                ("empty_side", insertion_run(), every(None))):
            (Path(tmp) / case).mkdir()
            db = make_db(Path(tmp) / case, rows_records(rows))
            light = light_of(db)
            # the long run's light side as the small one: its bucket
            # of 4,196 equal keys spans five tables, linked across
            errs, (words, row_word, lengths, _, small_is_heavy, sides, *_,
                   pairs, _) = graft_check(
                case, db, np.nonzero(~light)[0], np.nonzero(light)[0],
                dev, False if case == "long_insertion_run" else None)
            worst = {k: max(worst[k], errs[k]) for k in worst}
            if pairs.numel():
                (s_ids, s_ends, _, _), (b_ids, b_ends, _, _) = sides
                ms, _ = verify_timed(busy, words, row_word, lengths, s_ids,
                                     s_ends, b_ids, b_ends, pairs,
                                     small_is_heavy)
                timed[case] = (pairs.numel(), ms)
                say(f"kernel graft_verify timed {case}: pairs="
                    f"{pairs.numel()} kernel_ms={ms:.4f} (alone)")
    return worst, timed


def phase_graft_kernels(dev, corpus, work, edges):
    """The graft kernels against their plain versions (with `edges`, also
    on graft_edges' sides) and timed on the fastidious corpora of
    `corpus`; returns the three kernels' rows (d1_fastidious_200k's, with
    the asymmetric corpus' beside them)."""
    worst = dict.fromkeys(GRAFT_KERNELS, 0)
    if edges:
        worst, timed = graft_edges(dev)
    result = graft_timed("d1_fastidious_200k", corpus["d1_fastidious_200k"],
                         dev, work)
    for kernel, row in result.items():
        row["max_abs_err"] = max(row["max_abs_err"], worst[kernel])
    if edges:
        result["graft_verify"]["edge_sides_ms"] = timed
        result["graft_join"]["skewed_buckets"] = graft_join_skewed(dev)
        result["graft_join"]["random_sides"] = graft_join_random(dev)
    if "d1_fastidious_asym_200k" in corpus:
        asym = graft_timed("d1_fastidious_asym_200k",
                           corpus["d1_fastidious_asym_200k"], dev, work)
        for kernel, row in result.items():
            row["max_abs_err"] = max(row["max_abs_err"],
                                     asym[kernel]["max_abs_err"])
            row["d1_fastidious_asym_200k"] = asym[kernel]
    return result


def run_cli(argv, workdir, env=None):
    """One CLI run of the port in `workdir` with the variables of `env`
    set; returns (seconds, [timing] lines)."""
    from swarm_tpu_torch.main import run

    workdir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    err = io.StringIO()
    real_err = sys.__stderr__
    os.chdir(workdir)
    sys.__stderr__ = err  # progress.py writes its [timing] lines here
    env = env or {}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        rc = run(argv, "swarm")
        sec = time.perf_counter() - t0
    finally:
        for key in env:
            os.environ.pop(key, None)
        sys.__stderr__ = real_err
        os.chdir(cwd)
    if rc != 0:
        raise AssertionError(f"run {argv} returned {rc}")
    return sec, [ln for ln in err.getvalue().splitlines()
                 if ln.startswith("[timing]")]


def kernel_counts():
    from swarm_tpu_torch.ops import (
        d2_diffs, fastidious_torch, neighbors_sortjoin, nw_scores)

    return {"d2_diffs": d2_diffs.launches, **nw_scores.launches,
            **neighbors_sortjoin.launches, **fastidious_torch.launches}


def reset_kernel_counts():
    from swarm_tpu_torch.ops import (
        d2_diffs, fastidious_torch, neighbors_sortjoin, nw_scores)

    d2_diffs.launches = 0
    for counts in (nw_scores.launches, neighbors_sortjoin.launches,
                   fastidious_torch.launches):
        for name in counts:
            counts[name] = 0


def phase_main_path(name, fasta, flags, work, env, kernels, native_env):
    """Warm-up run, then one timed run through the port with the
    variables of `env` set and every kernel's launch count set to 0
    before it and read after it; then the native engine's run (under
    `native_env`), whose files the port's must equal byte for byte; for
    a `-f` path also a run with the graft on the host join, whose files
    must too. Returns the timed run's launch counts of `kernels`, its
    seconds, the native engine's, and its [timing] lines."""
    import torch

    from swarm_tpu_torch import metrics

    n = sum(1 for ln in open(fasta) if ln.startswith(">"))
    argv = flags + ["-l", "log.txt", str(fasta)]
    outputs = [flags[i + 1] for i in range(len(flags) - 1)
               if flags[i] in ("-o", "-s", "-u", "-i", "-w")] + ["log.txt"]
    engine = env.get("SWARM_TPU_D2_ENGINE")
    warm_s, _ = run_cli(argv, work / f"{name}_warm", env)
    torch.cuda.synchronize()

    reset_kernel_counts()
    metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    sec, timing = run_cli(argv, work / f"{name}_torch", env)
    counts = kernel_counts()
    comparisons = dict(metrics.last_run)
    peak = torch.cuda.max_memory_allocated()
    if flags[:2] == ["-d", "2"] and engine is None and \
            metrics.last_run.get("qgram_screen_comparisons") != n * (n - 1) // 2:
        raise AssertionError(f"{name}: the network engine did not run")
    if flags[:2] == ["-d", "1"] and not any(
            ln.startswith("[timing] d1 join (cuda)") for ln in timing):
        raise AssertionError(f"{name}: the d=1 sort-join engine did not run")
    if "-f" in flags and not any(ln.startswith("[timing] graft (cuda)")
                                 for ln in timing):
        raise AssertionError(f"{name}: the device graft did not run")
    for kernel in kernels:
        if counts[kernel] < 1:
            raise AssertionError(f"{name}: kernel {kernel} never launched")
    native_s, _ = run_cli(argv, work / f"{name}_native", native_env)
    runs = [f"{name}_torch"]
    host_graft = ""
    if "-f" in flags:
        # the same run with the graft on the host join (the port's -f
        # path before the device graft), the d=1 engine on the card
        host_graft_s, _ = run_cli(argv, work / f"{name}_host_graft", {
            **env, "SWARM_TPU_GRAFT_PROBE_MAX": str(1 << 40)})
        runs.append(f"{name}_host_graft")
        host_graft = f"host_graft_s={host_graft_s:.3f} "

    say(f"main path {name}: n={n} engine={engine or 'auto'} "
        f"flags={' '.join(flags)} warmup_s={warm_s:.3f} warm_s={sec:.3f} "
        f"native_engine_s={native_s:.3f} {host_graft}launches={counts} "
        f"comparisons={comparisons} device_peak_bytes={peak}")
    if engine == "device":
        say(f"main path {name}: target lists that took the device="
            f"{comparisons.get('d2_device_batches')} stayed under "
            f"MIN_DEVICE_BATCH={comparisons.get('d2_host_batches')}")
    for ln in timing:
        say(f"  {name} {ln}")
    for run in runs:
        for out in outputs:
            a = (work / run / out).read_bytes()
            b = (work / f"{name}_native" / out).read_bytes()
            if a != b or not a:
                raise AssertionError(f"{run}: {out} differs from the native "
                                     f"engine's ({len(a)} vs {len(b)} bytes)")
    say(f"main path {name}: {len(outputs)} output files byte-identical "
        f"to the native engine's ({', '.join(runs)})")
    return {"launches": {k: counts[k] for k in kernels}, "warm_s": sec,
            "native_s": native_s, "device_peak_bytes": peak,
            "timing": timing}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=REPO,
                    help="checkout whose swarm_tpu_torch runs (with --quick)")
    ap.add_argument("--quick", action="store_true",
                    help="timed kernel phases and the quick main paths only")
    args = ap.parse_args()
    tree = args.tree.resolve()
    if not (tree / "swarm_tpu_torch").is_dir():
        say(f"FAIL swarm_tpu_torch not found in {tree}")
        return 1
    if tree != REPO and not args.quick:
        say("FAIL --tree needs --quick")
        return 1
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        say("FAIL no CUDA device")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    say(card)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    from swarm_tpu_torch import _build, _native
    from swarm_tpu_torch.device import device_name

    t1 = time.perf_counter()
    log = _build.build(verbose=True)
    _build.load()
    t2 = time.perf_counter()
    say(f"build: native library {t1 - t0:.1f}s "
        f"({_native.library_path().name}), CUDA kernels {t2 - t1:.1f}s "
        f"({_build.library_path().name})")
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "registers" in ln \
                or "spill" in ln:
            say(f"  {ln.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.quick:
            say(json.dumps({"quick": {
                "card": card, "tree": str(tree),
                **run_quick(dev, Path(tmp))}}))
            return 0
        kernels = run_phases(dev, Path(tmp))
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": device_name(),
        "count": torch.cuda.device_count(),
    }}))
    return 0


D2_NATIVE = {"SWARM_TPU_D2_ENGINE": "native"}
D1_NATIVE = {"SWARM_TPU_D1_NATIVE_MAX": str(1 << 40)}
#: insertion_run(length=LONG_RUN): 4,504 rows sharing one key, a bucket
#: beyond the join kernel's shared-memory tile (its oversized variant)
LONG_RUN = 1500
D1_KERNELS = ("d1_keygen", "d1_partition", "d1_join", "d1_verify")
GRAFT_KERNELS = ("graft_keygen", "graft_join", "graft_verify")
#: the native engines of -d 1 -f: the d=1 network and the host graft join
GRAFT_NATIVE = {**D1_NATIVE, "SWARM_TPU_GRAFT_PROBE_MAX": str(1 << 40)}
#: insertion_run(length=LONG_GRAFT_RUN): 4,204 rows that share a variant,
#: all but every 500th light: a light bucket beyond the graft join's
#: 1,024-element table (taken in tiles, its chain linked across them)
LONG_GRAFT_RUN = 1400
#: graft_join's skewed buckets: random keys from `distinct` values in
#: 2^bits buckets, each small bucket ~6,000 keys (~6 tables of 1,024),
#: each big one ~50,000 (~49 chunks of 1,024): a big-side bucket of
#: homopolymer-rich reads against a small-side bucket beyond one table
SKEWED_JOIN = {"seed": 20261017, "distinct": 6_000, "small": 24_000,
               "big": 200_000, "bits": 2}
#: random sides at d1_fastidious_asym_200k's scale: its big side's count
#: of keys against 1 and against its small side's count, a hundredth of
#: those drawn from the big side, in its 2^18 buckets
RANDOM_JOIN = {"seed": 20261018, "big": 199_146_219,
               "small": (1, 4_148_705), "bits": 18}
#: random pairs of keys of the two sides that the graft verify takes
#: beside the join's pairs in every graft check
RANDOM_PAIRS = {"seed": 20261019, "pairs": 4096}
#: bench.py's config 4 (d1_fastidious) and the writers
FASTIDIOUS_FLAGS = ["-d", "1", "-f", "-y", "12", "-o", "out.txt", "-s",
                    "stats.txt", "-i", "structure.txt"]

#: name -> (corpus maker, its arguments, CLI flags, environment, kernels,
#: environment of the native engine)
MAIN_PATHS = {
    "d2_100k": ("gen_corpus", {"n": 100_000, "length": 150},
                ["-d", "2", "-o", "out.txt", "-s", "stats.txt", "-u",
                 "uclust.txt", "-i", "structure.txt", "-w", "seeds.fasta"],
                {}, ("d2_diffs",), D2_NATIVE),
    "d2_long": ("gen_corpus", {"n": 20_000, "length": 400},
                ["-d", "2", "-o", "out.txt", "-s", "stats.txt"],
                {}, ("d2_diffs",), D2_NATIVE),
    "d2_device": ("dense_cloud_corpus",
                  {"n_centers": 4, "cloud": 2600, "length": 400},
                  ["-d", "2", "-o", "out.txt", "-s", "stats.txt", "-i",
                   "structure.txt"], {"SWARM_TPU_D2_ENGINE": "device"},
                  ("banded_scores",), D2_NATIVE),
    "d2_wide": ("dense_cloud_corpus",
                {"n_centers": 1, "cloud": 2601, "length": 400},
                ["-d", "5", "-m", "1", "-p", "20", "-g", "1", "-e", "1",
                 "-o", "out.txt", "-s", "stats.txt", "-i", "structure.txt"],
                {"SWARM_TPU_D2_ENGINE": "device"}, ("full_scores",),
                D2_NATIVE),
    "d1_1m": ("gen_corpus", {"n": 1_000_000, "length": 150},
              ["-d", "1", "-o", "out.txt", "-s", "stats.txt"],
              {}, D1_KERNELS, D1_NATIVE),
    "d1_full_100k": ("gen_corpus", {"n": 100_000, "length": 150},
                     ["-d", "1", "-o", "out.txt", "-s", "stats.txt", "-u",
                      "uclust.txt", "-i", "structure.txt", "-w",
                      "seeds.fasta"], {}, D1_KERNELS, D1_NATIVE),
    "d1_mixed_1m": ("mixed_length_corpus", {"n": 1_000_000},
                    ["-d", "1", "-o", "out.txt", "-s", "stats.txt", "-i",
                     "structure.txt"], {}, D1_KERNELS, D1_NATIVE),
    "d1_fastidious_200k": ("fastidious_corpus", {"n": 200_000},
                           FASTIDIOUS_FLAGS, {}, D1_KERNELS + GRAFT_KERNELS,
                           GRAFT_NATIVE),
    "d1_fastidious_asym_200k": ("fastidious_corpus",
                                {"n": 200_000, "satellites": 0.3},
                                FASTIDIOUS_FLAGS, {},
                                D1_KERNELS + GRAFT_KERNELS, GRAFT_NATIVE),
}


def make_corpora(work, names):
    """name -> FASTA file; paths with the same corpus share one file."""
    from swarm_tpu_torch import corpora

    corpus, made = {}, {}
    for name in names:
        maker, kwargs = MAIN_PATHS[name][:2]
        key = (maker, tuple(sorted(kwargs.items())))
        if key not in made:
            made[key] = work / f"{name}.fasta"
            t0 = time.perf_counter()
            getattr(corpora, maker)(made[key], **kwargs)
            say(f"corpus {name}: {maker}({kwargs}) "
                f"{time.perf_counter() - t0:.1f}s")
        corpus[name] = made[key]
    return corpus


def run_main_path(name, corpus, work):
    flags, env, kernels, native_env = MAIN_PATHS[name][2:]
    return phase_main_path(name, corpus[name], flags, work, env, kernels,
                           native_env)


QUICK_PATHS = ("d2_100k", "d2_device", "d2_wide", "d1_1m", "d1_mixed_1m",
               "d1_fastidious_200k")


def run_quick(dev, work):
    """The timed kernel phases and the QUICK_PATHS main paths."""
    corpus = make_corpora(work, QUICK_PATHS)
    rows = {"d2_diffs": phase_d2_diffs_at_scale(dev, corpus["d2_100k"])}
    rows.update(phase_nw_scores(dev, corpus["d2_device"]))
    rows.update(phase_d1_kernels(dev, corpus, edges=False))
    rows.update(phase_graft_kernels(dev, corpus, work, edges=False))
    paths = {name: run_main_path(name, corpus, work) for name in QUICK_PATHS}
    return {"kernels": rows, "main_paths": paths}


def run_phases(dev, work):
    """Kernel and main-path phases; returns the kernel table."""
    corpus = make_corpora(work, MAIN_PATHS)

    phase_probe(dev)
    rows = {"d2_diffs": phase_d2_diffs_at_scale(dev, corpus["d2_100k"])}
    rows["d2_diffs"]["max_abs_err"] = max(
        rows["d2_diffs"]["max_abs_err"], phase_d2_diffs_ties(dev, work),
        phase_d2_diffs_bands(dev))
    rows.update(phase_nw_scores(dev, corpus["d2_device"]))
    rows["full_scores"]["max_abs_err"] = max(
        rows["full_scores"]["max_abs_err"], phase_full_scores_edges(dev))
    rows["banded_scores"]["max_abs_err"] = max(
        rows["banded_scores"]["max_abs_err"], phase_banded_scores_edges(dev))
    rows.update(phase_d1_kernels(dev, corpus, edges=True))
    rows.update(phase_graft_kernels(dev, corpus, work, edges=True))

    launches = {}
    for name in MAIN_PATHS:
        ran = run_main_path(name, corpus, work)
        for kernel, count in ran["launches"].items():
            launches.setdefault(kernel, count)  # the first path's count

    d1 = "swarm_tpu_torch/csrc/d1_join.cu"
    graft = "swarm_tpu_torch/csrc/graft.cu"
    static = {
        "d2_diffs": ("swarm_tpu_torch/csrc/d2_diffs.cu",
                     "swarm_tpu/ops/pallas_d2_diffs.py:191"),
        "banded_scores": ("swarm_tpu_torch/csrc/nw_scores.cu",
                          "swarm_tpu/ops/pallas_nw.py:410"),
        "full_scores": ("swarm_tpu_torch/csrc/nw_scores.cu",
                        "swarm_tpu/ops/pallas_nw.py:240"),
        # the d=1 path's device work was XLA programs, not Pallas kernels
        "d1_keygen": (d1, "swarm_tpu/ops/neighbors_sortjoin.py:142"),
        "d1_partition": (d1, "swarm_tpu/ops/neighbors_sortjoin.py:484"),
        "d1_join": (d1, "swarm_tpu/ops/neighbors_sortjoin.py:416"),
        "d1_verify": (d1, "swarm_tpu/ops/neighbors_sortjoin.py:337"),
        # so were the graft's: keygen, the sort-join and the probe (both
        # served by graft_join), the midpoint rebuild
        "graft_keygen": (graft, "swarm_tpu/ops/fastidious_jax.py:582"),
        "graft_join": (graft, "swarm_tpu/ops/fastidious_jax.py:626"),
        "graft_verify": (graft, "swarm_tpu/ops/fastidious_jax.py:79"),
    }
    return [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[name], **rows[name]}
            for name, (source, replaces) in static.items()]


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report it, print no result
        traceback.print_exc()
        print("FAIL see traceback on stderr", flush=True)
        sys.exit(1)
