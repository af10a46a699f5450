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
4. the d=1 sort-join kernels d1_keygen (its count and pack pass, which
   packs the code arena into ragged rows, and its emit pass), d1_join
   and d1_verify against their plain versions on the card, exactly
   (packed words, keys and flags element for element, candidate pairs
   in the kernel's order), on rows at the edges of the kernels, on one
   run of 125 rows sharing a key, on rows of mixed lengths at the edges
   of the ragged layout (1 to 5,003 nt), and on the d1_1m and
   d1_mixed_1m corpora, which are also timed: each kernel's passes, the
   pack with its bound, torch.sort of the keys (the sort phase), the
   plain versions, and the arena's copy to the card from pageable and
   from pinned memory;
5. main paths through swarm_tpu_torch.main.run, each with a warm-up
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
     sort-join engine on ragged rows, kernels d1_keygen, d1_join and
     d1_verify.

The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Needs one CUDA device, nvcc and a C
compiler. Imports no JAX.

To compare two versions of the port on one card, run each in turns:

    python3 chip_smoke.py --quick [--tree OTHER_CHECKOUT]

runs only the timed kernel phases (2, 3 and 4 at their timed shapes) and
the d2_100k, d2_device, d2_wide, d1_1m and d1_mixed_1m main paths of the
package under OTHER_CHECKOUT
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
OPS_PER_VERIFY_WORD = 12


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
    launch_floor_ms = cuda_ms(lambda: busy(iters=0, blocks=1), 200, busy)
    say(f"launch floor: an empty kernel (1 block, 0 steps of csrc/probe.cu) "
        f"launch_floor_ms={launch_floor_ms:.5f}")

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
        "launch_floor_ms": launch_floor_ms}

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
    """d1_keygen (its count and pack pass, then its emit pass), d1_join
    and d1_verify against their plain versions on the same card tensors;
    returns the max_abs_err of each and the pipeline's tensors."""
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
    skeys, sowners = _sorted_keys(keys, owners)
    cand = sj.join_pairs(skeys, sowners)
    e_join = max(err(cand, sj.join_pairs_reference(skeys, sowners)),
                 err(sj.join_count(skeys, sowners), torch.bincount(
                     sj._join_links(skeys, sowners)[0],
                     minlength=skeys.numel())))
    uniq = _dedup(cand)
    ok = sj.verify_pairs(words, row_word, lengths, uniq)
    e_verify = err(ok, sj.verify_ragged_reference(words, row_word, lengths,
                                                  uniq))
    torch.cuda.synchronize()
    say(f"kernels d1 {name}: rows={lengths.numel()} lengths="
        f"{int(lengths.min())}..{int(lengths.max())} words={n_words} "
        f"keys={keys.numel()} candidates={cand.numel()} "
        f"unique={uniq.numel()} at_distance_1={int(ok.sum())} "
        f"max_abs_err keygen={e_keygen} join={e_join} verify={e_verify}")
    if e_keygen or e_join or e_verify:
        raise AssertionError(f"a d=1 kernel disagrees with its plain version "
                             f"on {name}")
    if not ok.any():
        raise AssertionError(f"{name}: no pair at distance 1 to verify")
    return {"d1_keygen": e_keygen, "d1_join": e_join, "d1_verify": e_verify}, \
        (words, ends, keys, owners, skeys, sowners, cand, uniq, ok)


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
    errs, (words, ends, keys, owners, skeys, sowners, cand, uniq, ok) = \
        d1_check(name, rows)

    n_keys = keys.numel()
    sort_ms = cuda_ms(lambda: _sorted_keys(keys, owners), 3)
    say(f"sort phase {name}: torch.sort of {n_keys} int64 keys and the "
        f"owners taken through its indices: sort_ms={sort_ms:.3f}")
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
    result = {"d1_keygen": {
        "max_abs_err": errs["d1_keygen"], "ms": count_ms + emit_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "count_pack_ms": count_ms, "emit_ms": emit_ms,
        "pack_bound_ms": pack_bound_ms, "pack_plain_ms": pack_plain_ms}}

    jcounts = sj.join_count(skeys, sowners)
    jends = torch.cumsum(jcounts, dim=0, dtype=torch.int64)
    n_cand = cand.numel()
    count_ms = cuda_ms(lambda: sj.join_count(skeys, sowners), 10)
    emit_ms = cuda_ms(lambda: sj.join_emit(skeys, sowners, jends, n_cand), 10)
    plain_ms = cuda_ms(lambda: sj.join_pairs_reference(skeys, sowners), 1)
    n_bytes = n_keys * 12 + n_cand * 8
    n_ops = OPS_PER_JOIN_ELEMENT * n_keys
    bound_ms, bound_by = bound(n_bytes, n_ops)
    say(f"kernel d1_join timed {name}: keys={n_keys} candidates={n_cand} "
        f"count_ms={count_ms:.4f} emit_ms={emit_ms:.4f} "
        f"kernel_ms={count_ms + emit_ms:.4f} plain_ms={plain_ms:.3f} "
        f"bytes={n_bytes} ops={n_ops} bound_ms={bound_ms:.4f} ({bound_by})")
    result["d1_join"] = {
        "max_abs_err": errs["d1_join"], "ms": count_ms + emit_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "count_ms": count_ms, "emit_ms": emit_ms,
        "sort_ms": sort_ms}
    del skeys, sowners

    dedup_ms = cuda_ms(lambda: _dedup(cand), 5)
    ms = cuda_ms(lambda: sj.verify_pairs(words, row_word, lengths, uniq), 10)
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
        f"at_distance_1={int(ok.sum())} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} dedup_ms={dedup_ms:.3f} bytes={n_bytes} "
        f"ops={n_ops} bound_ms={bound_ms:.4f} ({bound_by})")
    result["d1_verify"] = {
        "max_abs_err": errs["d1_verify"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
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
    from swarm_tpu_torch.ops import d2_diffs, neighbors_sortjoin, nw_scores

    return {"d2_diffs": d2_diffs.launches, **nw_scores.launches,
            **neighbors_sortjoin.launches}


def reset_kernel_counts():
    from swarm_tpu_torch.ops import d2_diffs, neighbors_sortjoin, nw_scores

    d2_diffs.launches = 0
    for counts in (nw_scores.launches, neighbors_sortjoin.launches):
        for name in counts:
            counts[name] = 0


def phase_main_path(name, fasta, flags, work, env, kernels, native_env):
    """Warm-up run, then one timed run through the port with the
    variables of `env` set and every kernel's launch count set to 0
    before it and read after it; then the native engine's run (under
    `native_env`), whose files the port's must equal byte for byte.
    Returns the timed run's launch counts of `kernels`, its seconds, the
    native engine's, and its [timing] lines."""
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
    for kernel in kernels:
        if counts[kernel] < 1:
            raise AssertionError(f"{name}: kernel {kernel} never launched")
    native_s, _ = run_cli(argv, work / f"{name}_native", native_env)

    say(f"main path {name}: n={n} engine={engine or 'auto'} "
        f"flags={' '.join(flags)} warmup_s={warm_s:.3f} warm_s={sec:.3f} "
        f"native_engine_s={native_s:.3f} launches={counts} "
        f"comparisons={comparisons} device_peak_bytes={peak}")
    if engine == "device":
        say(f"main path {name}: target lists that took the device="
            f"{comparisons.get('d2_device_batches')} stayed under "
            f"MIN_DEVICE_BATCH={comparisons.get('d2_host_batches')}")
    for ln in timing:
        say(f"  {name} {ln}")
    for out in outputs:
        a = (work / f"{name}_torch" / out).read_bytes()
        b = (work / f"{name}_native" / out).read_bytes()
        if a != b or not a:
            raise AssertionError(f"{name}: {out} differs from the native "
                                 f"engine's ({len(a)} vs {len(b)} bytes)")
    say(f"main path {name}: {len(outputs)} output files byte-identical "
        f"to the native engine")
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
D1_KERNELS = ("d1_keygen", "d1_join", "d1_verify")

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


QUICK_PATHS = ("d2_100k", "d2_device", "d2_wide", "d1_1m", "d1_mixed_1m")


def run_quick(dev, work):
    """The timed kernel phases and the QUICK_PATHS main paths."""
    corpus = make_corpora(work, QUICK_PATHS)
    rows = {"d2_diffs": phase_d2_diffs_at_scale(dev, corpus["d2_100k"])}
    rows.update(phase_nw_scores(dev, corpus["d2_device"]))
    rows.update(phase_d1_kernels(dev, corpus, edges=False))
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

    launches = {}
    for name in MAIN_PATHS:
        ran = run_main_path(name, corpus, work)
        for kernel, count in ran["launches"].items():
            launches.setdefault(kernel, count)  # the first path's count

    d1 = "swarm_tpu_torch/csrc/d1_join.cu"
    static = {
        "d2_diffs": ("swarm_tpu_torch/csrc/d2_diffs.cu",
                     "swarm_tpu/ops/pallas_d2_diffs.py:191"),
        "banded_scores": ("swarm_tpu_torch/csrc/nw_scores.cu",
                          "swarm_tpu/ops/pallas_nw.py:410"),
        "full_scores": ("swarm_tpu_torch/csrc/nw_scores.cu",
                        "swarm_tpu/ops/pallas_nw.py:240"),
        # the d=1 path's device work was XLA programs, not Pallas kernels
        "d1_keygen": (d1, "swarm_tpu/ops/neighbors_sortjoin.py:142"),
        "d1_join": (d1, "swarm_tpu/ops/neighbors_sortjoin.py:416"),
        "d1_verify": (d1, "swarm_tpu/ops/neighbors_sortjoin.py:337"),
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
