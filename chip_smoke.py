#!/usr/bin/env python3
"""The kernel clock and the main-path pass of swarm_tpu_torch on one
NVIDIA card.

    python3 chip_smoke.py [--tree CHECKOUT]    (from the root of a checkout)

Builds the native host library and the CUDA kernels of CHECKOUT's
swarm_tpu_torch (default: this checkout's) with ptxas' report, measures
the card's rate of int32 adds and mins (csrc/probe.cu), then times each
hand-written kernel at the shapes of PERF.md's kernel table, beside its
bound (bytes over the memory rate or operations over the peak rate, the
larger), its plain PyTorch version and, where one PyTorch call computes
the same, that call. At each timed shape the timed output is checked
once against its plain version, exactly: a time for a wrong result is
no reading. Then the main-path pass runs each of MAIN_PATHS once
through the CLI on the card, its kernels' launches counted from 0 (the
kernel table's `launches`), and drives the paths around them: the
sharded engines over four in-process shards, a one-rank NCCL group, the
resident server and the dispatch rules at their thresholds; it prints
what each run launched and how long it took. Every check of the kernels
and the engines on the card other than the timed shapes' (edge cases,
each run of the main-path pass against the native engine or the
single-device run, by the same functions) is a test:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

The timed shapes, on corpora made from MAIN_PATHS:
- d2_diffs: 2^20 directed tasks from the d2_100k corpus' candidate
  pairs;
- banded_scores and full_scores: one seed of the d2_device corpus
  against 4,096 targets (banded: the list, one in-band target, and the
  list 64 times over, queued behind a busy kernel so that the host's
  enqueue time is not in the reading, beside an empty kernel's launch);
- d2_screen and d2_extract: the d2_100k and d2_long corpora and the
  first D1_1M_SCREEN_STEPS tile pairs of d1_1m's at d = 2, the screen
  bounded by the int8 tensor cores over the pairs within d in length
  (pairs_within of swarmbench/metrics/d2_screen.roofline_pct.py, as
  the benchmark's d2_screen.roofline_pct counts them), the extraction
  also on the dense words of two tiles of one repeated profile;
- d2_csr and d2_tasks: synthetic tasks and pairs in the screen's order
  at the benchmark cells' edge and pair counts (CSR_TIMED,
  TASKS_TIMED);
- d1_keygen, d1_partition, d1_join, d1_verify: the d1_1m and
  d1_mixed_1m corpora, with the arena's copy to the card;
- graft_keygen, graft_join, graft_verify: the sides a `-d 1 -f` run of
  d1_fastidious_200k and d1_fastidious_asym_200k hands the graft
  engine; graft_join also on skewed buckets (SKEWED_JOIN) and on random
  sides at the asymmetric corpus' scale (RANDOM_JOIN).

Any failure exits 1 before the last line, which is the kernel table as
one JSON object {"kernels": [...], "card", "tree", "device"}. Needs one
CUDA device, nvcc and a C compiler. Imports no JAX.
"""

import argparse
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent

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
#: the d>=2 screen's bounds: the same dot as int8 products on the tensor
#: cores (2 * 1024 operations a pair) at the data sheet's dense int8
#: rate; and, for the kernel's own arithmetic, 32-bit popcounts at 16 a
#: clock an SM (NVIDIA's arithmetic-instruction throughput for compute
#: capability 9.0) on 132 SMs at the 1.98 GHz boost clock
PEAK_INT8_TC_OPS_PER_S = 1.979e15
PEAK_POPC_PER_S = 16 * 132 * 1.98e9
#: the steps of the d>=2 screen on the d1_1m corpus: one chunk of the
#: engine's (SWARM_TPU_D2_CHUNK), the n^2 regime at 1M amplicons
D1_1M_SCREEN_STEPS = 512

#: nvcc's messages of the kernel build (-Xptxas -v), set by main()
BUILD_LOG = ""


def ptxas_report(kernel):
    """{registers, spill_stores, spill_loads} of the kernel whose mangled
    name holds `kernel`, from ptxas' report in BUILD_LOG."""
    lines = BUILD_LOG.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            out = {}
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", nxt)
                if m:
                    out["spill_stores"] = int(m.group(1))
                    out["spill_loads"] = int(m.group(2))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    out["registers"] = int(m.group(1))
                    break
            return out
    raise AssertionError(f"no ptxas report of {kernel} in the build log")


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
    """banded_scores and full_scores on one seed of the dense-cloud corpus
    and 4,096 targets at the default scores (d = 2: B = 4), checked
    against their plain versions (and the banded scores against the
    full-row kernel under the screen's contract: equal where <= cutoff,
    both above it elsewhere), then timed; returns the two kernels' rows
    of numbers."""
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

    mm, go, ge, B = 18, 24, 13, 4  # default scores at d = 2
    full = nw_scores.full_scores(al.padded, al.lengths, seed_id, ids, mm, go,
                                 ge)
    full_plain = nw_scores.nw_scores_reference(al.padded, al.lengths, seed_id,
                                               ids, mm, go, ge)
    got = nw_scores.banded_scores(al.padded, al.lengths, seed_id, ids, mm, go,
                                  ge, B)
    want = nw_scores.banded_scores_reference(qrows, rows, qlens, lens, mm, go,
                                             ge, B)
    torch.cuda.synchronize()
    worst_full = int((full.long() - full_plain.long()).abs().max())
    worst_band = int((got.long() - want.long()).abs().max())
    cutoff = go + B * ge - 1  # the largest cutoff B is enough for
    inside = full <= cutoff
    ok = bool((got[inside] == full[inside]).all()) and bool(
        (got[~inside] > cutoff).all())
    say(f"kernels full_scores, banded_scores scores={(mm, go, ge)} B={B} "
        f"targets={nb} qlen={ql} within_cutoff={int(inside.sum())} "
        f"max_abs_err full={worst_full} banded={worst_band} "
        f"contract_vs_full_row={ok}")
    if worst_full or worst_band:
        raise AssertionError("a score kernel disagrees with its plain "
                             "version")
    if not ok:
        raise AssertionError("banded_scores breaks its contract against the "
                             "full-row kernel")

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
    ms = cuda_ms(lambda: banded(ids), 20, busy)
    one_id = ids[in_band][:1]
    chain_ms = cuda_ms(lambda: banded(one_id), 20, busy)
    many_ids = ids.repeat(64)
    err = int((banded(many_ids).long() - got.repeat(64).long()).abs().max())
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
    result = {"banded_scores": {
        "max_abs_err": worst_band, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "chain_ms": chain_ms, "saturated_ms": saturated_ms,
        "saturated_bound_ms": saturated_bound_ms,
        "launch_floor_ms": floor_ms}}

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


def phase_d1_kernels(dev, corpus):
    """The d=1 kernels against their plain versions and timed on the
    d1_1m and d1_mixed_1m corpora; returns the four kernels' rows (d1_1m's,
    with d1_mixed_1m's beside them under "d1_mixed_1m")."""
    result, h2d = d1_timed("d1_1m", corpus["d1_1m"], dev)
    mixed, mixed_h2d = d1_timed("d1_mixed_1m", corpus["d1_mixed_1m"], dev)
    for kernel, row in result.items():
        row["max_abs_err"] = max(row["max_abs_err"],
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


def graft_check(name, db, heavy, light, dev):
    """graft_keygen (count and emit, both sides), graft_join (the sides
    partitioned by d1_partition into the same buckets; counts, records,
    pairs, both sides unwritten) and graft_verify (flags and each light
    row's smallest heavy one, on the join's pairs) against their plain
    versions on the same card tensors; returns the max_abs_err of each
    and the tensors. The side of fewer keys is the small one, as the
    engine takes it."""
    import numpy as np
    import torch

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
    small_is_heavy = (7 * lens[heavy] + 4).sum() <= (7 * lens[light] + 4).sum()
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
    best = torch.full((len(db),), 2**31 - 1, dtype=torch.int32, device=dev)
    want_best = best.clone()
    ok = ft.verify(words, row_word, lengths, s_ids, s_ends, b_ids, b_ends,
                   pairs, small_is_heavy, best)
    want_ok = ft.verify_reference(words, row_word, lengths, s_ids, s_ends,
                                  b_ids, b_ends, pairs)
    ft.best_reference(s_ids, s_ends, b_ids, b_ends, pairs[want_ok],
                      small_is_heavy, want_best)
    e_verify = max(err(ok, want_ok), err(best, want_best))
    torch.cuda.synchronize()
    sizes = torch.diff(s_buckets, prepend=s_buckets.new_zeros(1))
    say(f"kernels graft {name}: rows={len(db)} heavy={len(heavy)} "
        f"light={len(light)} small_side={'heavy' if small_is_heavy else 'light'}"
        f" keys={skeys.numel()}+{bkeys.numel()} bucket_bits={bits} "
        f"largest_small_bucket={int(sizes.max()) if sizes.numel() else 0} "
        f"empty_small_buckets={int((sizes == 0).sum())} "
        f"pairs={pairs.numel()} verified={int(ok.sum())} max_abs_err "
        f"keygen={e_keygen} join={e_join} verify={e_verify}")
    if e_keygen or e_join or e_verify:
        raise AssertionError(f"a graft kernel disagrees with its plain "
                             f"version on {name}")
    return {"graft_keygen": e_keygen, "graft_join": e_join,
            "graft_verify": e_verify}, (words, row_word, lengths, zob,
                                        small_is_heavy, sides, skeys, spays,
                                        s_buckets, bkeys, bpays, b_buckets,
                                        pairs, ok)


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
    engine, by one run of the main path's flags in `work`/NAME_sides."""
    from swarm_tpu_torch.ops import fastidious_torch as ft

    seen = []
    real = ft.GraftEngine.graft_candidates

    def capture(self, heavy, light):
        seen.append((self.db, heavy, light))
        return real(self, heavy, light)

    ft.GraftEngine.graft_candidates = capture
    try:
        run_path(MAIN_PATHS[name][2], fasta, work / f"{name}_sides")
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


def phase_graft_kernels(dev, corpus, work):
    """The graft kernels against their plain versions and timed on the
    sides the two fastidious corpora's runs hand the engine, then
    graft_join on skewed buckets and on random sides; returns the three
    kernels' rows (d1_fastidious_200k's, with the asymmetric corpus' and
    the join's other shapes beside them)."""
    result = graft_timed("d1_fastidious_200k", corpus["d1_fastidious_200k"],
                         dev, work)
    asym = graft_timed("d1_fastidious_asym_200k",
                       corpus["d1_fastidious_asym_200k"], dev, work)
    for kernel, row in result.items():
        row["max_abs_err"] = max(row["max_abs_err"],
                                 asym[kernel]["max_abs_err"])
        row["d1_fastidious_asym_200k"] = asym[kernel]
    result["graft_join"]["skewed_buckets"] = graft_join_skewed(dev)
    result["graft_join"]["random_sides"] = graft_join_random(dev)
    return result


def _screen_check(name, eng, steps=None):
    """The screen kernels against their plain versions on the engine's
    steps (the first `steps` of them, or all): words and row counts
    element for element, the pairs in order. Returns (tis, tjs, words,
    counts, reference words, pairs)."""
    import numpy as np
    import torch

    from swarm_tpu_torch.ops import d2_network as d2n

    T, dev = eng.TILE, eng.device
    tis, tjs = (torch.from_numpy(t[:steps]).to(dev)
                for t in d2n.tile_steps(eng.n_pad // T))
    words, counts = d2n.screen_words(eng.prof, eng.lengths, tis, tjs, T,
                                     eng.n, eng.d)
    ga, gb = d2n.extract_pairs(words, counts, tis, tjs, T)
    want = d2n.screen_words_reference(eng.prof, eng.lengths, tis, tjs, T,
                                      eng.n, eng.d)
    torch.cuda.synchronize()
    if not torch.equal(words, want):
        raise AssertionError(f"d2_screen {name}: words differ from the "
                             f"plain version's")
    if not torch.equal(counts, d2n.row_counts_reference(want, T)):
        raise AssertionError(f"d2_screen {name}: row counts differ")
    pa, pb = d2n.extract_pairs_reference(want, tis, tjs, T)
    if not (torch.equal(ga, pa) and torch.equal(gb, pb)):
        raise AssertionError(f"d2_extract {name}: pairs differ from the "
                             f"plain version's, or their order")
    lens = eng.lengths.cpu().numpy()
    apart = int((np.abs(lens[pa.cpu().numpy()] - lens[pb.cpu().numpy()])
                 == eng.d).sum())
    say(f"kernel d2_screen/d2_extract {name}: n={eng.n} T={T} d={eng.d} "
        f"steps={len(tis)} pairs={len(pa)} (lengths d apart: {apart}) exact")
    return tis, tjs, words, counts, want, (pa, pb)


@functools.cache
def pairs_within():
    """pairs_within(lengths, d) of the benchmark's reader of
    d2_screen.roofline_pct (swarmbench/metrics/, loaded by its path):
    the unordered pairs of rows whose lengths differ by at most d, the
    screen's work as the benchmark counts it."""
    import importlib.util

    path = REPO / "swarmbench" / "metrics" / "d2_screen.roofline_pct.py"
    spec = importlib.util.spec_from_file_location("d2_screen_roofline_pct",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.pairs_within


def screen_pairs(lengths, n, T, steps, d):
    """pairs_within over the tile pairs `steps` of a screen over n rows
    at tile T: a diagonal step's pairs within its tile, an off-diagonal
    step's across its two tiles. Over every step of a run it is the
    corpus' count."""
    import torch

    within = pairs_within()
    tiles = {}

    def tile(i):
        if i not in tiles:
            rows = lengths[i * T:min(n, (i + 1) * T)]
            tiles[i] = (rows, within(rows, d))
        return tiles[i]

    total = 0.0
    for i, j in steps:
        a, within_a = tile(i)
        if i == j:
            total += within_a
        else:
            b, within_b = tile(j)
            total += within(torch.cat([a, b]), d) - within_a - within_b
    return total


def screen_timed(name, fasta, dev, busy, steps=None):
    """The screen kernels on a main path's corpus at the engine's tile
    (d = 2; its first `steps` tile pairs, or all), checked, then timed;
    returns the two kernels' rows."""
    import torch

    from swarm_tpu_torch.corpora import read_db
    from swarm_tpu_torch.ops import d2_network as d2n
    from swarm_tpu_torch.ops.d2_network import D2NetworkEngine

    eng = D2NetworkEngine(read_db(fasta), 2, dev)
    T, d = eng.TILE, eng.d
    tis, tjs, words, counts, want, (pa, _) = _screen_check(name, eng,
                                                           steps=steps)
    K = len(tis)
    incl = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(incl[-1])
    offsets = incl - counts
    screen_ms = cuda_ms(lambda: d2n.screen_words(
        eng.prof, eng.lengths, tis, tjs, T, eng.n, d), 5)
    extract_ms = cuda_ms(lambda: d2n.extract_scanned(
        words, counts, offsets, tis, tjs, T, total), 20, busy)
    wrapper_ms = cuda_ms(lambda: d2n.extract_pairs(
        words, counts, tis, tjs, T), 10)
    plain_screen_ms = cuda_ms(lambda: d2n.screen_words_reference(
        eng.prof, eng.lengths, tis, tjs, T, eng.n, d), 1)
    plain_extract_ms = cuda_ms(lambda: d2n.extract_pairs_reference(
        want, tis, tjs, T), 1)
    # the library yardstick of the dot: torch._int_mm of the same +-1
    # int8 tiles, which the plain version (and JAX) multiply
    pm1 = d2n._unpack_pm1(eng.prof)
    steps = list(zip(tis.tolist(), tjs.tolist()))

    def int_mm():  # each product dropped at once: one step's 64 MB live
        for i, j in steps:
            torch._int_mm(pm1[i * T:(i + 1) * T], pm1[j * T:(j + 1) * T].t())

    int_mm_ms = cuda_ms(int_mm, 2)
    del pm1
    # the work: pairs within d in length, counted as the benchmark's
    # d2_screen.roofline_pct counts them
    within = screen_pairs(eng.lengths, eng.n, T, steps, d)
    pairs_all = K * T * T
    tc_ops = 2 * d2n.PROFILE_BITS * within
    n_bytes = eng.n_pad * (128 + 4) + K * T * T // 8 + K * T * 4
    t_tc = tc_ops / PEAK_INT8_TC_OPS_PER_S * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms, bound_by = max(t_tc, t_bytes), \
        "operations" if t_tc >= t_bytes else "bytes"
    # the popcount form's own bound (the XOR-popcount screen before the
    # tensor cores): 32 POPC a pair that passes the cheap tests
    # (triangle, padding, lengths), which are the pairs within d
    popc_ms = within * (d2n.PROFILE_BITS // 32) / PEAK_POPC_PER_S * 1e3
    rows_hit = int((counts > 0).sum())
    ex_bytes = K * T * 4 + rows_hit * (T // 8) + 8 * total
    ex_bound_ms, ex_bound_by = bound(ex_bytes, 0)
    regs = {k: ptxas_report(f"{k}_kernel") for k in ("d2_screen",
                                                     "d2_extract")}
    say(f"kernel d2_screen {name}: steps={K} T={T} pairs={pairs_all} "
        f"(within d in length: {within:.0f}) survivors={total} kernel_ms="
        f"{screen_ms:.4f} plain_ms={plain_screen_ms:.3f} int_mm_ms="
        f"{int_mm_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}: int8 tensor "
        f"cores, {tc_ops} operations; bytes {n_bytes}: {t_bytes:.4f} ms) "
        f"tensor_core_share={bound_ms / screen_ms:.3f} popcount_bound_ms="
        f"{popc_ms:.4f} ({within:.0f} pairs x 32 POPC at "
        f"{PEAK_POPC_PER_S:.3e}/s) ptxas={regs['d2_screen']}")
    say(f"kernel d2_extract {name}: rows with survivors={rows_hit} of "
        f"{K * T} pairs={total} alone_ms={extract_ms:.4f} wrapper_ms="
        f"{wrapper_ms:.4f} (scan, readback, launch) plain_ms="
        f"{plain_extract_ms:.3f} bytes={ex_bytes} bound_ms="
        f"{ex_bound_ms:.4f} ({ex_bound_by}) share="
        f"{ex_bound_ms / extract_ms:.3f} ptxas={regs['d2_extract']}")
    if len(pa) != total:
        raise AssertionError(f"d2_extract {name}: {len(pa)} pairs against "
                             f"a total of {total}")
    return ({"max_abs_err": 0, "ms": screen_ms, "plain_ms": plain_screen_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": int_mm_ms, "popcount_bound_ms": popc_ms,
             "tensor_core_share": bound_ms / screen_ms,
             "ptxas": regs["d2_screen"], "steps": K, "pairs_within": within,
             "survivors": total},
            {"max_abs_err": 0, "ms": extract_ms, "wrapper_ms": wrapper_ms,
             "plain_ms": plain_extract_ms, "bound_ms": ex_bound_ms,
             "bound_by": ex_bound_by, "library_ms": None,
             "ptxas": regs["d2_extract"], "pairs": total})


def extract_dense(dev, busy):
    """d2_extract on the densest words: two tiles of one repeated profile
    (T = 4096, n = 8,192, d = 2: every pair survives, rows of up to 4,096
    pairs, 33,550,336 in all, so every pass is staged), the screen's
    words and counts and the pairs checked against the plain versions,
    then the extraction timed alone behind the busy kernel. Returns its
    row."""
    import numpy as np
    import torch

    from swarm_tpu_torch.ops import d2_network as d2n

    T, n = 4096, 8192
    row = torch.from_numpy(np.random.default_rng(132).integers(
        0, 256, 128, dtype=np.uint8))
    prof = row.repeat(n, 1).to(dev)
    lengths = torch.full((n,), 150, dtype=torch.int32, device=dev)
    tis, tjs = (torch.from_numpy(t).to(dev) for t in d2n.tile_steps(2))
    words, counts = d2n.screen_words(prof, lengths, tis, tjs, T, n, 2)
    want = d2n.screen_words_reference(prof, lengths, tis, tjs, T, n, 2)
    incl = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(incl[-1])
    offsets = incl - counts
    ga, gb = d2n.extract_scanned(words, counts, offsets, tis, tjs, T, total)
    pa, pb = d2n.extract_pairs_reference(want, tis, tjs, T)
    if not (torch.equal(words, want) and torch.equal(ga, pa)
            and torch.equal(gb, pb)) or total != n * (n - 1) // 2:
        raise AssertionError("d2_screen/d2_extract dense: differ from the "
                             "plain versions")
    ms = cuda_ms(lambda: d2n.extract_scanned(
        words, counts, offsets, tis, tjs, T, total), 20, busy)
    rows_hit = int((counts > 0).sum())
    n_bytes = len(tis) * T * 4 + rows_hit * (T // 8) + 8 * total
    bound_ms, bound_by = bound(n_bytes, 0)
    say(f"kernel d2_extract dense: steps={len(tis)} T={T} rows with "
        f"survivors={rows_hit} pairs={total} exact alone_ms={ms:.4f} "
        f"bytes={n_bytes} bound_ms={bound_ms:.4f} ({bound_by})")
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "pairs": total}


def phase_d2_screen(dev, corpus):
    """d2_screen and d2_extract on the d2_100k and d2_long corpora at
    T = 4096 and on the first chunk (D1_1M_SCREEN_STEPS steps) of the
    d1_1m corpus at d = 2, each checked and timed there, and the
    extraction on dense words (extract_dense). Returns the kernels' rows
    (d2_100k's, with the others beside them under "d2_long",
    "d1_1m_chunk" and "dense")."""
    import torch

    busy = busy_kernel(dev)
    screen, extract = screen_timed("d2_100k", corpus["d2_100k"], dev, busy)
    if "d2_long" in corpus:
        screen["d2_long"], extract["d2_long"] = screen_timed(
            "d2_long", corpus["d2_long"], dev, busy)
    if "d1_1m" in corpus:
        screen["d1_1m_chunk"], extract["d1_1m_chunk"] = screen_timed(
            "d1_1m_chunk", corpus["d1_1m"], dev, busy,
            steps=D1_1M_SCREEN_STEPS)
    extract["dense"] = extract_dense(dev, busy)
    # the phase's cached blocks (the chunks' words, the plain versions'
    # tiles) back to the card
    torch.cuda.empty_cache()
    return {"d2_screen": screen, "d2_extract": extract}


#: the CSR partition's timed inputs: (n, cloud) of screen_order_tasks
#: giving about the benchmark cells' directed edges (3.4e7 at 500,000
#: amplicons, d = 2; 3.9e7 at 300,000, d = 3); the tasks are synthetic
#: clouds in the screen's order, not the cells' own
CSR_TIMED = {"d2_150nt_500k": (500_000, 103), "d3_253nt_300k": (300_000, 195)}


def csr_bytes(n_tasks, kept, n):
    """Bytes the CSR partition's function needs: every task's int64
    source and target and int32 diff read once, every kept task's int32
    target and byte diff and the n + 1 int32 starts written once."""
    return 20 * n_tasks + 5 * kept + 4 * (n + 1)


def csr_readback_ms(got, reps=3):
    """Host-clock milliseconds of the engine's readback of the CSR
    (d2_network.csr_to_host), the first call's and the median of `reps`
    more."""
    import numpy as np
    import torch

    from swarm_tpu_torch.ops.d2_network import csr_to_host

    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        csr_to_host(*got[:3])
        times.append((time.perf_counter() - t0) * 1e3)
    return {"first": times[0], "median": float(np.median(times[1:]))}


def phase_d2_csr(dev):
    """d2_csr (the network engine's CSR partition) at the cells' edge
    counts (CSR_TIMED), against its plain version on the card, exactly
    (starts, targets, diffs, the check's flag), then timed there: the
    wrapper's launches (CUDA events around whole calls), its bound (the
    bytes its function needs over the memory rate), the plain version on
    the card, torch.sort of the same composite key (source << 32 |
    target) with the take of the diffs (library_ms, which the port never
    calls), the engine's readback (csr_readback_ms), and the peak of
    device memory. Returns {"d2_csr": row}."""
    import torch

    from swarm_tpu_torch.corpora import screen_order_tasks
    from swarm_tpu_torch.ops import d2_network as d2n

    def on(tasks, n):
        return d2n.csr_partition(*(torch.from_numpy(x).to(dev)
                                   for x in tasks), n)

    def check(name, tasks, n):
        got = on(tasks, n)
        src, dst, diffs = (torch.from_numpy(x).to(dev) for x in tasks)
        want = d2n.csr_partition_reference(src, dst, diffs, n)
        if int(want[3]) or int(got[3]):
            raise AssertionError(f"d2_csr {name}: the check flagged tasks "
                                 f"in the screen's order")
        for x, y in zip(got, want):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"d2_csr {name}: differs from the "
                                     f"plain version")
        return got

    row = {"max_abs_err": 0}
    for i, (cell, (n, cloud)) in enumerate(CSR_TIMED.items()):
        t0 = time.perf_counter()
        tasks = screen_order_tasks(n, cloud, 22 + i)
        made_s = time.perf_counter() - t0
        got = check(cell, tasks, n)
        kept = got[1].numel()
        src, dst, diffs = (torch.from_numpy(x).to(dev) for x in tasks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = d2n.launches["d2_csr"]
        ms = cuda_ms(lambda: d2n.csr_partition(src, dst, diffs, n), 5)
        launches = (d2n.launches["d2_csr"] - before) // 6
        peak = torch.cuda.max_memory_allocated() - base
        plain_ms = cuda_ms(
            lambda: d2n.csr_partition_reference(src, dst, diffs, n), 2)
        keep = diffs >= 0
        keys = (src[keep] << 32) | dst[keep]
        kept_diffs = diffs[keep]

        def library():
            order = torch.sort(keys).indices
            return torch.take(kept_diffs, order)

        library_ms = cuda_ms(library, 3)
        needed = csr_bytes(len(tasks[0]), kept, n)
        bound_ms = needed / PEAK_BYTES_PER_S * 1e3
        readback = csr_readback_ms(got)
        entry = {
            "n": n, "tasks": len(tasks[0]), "kept": kept,
            "passes": len(d2n.csr_passes(n)), "launches": launches,
            "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "bytes_needed": needed, "roofline_pct": 100 * bound_ms / ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "readback_ms": readback, "device_peak_bytes": peak,
            "tasks_made_s": made_s}
        say(f"d2_csr {cell}-sized: {json.dumps(entry)}")
        if i == 0:
            row.update(entry)
            row["registers"] = {k: ptxas_report(k) for k in (
                "d2_csr_count_kernel", "d2_csr_scatter_kernel",
                "d2_csr_finish_kernel")}
        else:
            row[cell] = entry
        del src, dst, diffs, keys, kept_diffs, got
        torch.cuda.empty_cache()
    return {"d2_csr": row}


#: the task layout's timed inputs: (n, cloud) of screen_order_pairs
#: giving about the benchmark cells' candidate pairs (2.0e7 at 500,000
#: amplicons, d = 2; 2.4e7 at 300,000, d = 3); synthetic clouds in the
#: screen's order with abundances 1-3, not the cells' own
TASKS_TIMED = {"d2_150nt_500k": (500_000, 81),
               "d3_253nt_300k": (300_000, 161)}


def tasks_bytes(n_pairs, n_tasks, n):
    """Bytes the task layout's function needs: every pair's two int32
    ids and every amplicon's int64 abundance read once, every task's two
    int64 ids written once."""
    return 8 * n_pairs + 8 * n + 16 * n_tasks


def phase_d2_tasks(dev):
    """d2_tasks (the network engine's diff tasks laid out on the card from
    the screen's pairs) at the cells' pair counts (TASKS_TIMED), against
    its plain version on the card, exactly, with no_break off and on,
    then timed there: the wrapper (count, scan, the one readback, emit;
    CUDA events around whole calls), its bound (the bytes its function
    needs over the memory rate), the plain version on the card, and the
    host route it replaced (the pairs' copy to the host, directions and
    task_layout, the tasks' upload; host clock). Returns
    {"d2_tasks": row}."""
    import numpy as np
    import torch

    from swarm_tpu_torch.corpora import screen_order_pairs
    from swarm_tpu_torch.ops import d2_diffs
    from swarm_tpu_torch.ops import d2_network as d2n

    def check(name, ga, gb, ab, n):
        """Both layouts equal the plain version's; returns the abundance
        rule's (no_break off)."""
        for no_break in (True, False):
            got = d2n.d2_tasks(ga, gb, ab, n, no_break)
            want = d2n.tasks_reference(ga, gb, ab, n, no_break)
            torch.cuda.synchronize()
            if got[2] or want[2]:
                raise AssertionError(f"d2_tasks {name}: flagged pairs in "
                                     f"order")
            for x, y in zip(got[:2], want[:2]):
                if x.dtype != y.dtype or not torch.equal(x, y):
                    raise AssertionError(f"d2_tasks {name} (no_break "
                                         f"{no_break}): differs from the "
                                         f"plain version")
        return got

    row = {"max_abs_err": 0}
    for i, (cell, (n, cloud)) in enumerate(TASKS_TIMED.items()):
        t0 = time.perf_counter()
        pa, pb, ab = screen_order_pairs(n, cloud, 24 + i)
        made_s = time.perf_counter() - t0
        ga, gb = (torch.from_numpy(x.astype(np.int32)).to(dev)
                  for x in (pa, pb))
        abd = torch.from_numpy(ab).to(dev)
        tasks = check(cell, ga, gb, abd, n)[0].numel()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = d2n.launches["d2_tasks"]
        ms = cuda_ms(lambda: d2n.d2_tasks(ga, gb, abd, n, False), 5)
        launches = (d2n.launches["d2_tasks"] - before) // 6
        peak = torch.cuda.max_memory_allocated() - base
        plain_ms = cuda_ms(
            lambda: d2n.tasks_reference(ga, gb, abd, n, False), 2)

        def host_route():
            qa, qb = d2n.pairs_to_host(ga, gb, n)
            tq, td = d2_diffs.task_layout(
                qa, qb, *d2_diffs.directions(ab, qa, qb, False))
            out = (torch.from_numpy(tq).to(dev), torch.from_numpy(td).to(dev))
            torch.cuda.synchronize()
            return out

        host_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host_route()
            host_s.append(time.perf_counter() - t0)
        needed = tasks_bytes(len(pa), tasks, n)
        bound_ms = needed / PEAK_BYTES_PER_S * 1e3
        entry = {
            "n": n, "pairs": len(pa), "tasks": tasks, "launches": launches,
            "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "bytes_needed": needed, "roofline_pct": 100 * bound_ms / ms,
            "plain_ms": plain_ms, "library_ms": None,
            "host_route_ms": [1e3 * t for t in host_s],
            "device_peak_bytes": peak, "pairs_made_s": made_s}
        say(f"d2_tasks {cell}-sized: {json.dumps(entry)}")
        if i == 0:
            row.update(entry)
            row["registers"] = {k: ptxas_report(k) for k in (
                "d2_tasks_count_kernel", "d2_tasks_emit_kernel")}
        else:
            row[cell] = entry
        del ga, gb, abd
        torch.cuda.empty_cache()
    return {"d2_tasks": row}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=REPO,
                    help="checkout whose swarm_tpu_torch is timed")
    args = ap.parse_args()
    tree = args.tree.resolve()
    if not (tree / "swarm_tpu_torch").is_dir():
        say(f"FAIL swarm_tpu_torch not found in {tree}")
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
    global BUILD_LOG
    log = BUILD_LOG = _build.build(verbose=True)
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
        kernels = run_phases(dev, Path(tmp))
    say(json.dumps({"kernels": kernels, "card": card, "tree": str(tree),
                    "device": {"kind": device_name(),
                               "count": torch.cuda.device_count()}}))
    return 0


D2_NATIVE = {"SWARM_TPU_D2_ENGINE": "native"}
D1_NATIVE = {"SWARM_TPU_D1_NATIVE_MAX": str(1 << 40)}
D2_KERNELS = ("d2_screen", "d2_extract", "d2_diffs", "d2_csr",
              "d2_tasks")
D1_KERNELS = ("d1_keygen", "d1_partition", "d1_join", "d1_verify")
GRAFT_KERNELS = ("graft_keygen", "graft_join", "graft_verify")
#: the native engines of -d 1 -f: the d=1 network and the host graft join
GRAFT_NATIVE = {**D1_NATIVE, "SWARM_TPU_GRAFT_PROBE_MAX": str(1 << 40)}
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
#: bench.py's config 4 (d1_fastidious) and the writers
FASTIDIOUS_FLAGS = ["-d", "1", "-f", "-y", "12", "-o", "out.txt", "-s",
                    "stats.txt", "-i", "structure.txt"]

#: the main paths: name -> (corpus maker of swarm_tpu_torch.corpora, its
#: arguments, CLI flags, environment, the kernels the run launches, the
#: environment of the native engine). The timed phases read their corpora
#: and the -f paths' flags; the main-path pass runs each path once
#: (main_path), and tests/test_torch_cuda.py holds that run against the
#: native engine's
MAIN_PATHS = {
    "d2_100k": ("gen_corpus", {"n": 100_000, "length": 150},
                ["-d", "2", "-o", "out.txt", "-s", "stats.txt", "-u",
                 "uclust.txt", "-i", "structure.txt", "-w", "seeds.fasta"],
                {}, D2_KERNELS, D2_NATIVE),
    "d2_long": ("gen_corpus", {"n": 20_000, "length": 400},
                ["-d", "2", "-o", "out.txt", "-s", "stats.txt"],
                {}, D2_KERNELS, D2_NATIVE),
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


# ---- the main paths: each run once on the card, its kernels counted ----
#
# The runs below are the main-path pass of this script and the runs that
# tests/test_torch_cuda.py compares byte for byte with the native engine
# or the single-device run: this script records what they launch and
# how long they take, the tests what they write.

#: the main paths run again over SHARDS in-process shards on the card
SHARDED_PATHS = ("d1_1m", "d1_fastidious_200k", "d2_long")
SHARDS = 4
#: the main path run again as a one-rank NCCL group in a new process
NCCL_PATH = "d1_full_100k"
#: the main paths forwarded to the resident server, and the start of the
#: [timing] line that the server's stderr shows for the card's engine
SERVER_PATHS = {"d2_long": "[timing] d2 network (cuda)",
                "d1_1m": "[timing] d1 join (cuda)",
                "d1_fastidious_200k": "[timing] graft (cuda)"}
#: the CLI's dispatch rules: name -> (the main path on whose corpus' first
#: records the rule runs, its flags, the kernel whose launches show the
#: card's engine, the native engine's variables)
DISPATCH_PATHS = {
    "d1": ("d1_1m", ["-d", "1", "-o", "out.txt", "-s", "stats.txt"],
           "d1_keygen", D1_NATIVE),
    "d1f": ("d1_fastidious_200k",
            ["-d", "1", "-f", "-o", "out.txt", "-s", "stats.txt"],
            "d1_keygen", GRAFT_NATIVE),
    "d2": ("d2_100k", ["-d", "2", "-o", "out.txt", "-s", "stats.txt"],
           "d2_screen", D2_NATIVE),
}
#: the device diffs' rule runs on the candidate pairs of the first
#: DIFFS_RECORDS records of the d2_100k corpus
DIFFS_RECORDS = 2_000
#: the start of the line in which a run reports its kernels' launches
LAUNCHES = "[timing] launches "


def tree():
    """The checkout whose swarm_tpu_torch this process imported."""
    import swarm_tpu_torch

    return Path(swarm_tpu_torch.__file__).resolve().parent.parent


def launcher_env(**extra):
    """The environment of a new process of the port (bin/swarm-torch or
    the server): this one's, less a server to forward to and shards, with
    the imported checkout on PYTHONPATH."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("SWARM_TORCH_SERVER", "SWARM_TORCH_SHARDS")}
    return {**env, "PYTHONPATH": str(tree()), **extra}


def output_files(flags):
    """The files a run of `flags` writes (with its `-l log.txt`)."""
    return [flags[i + 1] for i in range(len(flags) - 1)
            if flags[i] in ("-o", "-s", "-u", "-i", "-w")] + ["log.txt"]


def reset_kernel_counts():
    """Every kernel wrapper's launch count set to 0."""
    from swarm_tpu_torch.ops import (
        d2_diffs, d2_network, fastidious_torch, neighbors_sortjoin,
        nw_scores)

    d2_diffs.launches = 0
    for counts in (d2_network.launches, nw_scores.launches,
                   neighbors_sortjoin.launches, fastidious_torch.launches):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def _inside(workdir, env):
    """In `workdir` (made here) with the variables of `env` set; both
    restored after."""
    workdir.mkdir(parents=True)
    back, saved = os.getcwd(), {k: os.environ.get(k) for k in env}
    os.chdir(workdir)
    os.environ.update(env)
    try:
        yield
    finally:
        os.chdir(back)
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def run_path(flags, fasta, workdir, env=None, device=None):
    """One CLI run of `flags` on `fasta` through swarm_tpu_torch.main.run
    in this process, in `workdir`, under the variables of `env` and
    SWARM_TPU_DB_CACHE=0 (each run reads its file, as a CLI process
    does), every kernel's launch count set to 0 just before it. Returns
    {"s": its seconds (host clock), "files": {name: path}, "launches":
    {kernel: its launches}, "counters": the run's counters, "spans":
    {name: seconds} of the run's closed spans}."""
    from swarm_tpu_torch import metrics
    from swarm_tpu_torch.main import launch_counts, run

    argv = flags + ["-l", "log.txt", str(fasta)]
    with _inside(workdir, {"SWARM_TPU_DB_CACHE": "0", **(env or {})}):
        reset_kernel_counts()
        t0 = time.perf_counter()
        rc = run(argv, "swarm", device=device)
        sec = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"run {argv} returned {rc}")
    closed = {s.name for s in metrics.spans if s.end is not None}
    return {"s": sec, "files": {f: workdir / f for f in output_files(flags)},
            "launches": launch_counts(), "counters": dict(metrics.last_run),
            "spans": {name: metrics.seconds(name) for name in closed}}


def launch_path(flags, fasta, workdir, env=None):
    """One run of `flags` on `fasta` by bin/swarm-torch in a new process,
    in `workdir`, under SWARM_TPU_TIMING=1 and the variables of `env`:
    {"s", "files", "launches" (its `[timing] launches` line; a new
    process counts from 0), "stderr" (its lines)}."""
    workdir.mkdir(parents=True)
    argv = flags + ["-l", "log.txt", str(fasta)]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, str(tree() / "bin" / "swarm-torch"), *argv],
        cwd=workdir, env=launcher_env(SWARM_TPU_TIMING="1", **(env or {})),
        capture_output=True, timeout=600)
    sec = time.perf_counter() - t0
    err = r.stderr.decode().splitlines()
    if r.returncode != 0:
        raise AssertionError(f"{argv} in a new process returned "
                             f"{r.returncode}:\n" + "\n".join(err[-30:]))
    counted = [json.loads(ln[len(LAUNCHES):]) for ln in err
               if ln.startswith(LAUNCHES)]
    if len(counted) != 1:
        raise AssertionError(f"{argv} in a new process reported its "
                             f"launches {len(counted)} times")
    return {"s": sec, "files": {f: workdir / f for f in output_files(flags)},
            "launches": counted[0], "stderr": err}


def main_path(name, corpus, work, device):
    """MAIN_PATHS[name] once through the CLI on the card (run_path)."""
    flags, env = MAIN_PATHS[name][2:4]
    return run_path(flags, corpus[name], work / f"{name}_card", env, device)


def sharded_path(name, corpus, work, device):
    """The same run over SHARDS in-process shards on the card."""
    flags, env = MAIN_PATHS[name][2:4]
    return run_path(flags, corpus[name], work / f"{name}_shards",
                    {**env, "SWARM_TORCH_SHARDS": str(SHARDS)}, device)


def sharded_pairs(corpus, device):
    """d2_100k's candidate pairs on one device, then over SHARDS
    in-process shards on it: both, the seconds of each and the screen's
    launches over the shards."""
    from swarm_tpu_torch.corpora import read_db
    from swarm_tpu_torch.ops import d2_network as d2n
    from swarm_tpu_torch.parallel.mesh import LocalShards

    eng = d2n.D2NetworkEngine(read_db(corpus["d2_100k"]), 2, device)
    t0 = time.perf_counter()
    want = eng.candidate_pairs()
    t1 = time.perf_counter()
    reset_kernel_counts()
    got = eng.candidate_pairs_sharded(LocalShards(SHARDS, device))
    return {"one_device": want, "sharded": got, "one_device_s": t1 - t0,
            "sharded_s": time.perf_counter() - t1,
            "screens": d2n.launches["d2_screen"]}


def nccl_path(corpus, work):
    """NCCL_PATH by bin/swarm-torch as a one-rank NCCL group (a new
    process under the rank variables): launch_path's record."""
    from swarm_tpu_torch.parallel.dryrun import free_port

    return launch_path(MAIN_PATHS[NCCL_PATH][2], corpus[NCCL_PATH],
                       work / f"{NCCL_PATH}_nccl", {
                           "SWARM_TPU_COORDINATOR": f"127.0.0.1:{free_port()}",
                           "SWARM_TPU_NUM_PROCESSES": "1",
                           "SWARM_TPU_PROCESS_ID": "0"})


def forwarded_paths(corpus, work):
    """The resident server on the card (python -m swarm_tpu_torch.server
    under SWARM_TPU_DB_CACHE=1 and SWARM_TPU_TIMING=1): each of
    SERVER_PATHS forwarded to it by bin/swarm-torch twice (the second
    from its DB cache), then --shutdown. Returns {"ready_s", "exit":
    [--shutdown's exit code, the server's], NAME: {"runs": a record
    {"s", "files", "stderr"} a run, "marked": the lines of the card's
    engine (SERVER_PATHS) in the server's stderr during them}}."""
    sock, log_path = work / "server.sock", work / "server_stderr.txt"
    launcher = str(tree() / "bin" / "swarm-torch")
    env = launcher_env()
    result = {}
    with open(log_path, "wb") as log:
        t0 = time.perf_counter()
        server = subprocess.Popen(
            [sys.executable, "-m", "swarm_tpu_torch.server", str(sock)],
            cwd=tree(), stdout=subprocess.DEVNULL, stderr=log,
            env={**env, "SWARM_TPU_DB_CACHE": "1", "SWARM_TPU_TIMING": "1"})
        try:
            while not sock.exists():
                if server.poll() is not None or \
                        time.perf_counter() - t0 > 300:
                    raise AssertionError("the server did not start:\n"
                                         + log_path.read_text()[-2000:])
                time.sleep(0.01)
            result["ready_s"] = time.perf_counter() - t0
            for name, marker in SERVER_PATHS.items():
                flags = MAIN_PATHS[name][2]
                seen = log_path.read_text().count(marker)
                runs = []
                for k in (1, 2):
                    cwd = work / f"{name}_fwd{k}"
                    cwd.mkdir()
                    t1 = time.perf_counter()
                    r = subprocess.run(
                        [sys.executable, launcher, *flags, "-l", "log.txt",
                         str(corpus[name])], cwd=cwd,
                        env={**env, "SWARM_TORCH_SERVER": str(sock)},
                        capture_output=True, timeout=600)
                    if r.returncode != 0:
                        raise AssertionError(
                            f"{name} forwarded returned {r.returncode}:\n"
                            + r.stderr.decode()[-2000:])
                    runs.append({"s": time.perf_counter() - t1,
                                 "files": {f: cwd / f
                                           for f in output_files(flags)},
                                 "stderr": r.stderr.decode().splitlines()})
                result[name] = {"runs": runs, "marked":
                                log_path.read_text().count(marker) - seen}
            r = subprocess.run(
                [sys.executable, "-m", "swarm_tpu_torch.server", str(sock),
                 "--shutdown"], cwd=tree(), env=env, capture_output=True,
                timeout=60)
            result["exit"] = [r.returncode, server.wait(timeout=60)]
        finally:
            if server.poll() is None:
                server.kill()
                server.wait()
    return result


def first_records(src, k, dst):
    """The first k records of FASTA file `src` (two lines a record, as
    corpora.py writes them) into `dst`: k distinct amplicons."""
    lines = src.read_bytes().split(b"\n")
    if len(lines) < 2 * k:
        raise AssertionError(f"{src.name} holds fewer than {k} records")
    dst.write_bytes(b"\n".join(lines[:2 * k]) + b"\n")


def dispatch_thresholds(rule):
    """(warm, cold): the size from which CLI rule `rule` takes the card's
    engine in a process that holds the card and in one that does not."""
    from swarm_tpu_torch.models import general
    from swarm_tpu_torch.ops.neighbors import NeighborIndex

    return {"d1": (NeighborIndex.NATIVE_MAX, NeighborIndex.NATIVE_MAX_COLD),
            "d1f": (NeighborIndex.NATIVE_MAX, NeighborIndex.NATIVE_MAX_GRAFT),
            "d2": (general.NETWORK_MIN, general.NETWORK_MIN_COLD)}[rule]


def dispatch_path(rule, state, corpus, work, device):
    """The auto run of CLI rule `rule` (DISPATCH_PATHS) at its `state`
    threshold - 1 and at it, on the first records of its main path's
    corpus: "warm" in this process, which must hold the card
    (device.card_ready), "cold" each in a new process, which does not.
    Returns {"threshold": it, k: the run's record, with its "fasta" and
    "card": whether the card's engine ran (its kernel launched)}."""
    from swarm_tpu_torch.device import card_ready

    path, flags, kernel, _ = DISPATCH_PATHS[rule]
    at = dispatch_thresholds(rule)[state == "cold"]
    if state == "warm" and not card_ready():
        raise AssertionError("the warm dispatch rules need the card held")
    result = {"threshold": at}
    for k in (at - 1, at):
        run = work / f"dispatch_{rule}_{state}_{k}"
        fasta = run.with_suffix(".fasta")
        first_records(corpus[path], k, fasta)
        ran = run_path(flags, fasta, run, None, device) if state == "warm" \
            else launch_path(flags, fasta, run)
        result[k] = {**ran, "fasta": fasta,
                     "card": ran["launches"].get(kernel, 0) > 0}
    return result


#: dispatch_diffs before the d2_diffs kernel's first launch: a fresh
#: process that prints its record for one -t
DIFFS_COLD = """import json, sys
sys.path[:0] = [{tree!r}, {repo!r}]
import torch
import chip_smoke
print(json.dumps(chip_smoke.dispatch_diffs(
    torch.device("cuda", 0), {source!r}, "cold", {threads})))
"""


def _digest(arrays):
    import hashlib

    import numpy as np

    h = hashlib.blake2b(digest_size=16)
    for x in arrays:
        x = np.ascontiguousarray(x)
        h.update(f"{x.dtype} {x.shape}".encode())
        h.update(x.tobytes())
    return h.hexdigest()


def dispatch_diffs(dev, source, state, threads):
    """D2NetworkEngine.build_adjacency under the auto rule on the card, at
    one below and at its threshold of a corpus' own candidate pairs
    (filled with other distinct pairs to the count: pairs_to_count), with
    `threads` host threads: 1 reads DEVICE_DIFFS_MIN, more
    DEVICE_DIFFS_MIN_THREADED, "cold" (the d2_diffs kernel not yet
    launched in this process) their _COLD forms; each point also under
    the native diffs. Returns {"threshold": it, "points": {k: {"card":
    whether the d2_diffs kernel ran, "auto": the adjacency's digest,
    "native": the native diffs'}}}."""
    import numpy as np
    import torch

    from swarm_tpu_torch.corpora import pairs_to_count, read_db
    from swarm_tpu_torch.ops import d2_diffs
    from swarm_tpu_torch.ops.d2_network import D2NetworkEngine

    if d2_diffs.warm != (state == "warm"):
        raise AssertionError(f"dispatch diffs ({state}): the kernel has "
                             f"{'not ' if state == 'warm' else ''}run")
    eng = D2NetworkEngine(read_db(Path(source)), 2, dev, threads=threads)
    pa, pb, _ = eng.candidate_pairs()
    at = getattr(eng, "DEVICE_DIFFS_MIN"
                 + ("_THREADED" if threads > 1 else "")
                 + ("_COLD" if state == "cold" else ""))
    result = {"threshold": at, "points": {}}
    for k in (at - 1, at):
        qa, qb = (torch.from_numpy(x.astype(np.int32)).to(dev)
                  for x in pairs_to_count(pa, pb, eng.n, k))
        eng.candidate_pairs_device = lambda shards=None: (qa, qb, k)
        point = {}
        for mode in ("auto", "native"):
            os.environ["SWARM_TPU_D2_DIFFS"] = mode
            eng.__dict__.pop("_diff_engine", None)
            d2_diffs.launches = 0
            point[mode] = _digest(eng.build_adjacency(18, 24, 13, False))
            if mode == "auto":
                point["card"] = d2_diffs.launches > 0
        os.environ.pop("SWARM_TPU_D2_DIFFS")
        result["points"][k] = point
    return result


def dispatch_diffs_cold(source, threads):
    """dispatch_diffs(..., "cold", threads) in a fresh process."""
    r = subprocess.run(
        [sys.executable, "-c", DIFFS_COLD.format(
            tree=str(tree()), repo=str(REPO), source=str(source),
            threads=threads)],
        cwd=source.parent, env=launcher_env(), capture_output=True,
        text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"dispatch diffs (cold): -t {threads} returned "
                             f"{r.returncode}:\n{r.stderr[-2000:]}")
    result = json.loads(r.stdout.strip().splitlines()[-1])
    result["points"] = {int(k): v for k, v in result["points"].items()}
    return result


def diffs_threads():
    """The dispatch of the device diffs at -t 1 and at -t of every core."""
    return 1, max(2, len(os.sched_getaffinity(0)))


def _launched(ran):
    """{kernel: launches} of a run's kernels that launched."""
    return {k: n for k, n in ran["launches"].items() if n}


def shard_summary(engine, ran):
    """The exchanges of sharded engine `engine` in run `ran` (their
    bytes, time and bound: the bytes read once and written once at the
    card's memory rate) and its phases (the spans ENGINE_shards.*)."""
    nbytes = ran["counters"].get(f"{engine}_shards.exchange_bytes", 0)
    phases = {name.split(".", 1)[1]: round(sec * 1e3, 4)
              for name, sec in ran["spans"].items()
              if name.startswith(f"{engine}_shards.")}
    return {"exchanges": ran["counters"].get(f"{engine}_shards.exchanges",
                                             0),
            "exchange_bytes": nbytes,
            "exchange_ms": phases.get("exchange", 0.0),
            "exchange_bound_ms": 2 * nbytes / PEAK_BYTES_PER_S * 1e3,
            "phases_ms": phases}


def phase_main_paths(dev, corpus, work):
    """The main-path pass: each of MAIN_PATHS once through the CLI on the
    card, every kernel's launches counted from 0 before it; SHARDED_PATHS
    over SHARDS in-process shards, each exchange's bytes and time beside
    its bound (read once and written once at the card's memory rate);
    d2_100k's candidate pairs over the shards; NCCL_PATH as a one-rank
    NCCL group; SERVER_PATHS forwarded to the resident server; each
    dispatch rule at its thresholds. Prints what each run launched and
    how long it took; compares no output (tests/test_torch_cuda.py does,
    on these functions' runs). Returns {path: {kernel: launches}} of the
    MAIN_PATHS runs."""
    t_phase = time.perf_counter()
    launches = {}
    for name in MAIN_PATHS:
        ran = main_path(name, corpus, work, dev)
        launches[name] = _launched(ran)
        say(f"main path {name}: {ran['s']:.3f} s, launches="
            f"{launches[name]}")
    for name in SHARDED_PATHS:
        ran = sharded_path(name, corpus, work, dev)
        say(f"sharded {name}: {SHARDS} shards on {dev}, {ran['s']:.3f} s, "
            f"launches={_launched(ran)}")
        for engine in ("d1", "graft", "d2"):
            if f"{engine}_shards.count" in ran["counters"]:
                say(f"  {engine}: {shard_summary(engine, ran)}")
    pairs = sharded_pairs(corpus, dev)
    say(f"sharded d2_100k pairs: {pairs['one_device'][2]} pairs, one device "
        f"{pairs['one_device_s']:.3f} s, {SHARDS} shards "
        f"{pairs['sharded_s']:.3f} s ({pairs['screens']} screen launches)")
    ran = nccl_path(corpus, work)
    say(f"one-rank NCCL {NCCL_PATH}: a new process, {ran['s']:.3f} s, "
        f"launches={_launched(ran)}")
    served = forwarded_paths(corpus, work)
    say(f"server: ready in {served['ready_s']:.3f} s, exit codes "
        f"{served['exit']}")
    for name in SERVER_PATHS:
        say(f"server {name}: forwarded "
            + ", ".join(f"{r['s']:.3f}" for r in served[name]["runs"])
            + f" s; the card's engine in the server's stderr "
            f"{served[name]['marked']} times")
    for rule in DISPATCH_PATHS:
        for state in ("warm", "cold"):
            ran = dispatch_path(rule, state, corpus, work, dev)
            say(f"dispatch {rule} ({state}): threshold {ran['threshold']}: "
                + "; ".join(f"{k} -> {'card' if ran[k]['card'] else 'host'}"
                            for k in ran if k != "threshold"))
    source = work / "dispatch_diffs.fasta"
    first_records(corpus["d2_100k"], DIFFS_RECORDS, source)
    for threads in diffs_threads():
        for state in ("warm", "cold"):
            ran = dispatch_diffs(dev, source, state, threads) \
                if state == "warm" else dispatch_diffs_cold(source, threads)
            say(f"dispatch diffs ({state} -t {threads}): threshold "
                f"{ran['threshold']}: " + "; ".join(
                    f"{k} -> {'card' if p['card'] else 'host'}"
                    for k, p in ran["points"].items()))
    say(f"main-path pass: {time.perf_counter() - t_phase:.1f} s")
    return launches


def run_phases(dev, work):
    """The probe, the timed kernel phases and the main-path pass; returns
    the kernel table."""
    corpus = make_corpora(work, MAIN_PATHS)

    phase_probe(dev)
    rows = {"d2_diffs": phase_d2_diffs_at_scale(dev, corpus["d2_100k"])}
    rows.update(phase_nw_scores(dev, corpus["d2_device"]))
    rows.update(phase_d2_screen(dev, corpus))
    rows.update(phase_d2_csr(dev))
    rows.update(phase_d2_tasks(dev))
    rows.update(phase_d1_kernels(dev, corpus))
    rows.update(phase_graft_kernels(dev, corpus, work))
    ran = phase_main_paths(dev, corpus, work)

    d1 = "swarm_tpu_torch/csrc/d1_join.cu"
    graft = "swarm_tpu_torch/csrc/graft.cu"
    static = {
        "d2_diffs": ("swarm_tpu_torch/csrc/d2_diffs.cu",
                     "swarm_tpu/ops/pallas_d2_diffs.py:191"),
        "banded_scores": ("swarm_tpu_torch/csrc/nw_scores.cu",
                          "swarm_tpu/ops/pallas_nw.py:410"),
        "full_scores": ("swarm_tpu_torch/csrc/nw_scores.cu",
                        "swarm_tpu/ops/pallas_nw.py:240"),
        # the d>=2 screen and extraction were XLA programs
        "d2_screen": ("swarm_tpu_torch/csrc/d2_screen.cu",
                      "swarm_tpu/ops/d2_network.py:52"),
        "d2_extract": ("swarm_tpu_torch/csrc/d2_screen.cu",
                       "swarm_tpu/ops/d2_network.py:107"),
        # no TPU kernel: the JAX engine sorts its edges on the host
        "d2_csr": ("swarm_tpu_torch/csrc/d2_csr.cu",
                   "none (np.lexsort, swarm_tpu/ops/d2_network.py:490)"),
        # nor does it lay its diff tasks out on the device
        "d2_tasks": ("swarm_tpu_torch/csrc/d2_tasks.cu",
                     "none (numpy, swarm_tpu/ops/d2_diffs_jax.py:209)"),
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
    # each kernel's launches in each main path's run that launched it
    return [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, **rows[name],
             "launches": {path: counts[name] for path, counts in ran.items()
                          if name in counts}}
            for name, (source, replaces) in static.items()]


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report it, print no result
        traceback.print_exc()
        print("FAIL see traceback on stderr", flush=True)
        sys.exit(1)
