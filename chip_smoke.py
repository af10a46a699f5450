#!/usr/bin/env python3
"""Bring-up check of swarm_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py          (from the root of a checkout)

Phases, each printing its own lines; any failure exits 1 before the
final line:

1. the card (nvidia-smi name and power limit), then the native host
   library and the CUDA kernels built from the checkout's sources;
2. kernel d2_diffs against its plain PyTorch version on the card,
   exactly (integer DP), on tie-heavy chain corpora and on 2^20 tasks
   made of the d2_100k corpus' candidate pairs; both timed;
3. kernels banded_scores and full_scores (one seed of the dense-cloud
   corpus against 4,096 targets of ~400 nt) against their plain
   versions on the card, exactly, for bands B = 4, 20, 63 and three
   penalty sets; the banded scores also against the full-row kernel
   under the screen's contract (equal where <= cutoff, both above it
   elsewhere); both timed;
4. main paths through swarm_tpu_torch.main.run, each with a warm-up
   run, then one timed run with every kernel's launch count set to 0
   before it and read after it, then the port's native C engine
   (SWARM_TPU_D2_ENGINE=native), whose output files the run's must
   equal byte for byte:
   - d2_100k (99,831 amplicons of 142-158 nt) and d2_long (19,991 of
     ~400 nt): `swarm -d 2`, the network engine, kernel d2_diffs;
   - d2_device (20,808 amplicons of ~400 nt in dense clouds): `swarm
     -d 2` under SWARM_TPU_D2_ENGINE=device, kernel banded_scores;
   - d2_wide (5,204 amplicons, `-d 5 -m 1 -p 20 -g 1 -e 1`, band 70):
     the same engine, kernel full_scores.

The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Needs one CUDA device, nvcc and a C
compiler. Imports no JAX.
"""

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
# rate, and the float32 rate outside the tensor cores, which stands in
# for the int32 work of these kernels (the data sheet has no int32 row)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: arithmetic per DP cell: the recurrences written out
#: (compare, select, adds, mins, clamps)
OPS_PER_SCORE_CELL = 12
OPS_PER_DIFF_CELL = 35  # the cost cell plus the carried diff counts


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
    ms = cuda_ms(lambda: nw_scores.banded_scores(
        al.padded, al.lengths, seed_id, ids, mm, go, ge, B), 20)
    plain_ms = cuda_ms(lambda: nw_scores.banded_scores_reference(
        qrows, rows, qlens, lens, mm, go, ge, B), 2)
    in_band = (lens > 0) & ((lens - ql).abs() <= B)
    cells = int((lens.long() * in_band).sum()) * (2 * B + 1)
    bound_ms, bound_by = bound(io_bytes, cells * OPS_PER_SCORE_CELL)
    say(f"kernel banded_scores timed: targets={nb} B={B} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} cells={cells} bytes={io_bytes} "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    result["banded_scores"] = {
        "max_abs_err": worst_band, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}

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


def run_cli(argv, workdir, engine=None):
    """One CLI run of the port in `workdir` under SWARM_TPU_D2_ENGINE=
    `engine`; returns (seconds, [timing] lines)."""
    from swarm_tpu_torch.main import run

    workdir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    err = io.StringIO()
    real_err = sys.__stderr__
    os.chdir(workdir)
    sys.__stderr__ = err  # progress.py writes its [timing] lines here
    if engine:
        os.environ["SWARM_TPU_D2_ENGINE"] = engine
    try:
        t0 = time.perf_counter()
        rc = run(argv, "swarm")
        sec = time.perf_counter() - t0
    finally:
        os.environ.pop("SWARM_TPU_D2_ENGINE", None)
        sys.__stderr__ = real_err
        os.chdir(cwd)
    if rc != 0:
        raise AssertionError(f"run {argv} returned {rc}")
    return sec, [ln for ln in err.getvalue().splitlines()
                 if ln.startswith("[timing]")]


def kernel_counts():
    from swarm_tpu_torch.ops import d2_diffs, nw_scores

    return {"d2_diffs": d2_diffs.launches, **nw_scores.launches}


def reset_kernel_counts():
    from swarm_tpu_torch.ops import d2_diffs, nw_scores

    d2_diffs.launches = 0
    for name in nw_scores.launches:
        nw_scores.launches[name] = 0


def phase_main_path(name, fasta, flags, work, engine, kernel):
    """Warm-up run, then one timed run through the port under `engine`
    with every kernel's launch count set to 0 before it and read after
    it; then the native engine's run, whose files the port's must equal
    byte for byte. Returns the timed run's launch count of `kernel`."""
    import torch

    from swarm_tpu_torch import metrics

    n = sum(1 for ln in open(fasta) if ln.startswith(">"))
    argv = flags + ["-l", "log.txt", str(fasta)]
    outputs = [flags[i + 1] for i in range(len(flags) - 1)
               if flags[i] in ("-o", "-s", "-u", "-i", "-w")] + ["log.txt"]
    warm_s, _ = run_cli(argv, work / f"{name}_warm", engine)
    torch.cuda.synchronize()

    reset_kernel_counts()
    metrics.reset()
    sec, timing = run_cli(argv, work / f"{name}_torch", engine)
    counts = kernel_counts()
    if engine is None and \
            metrics.last_run.get("qgram_screen_comparisons") != n * (n - 1) // 2:
        raise AssertionError(f"{name}: the network engine did not run")
    if counts[kernel] < 1:
        raise AssertionError(f"{name}: kernel {kernel} never launched")
    native_s, _ = run_cli(argv, work / f"{name}_native", "native")

    say(f"main path {name}: n={n} engine={engine or 'auto (network)'} "
        f"flags={' '.join(flags)} warmup_s={warm_s:.3f} warm_s={sec:.3f} "
        f"native_engine_s={native_s:.3f} launches={counts}")
    if engine == "device":
        say(f"main path {name}: target lists that took the device="
            f"{metrics.last_run.get('d2_device_batches')} stayed under "
            f"MIN_DEVICE_BATCH={metrics.last_run.get('d2_host_batches')}")
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
    return counts[kernel]


def main():
    if not (REPO / "swarm_tpu_torch").is_dir():
        say("FAIL swarm_tpu_torch not found next to chip_smoke.py")
        return 1
    sys.path.insert(0, str(REPO))
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
        if "registers" in ln or "spill" in ln:
            say(f"  ptxas {ln.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kernels = run_phases(dev, Path(tmp))
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": device_name(),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def run_phases(dev, work):
    """Kernel and main-path phases; returns the kernel table."""
    from swarm_tpu_torch import corpora

    corpus = {}
    for name, n, length in (("d2_100k", 100_000, 150),
                            ("d2_long", 20_000, 400)):
        corpus[name] = work / f"{name}.fasta"
        corpora.gen_corpus(corpus[name], n=n, length=length)
    for name, n_centers, cloud in (("d2_device", 4, 2600),
                                   ("d2_wide", 1, 2601)):
        corpus[name] = work / f"{name}.fasta"
        corpora.dense_cloud_corpus(
            corpus[name], n_centers=n_centers, cloud=cloud, length=400)

    rows = {"d2_diffs": phase_d2_diffs_at_scale(dev, corpus["d2_100k"])}
    rows["d2_diffs"]["max_abs_err"] = max(
        rows["d2_diffs"]["max_abs_err"], phase_d2_diffs_ties(dev, work))
    rows.update(phase_nw_scores(dev, corpus["d2_device"]))

    launches = {}
    launches["d2_diffs"] = phase_main_path(
        "d2_100k", corpus["d2_100k"],
        ["-d", "2", "-o", "out.txt", "-s", "stats.txt", "-u", "uclust.txt",
         "-i", "structure.txt", "-w", "seeds.fasta"], work, None, "d2_diffs")
    phase_main_path("d2_long", corpus["d2_long"],
                    ["-d", "2", "-o", "out.txt", "-s", "stats.txt"], work,
                    None, "d2_diffs")
    launches["banded_scores"] = phase_main_path(
        "d2_device", corpus["d2_device"],
        ["-d", "2", "-o", "out.txt", "-s", "stats.txt", "-i",
         "structure.txt"], work, "device", "banded_scores")
    launches["full_scores"] = phase_main_path(
        "d2_wide", corpus["d2_wide"],
        ["-d", "5", "-m", "1", "-p", "20", "-g", "1", "-e", "1",
         "-o", "out.txt", "-s", "stats.txt", "-i", "structure.txt"], work,
        "device", "full_scores")

    static = {
        "d2_diffs": ("swarm_tpu_torch/csrc/d2_diffs.cu",
                     "swarm_tpu/ops/pallas_d2_diffs.py:191"),
        "banded_scores": ("swarm_tpu_torch/csrc/nw_scores.cu",
                          "swarm_tpu/ops/pallas_nw.py:410"),
        "full_scores": ("swarm_tpu_torch/csrc/nw_scores.cu",
                        "swarm_tpu/ops/pallas_nw.py:240"),
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
