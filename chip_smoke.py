#!/usr/bin/env python3
"""Bring-up check of swarm_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py          (from the root of a checkout)

Phases, each printing its own lines; any failure exits 1 before the
final line:

1. the card (nvidia-smi name and power limit), then the native host
   library and the CUDA kernels built from the checkout's sources;
2. kernel: d2_diffs on the card against its plain PyTorch version on
   the card, exactly (integer DP), on tie-heavy chain corpora and on
   2^20 tasks made of the d2_100k corpus' candidate pairs; both timed;
3. main path: `swarm -d 2` through swarm_tpu_torch.main.run on the
   d2_100k corpus (99,831 amplicons of 142-158 nt) and on d2_long
   (19,991 of ~400 nt): a warm-up run, then three timed runs (median,
   min and max printed) with the kernel's launch count reset before
   each and checked after it; every output file must equal the native
   C engine's (swarm_tpu with SWARM_TPU_D2_ENGINE=native).

The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Needs one CUDA device, nvcc and gcc.
Imports no JAX.
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
TIMED_RUNS = 3  # the host-bound wall time spreads between runs

# read when swarm_tpu.progress is imported: per-phase times on stderr
os.environ["SWARM_TPU_TIMING"] = "1"
os.environ["SWARM_TPU_DB_CACHE"] = "0"


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


def phase_kernel(dev, work):
    """Kernel against plain version on the tie-heavy chain corpora of
    tests/test_torch_cuda.py; returns max_abs_err."""
    import numpy as np
    import torch

    from swarm_tpu_torch.ops.d2_diffs import (
        DeviceDiffEngine, d2_diffs, d2_diffs_reference)
    from test_d2_diffs_jax import _chain_corpus, _mkdb
    from test_torch_cuda import KERNEL_CASES

    worst = 0
    for seed, d, (mm, go, ge) in KERNEL_CASES:
        case_dir = work / f"tie_corpus_{seed}"
        case_dir.mkdir()
        db = _mkdb(case_dir, _chain_corpus(seed, 50, 48, d + 1))
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
        say(f"kernel tie corpus seed={seed} d={d} scores={(mm, go, ge)} "
            f"B={B} tasks={tq.numel()} accepted={int((want >= 0).sum())} "
            f"max_abs_err={err}")
        if err:
            raise AssertionError("d2_diffs kernel disagrees with its plain "
                                 "version on a tie corpus")
    return worst


def phase_kernel_at_scale(dev, fasta):
    """2^20 directed tasks from the d2_100k candidate pairs."""
    import numpy as np
    import torch

    from swarm_tpu.db import db_read
    from swarm_tpu.params import Parameters
    from swarm_tpu.progress import Progress
    from swarm_tpu_torch.ops.d2_diffs import (
        DeviceDiffEngine, d2_diffs, d2_diffs_reference)
    from swarm_tpu_torch.ops.d2_network import D2NetworkEngine

    p = Parameters()
    p.input_filename = str(fasta)
    p.logfile = io.StringIO()
    db = db_read(p, Progress(io.StringIO(), True))
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
    say(f"kernel d2_100k sample: tasks={tq.numel()} (the screen's "
        f"{n_real} directed tasks, repeated) Lmax={eng.Lmax} B={B} "
        f"accepted={int((want >= 0).sum())} max_abs_err={err} "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}")
    if err:
        raise AssertionError("d2_diffs kernel disagrees with its plain "
                             "version at d2_100k shapes")
    return err, ms, plain_ms


def run_cli(run, argv, workdir):
    """One CLI run in `workdir`; returns (seconds, [timing] lines)."""
    workdir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    err = io.StringIO()
    real_err = sys.__stderr__
    os.chdir(workdir)
    sys.__stderr__ = err  # progress.py writes its [timing] lines here
    try:
        t0 = time.perf_counter()
        rc = run(argv, "swarm")
        sec = time.perf_counter() - t0
    finally:
        sys.__stderr__ = real_err
        os.chdir(cwd)
    if rc != 0:
        raise AssertionError(f"run {argv} returned {rc}")
    return sec, [ln for ln in err.getvalue().splitlines()
                 if ln.startswith("[timing]")]


def phase_main_path(name, fasta, flags, work):
    """Warm-up run, then TIMED_RUNS timed runs through the port, each
    with the kernel's launch count reset before it; then the native
    engine's run, whose files the port's must equal byte for byte.
    Returns the last timed run's launch count."""
    import statistics

    import torch

    from swarm_tpu import metrics
    from swarm_tpu.main import run as run_native
    from swarm_tpu_torch.main import run as run_torch
    from swarm_tpu_torch.ops import d2_diffs

    n = sum(1 for ln in open(fasta) if ln.startswith(">"))
    argv = flags + ["-l", "log.txt", str(fasta)]
    outputs = [flags[i + 1] for i in range(0, len(flags), 2)
               if flags[i] != "-d"] + ["log.txt"]
    warm_s, _ = run_cli(run_torch, argv, work / f"{name}_warm")
    torch.cuda.synchronize()

    runs = []
    for _ in range(TIMED_RUNS):
        d2_diffs.launches = 0
        metrics.reset()
        sec, timing = run_cli(run_torch, argv, work / f"{name}_torch")
        launches = d2_diffs.launches
        if metrics.last_run.get("qgram_screen_comparisons") != n * (n - 1) // 2:
            raise AssertionError(f"{name}: the network engine did not run")
        if launches < 1:
            raise AssertionError(f"{name}: d2_diffs kernel never launched")
        runs.append((sec, timing))

    os.environ["SWARM_TPU_D2_ENGINE"] = "native"
    try:
        native_s, _ = run_cli(run_native, argv, work / f"{name}_native")
    finally:
        del os.environ["SWARM_TPU_D2_ENGINE"]

    secs = [sec for sec, _ in runs]
    med = statistics.median(secs)
    say(f"main path {name}: n={n} flags={' '.join(flags)} warmup_s={warm_s:.3f} "
        f"warm_s median={med:.3f} min={min(secs):.3f} max={max(secs):.3f} "
        f"runs={[round(x, 3) for x in secs]} native_engine_s={native_s:.3f} "
        f"d2_diffs_launches_per_run={launches}")
    for ln in runs[secs.index(med)][1]:
        say(f"  {name} (median run) {ln}")
    for out in outputs:
        a = (work / f"{name}_torch" / out).read_bytes()
        b = (work / f"{name}_native" / out).read_bytes()
        if a != b or not a:
            raise AssertionError(f"{name}: {out} differs from the native "
                                 f"engine's ({len(a)} vs {len(b)} bytes)")
    say(f"main path {name}: {len(outputs)} output files byte-identical "
        f"to the native engine")
    return launches


def main():
    if not (REPO / "swarm_tpu_torch").is_dir():
        say("FAIL swarm_tpu_torch not found next to chip_smoke.py")
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(1, str(REPO / "tests"))  # the kernel tests' corpora
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
    from swarm_tpu import _native
    from swarm_tpu_torch import _build
    from swarm_tpu_torch.device import device_name

    if not _native.available():
        raise RuntimeError("native host library failed to build")
    t1 = time.perf_counter()
    log = _build.build(verbose=True)
    _build.load()
    t2 = time.perf_counter()
    say(f"build: native library {t1 - t0:.1f}s, CUDA kernels "
        f"{t2 - t1:.1f}s ({_build.library_path().name})")
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
    import bench

    corpus = {}
    for name, n, length in (("d2_100k", 100_000, 150),
                            ("d2_long", 20_000, 400)):
        corpus[name] = work / f"{name}.fasta"
        bench.gen_corpus(corpus[name], n=n, length=length)

    worst = phase_kernel(dev, work)
    err, ms, plain_ms = phase_kernel_at_scale(dev, corpus["d2_100k"])
    worst = max(worst, err)

    launches = phase_main_path(
        "d2_100k", corpus["d2_100k"],
        ["-d", "2", "-o", "out.txt", "-s", "stats.txt", "-u", "uclust.txt",
         "-i", "structure.txt", "-w", "seeds.fasta"], work)
    phase_main_path("d2_long", corpus["d2_long"],
                    ["-d", "2", "-o", "out.txt", "-s", "stats.txt"], work)

    return [{
        "name": "d2_diffs",
        "route": "cuda",
        "source": "swarm_tpu_torch/csrc/d2_diffs.cu",
        "replaces": "swarm_tpu/ops/pallas_d2_diffs.py:191",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report it, print no result
        traceback.print_exc()
        print("FAIL see traceback on stderr", flush=True)
        sys.exit(1)
