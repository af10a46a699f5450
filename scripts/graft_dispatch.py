#!/usr/bin/env python3
"""Times `-f`'s graft on the card, device engine against host join.

    python3 scripts/graft_dispatch.py [--tree CHECKOUT] [--reps N]
        [--device-only] [CORPUS ...]

For each corpus it runs `swarm -d 1 -f -y 12` once through
swarm_tpu_torch.main.run with SWARM_TPU_GRAFT_PROBE_MAX=0 and keeps the
sides that the run hands GraftEngine (with the rows the d=1 engine left
on the card, when it ran). On those sides it then times, N times each
(wall clock, the card synchronised):
- the device engine, ops/fastidious_torch.GraftEngine.graft_candidates,
  as the main path calls it, and once more for its phases (the spans
  fastidious.keys, .partition, .join, .verify, .to_host of the run's
  record; a checkout whose engine keeps no such spans reports none);
- the host join, _native.graft_join (its probe up to 2<<20 keys on the
  smaller side, its radix sort-join above);
- the whole run warm, with the graft on the device
  (SWARM_TPU_GRAFT_PROBE_MAX=0) and on the host (=1<<40), in turns.
Both must give the same count and candidates. --device-only skips the
host join and the whole runs (to compare two checkouts' engines:
--tree runs the swarm_tpu_torch of another checkout). Prints the card's
name and power limit, then one JSON line a corpus.

Corpora (default: all but the two fastidious 200k ones): config4_200k
is bench.py's config 4 (gen_corpus(n=200_000, length=150)), config4_20k
and config4_2k the same generator at 20,000 and 2,000 amplicons;
fastidious_2k, fastidious_20k and fastidious_200k are fastidious_corpus
(a quarter of the reads light), fastidious_asym_200k its small light
side (satellites=0.3).
"""

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CORPORA = {
    "config4_2k": ("gen_corpus", {"n": 2_000, "length": 150}),
    "config4_20k": ("gen_corpus", {"n": 20_000, "length": 150}),
    "config4_200k": ("gen_corpus", {"n": 200_000, "length": 150}),
    "fastidious_2k": ("fastidious_corpus", {"n": 2_000}),
    "fastidious_20k": ("fastidious_corpus", {"n": 20_000}),
    "fastidious_200k": ("fastidious_corpus", {"n": 200_000}),
    "fastidious_asym_200k": ("fastidious_corpus",
                             {"n": 200_000, "satellites": 0.3}),
}
DEFAULT = ("config4_2k", "config4_20k", "config4_200k", "fastidious_2k",
           "fastidious_20k")
FLAGS = ["-d", "1", "-f", "-y", "12", "-o", "out.txt", "-s", "stats.txt"]
DEVICE = {"SWARM_TPU_GRAFT_PROBE_MAX": "0"}
HOST = {"SWARM_TPU_GRAFT_PROBE_MAX": str(1 << 40)}


def run_cli(argv, workdir, env):
    """One run of the port in `workdir` with `env` set: (seconds,
    [timing] lines)."""
    from swarm_tpu_torch.main import run

    workdir.mkdir(parents=True, exist_ok=True)
    cwd, real_err, err = os.getcwd(), sys.__stderr__, io.StringIO()
    saved = {k: os.environ.get(k) for k in env}
    os.chdir(workdir)
    sys.__stderr__ = err  # the [timing] lines are written here
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        rc = run(argv, "swarm")
        sec = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        sys.__stderr__ = real_err
        os.chdir(cwd)
    if rc != 0:
        raise AssertionError(f"run {argv} returned {rc}")
    return sec, [ln for ln in err.getvalue().splitlines()
                 if ln.startswith("[timing]")]


def sides(fasta, work):
    """(db, heavy, light, rows) that a device-graft run hands the
    engine, or None when the run has no graft to make (no light swarm,
    or no heavy one)."""
    from swarm_tpu_torch.ops import fastidious_torch as ft

    seen = []
    real = ft.GraftEngine.graft_candidates

    def capture(self, heavy, light):
        seen.append((self.db, heavy, light, self._rows))
        return real(self, heavy, light)

    ft.GraftEngine.graft_candidates = capture
    try:
        run_cli(FLAGS + [str(fasta)], work / "sides", DEVICE)
    finally:
        ft.GraftEngine.graft_candidates = real
    if len(seen) > 1:
        raise AssertionError(f"the graft engine ran {len(seen)} times")
    return seen[0] if seen else None


def timed(fn, reps):
    import torch

    out, secs = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def summary(secs):
    return {"min_s": min(secs), "median_s": statistics.median(secs),
            "runs_s": secs}


def measure(name, work, reps, device_only):
    import numpy as np
    import torch

    from swarm_tpu_torch import _native, corpora, metrics
    from swarm_tpu_torch.ops import fastidious_torch as ft

    maker, kwargs = CORPORA[name]
    fasta = work / f"{name}.fasta"
    getattr(corpora, maker)(fasta, **kwargs)
    got = sides(fasta, work / name)
    if got is None:
        return {"corpus": name, "maker": maker, "args": kwargs,
                "graft": "not run: no light or no heavy swarm"}
    db, heavy, light, rows = got
    dev = torch.device("cuda", 0)
    lens = db.lengths.astype(np.int64)
    keys = sorted([int((7 * lens[heavy] + 4).sum()),
                   int((7 * lens[light] + 4).sum())])
    rec = {"corpus": name, "maker": maker, "args": kwargs, "n": len(db),
           "heavy": len(heavy), "light": len(light), "small_side_keys":
           keys[0], "big_side_keys": keys[1],
           "d1_rows_on_card": rows is not None}

    def device():
        return ft.GraftEngine(db, dev, rows).graft_candidates(heavy, light)

    (count, cand), secs = timed(device, reps + 1)
    rec["count"] = count
    rec["device"] = summary(secs[1:])  # the first builds the Zobrist table
    mark = len(metrics.spans)
    device()
    phases = {}
    for s in metrics.spans[mark:]:
        if s.name.startswith("fastidious.") and s.end is not None:
            step = s.name.split(".", 1)[1]
            phases[step] = phases.get(step, 0.0) + s.end - s.start
    rec["device_phases"] = phases
    if not device_only:
        host, secs = timed(lambda: _native.graft_join(
            db.codes, db.offsets, db.lengths, len(db), heavy, light), reps)
        h_count, h_cand = host if host is not None else (
            0, np.full(len(db), -1))
        if h_count != count or not np.array_equal(h_cand, cand):
            raise AssertionError(f"{name}: device and host grafts differ")
        rec["host"] = summary(secs)
        run_cli(FLAGS + [str(fasta)], work / name / "warm", DEVICE)
        runs = {"device": [], "host": []}
        for _ in range(2):
            for side, env in (("device", DEVICE), ("host", HOST)):
                sec, _ = run_cli(FLAGS + [str(fasta)], work / name / side,
                                 env)
                runs[side].append(sec)
        for side in runs:
            rec[f"run_{side}"] = summary(runs[side])
        outs = [(work / name / side / f).read_bytes()
                for side in runs for f in ("out.txt", "stats.txt")]
        if outs[:2] != outs[2:]:
            raise AssertionError(f"{name}: the two runs' outputs differ")
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("corpora", nargs="*", choices=list(CORPORA),
                    metavar="CORPUS")
    ap.add_argument("--tree", type=Path, default=REPO,
                    help="checkout whose swarm_tpu_torch runs")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("FAIL no CUDA device", flush=True)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory(prefix="graft_dispatch_") as tmp:
        for name in args.corpora or DEFAULT:
            rec = measure(name, Path(tmp), args.reps, args.device_only)
            print(json.dumps({"tree": str(args.tree), "card": card, **rec}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
