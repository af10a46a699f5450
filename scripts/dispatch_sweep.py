#!/usr/bin/env python3
"""Times each engine-dispatch rule of swarm_tpu_torch on the card, the
host engine against the card's, across sizes, warm and cold.

    python3 scripts/dispatch_sweep.py [--rules RULE ...] [--reps N]
        [--cold-reps N] [--no-cold | --cold-only] [--sizes N ...] [--corpora NAME ...]
        [--ds D ...] [--threads T ...] [--out FILE]

The rules, each a constant of the port that picks the engine of a run:

- d1: NeighborIndex.NATIVE_MAX (ops/neighbors.py): the native host
  builder of the d=1 network below it, the card's sort-join engine from
  it up. `swarm -d 1 -o -s -t T` on gen_corpus(length=150) and
  mixed_length_corpus at n = 4,096 to 131,072, T = 1 and the host's
  core count; the engines forced by SWARM_TPU_D1_NATIVE_MAX=0 (card)
  and =2^40 (host).
- d1f: the same constant under -f, whose graft takes the card whatever
  the network's engine: `swarm -d 1 -f -o -s -t T` on
  fastidious_corpus (d1_fastidious_200k's generator: light satellites
  around heavy clouds) and its small-light-side form (satellites=0.3)
  at the same sizes and T, the engines forced as for d1.
- d2: models/general.NETWORK_MIN: the network engine (the card's qgram
  screen) from it up, the native C engine below. `swarm -d D -o -s -t
  1`, D = 2, 3, 4, 6 (6: the last d of the 8-bit regime at the default
  penalties), on gen_corpus(length=150) and gen_corpus(length=400) at n
  = 1,024 to 32,768; SWARM_TPU_D2_ENGINE=network against native. The
  native engine takes no threads, so only the network engine's host
  diffs see -t: one point a corpus at -t cores (d = 2, at the largest
  size the host won at -t 1).
- diffs: D2NetworkEngine.DEVICE_DIFFS_MIN (ops/d2_network.py): the card's
  exact diffs from that many candidate pairs up, the native ones below.
  D2NetworkEngine.build_adjacency on that engine's own candidate pairs
  of gen_corpus(n=32,768, length=150 and 400) at d = 2 and 6, cut or
  filled with other distinct pairs (corpora.pairs_to_count: the CSR the
  card builds after its diffs takes no repeated pair) to 512 to 65,536
  pairs, handed to the engine on its device as the screen leaves them;
  SWARM_TPU_D2_DIFFS=device against native; -t 1 and -t cores.
- batch: DeviceAligner.MIN_DEVICE_BATCH (ops/search_torch.py): a seed's
  target list on the card from that length up. One seed's list of L =
  256 to 16,384 targets (its gen-1 qgram survivors, repeated to L):
  DeviceAligner.scores and the host's exact rescoring of what it
  accepts, as models/general.py does, against the exact host diffs of
  the whole list; on d2_device's corpus shape
  (dense_cloud_corpus(length=400), one family, d = 2) and d2_wide's
  (the same corpus, d = 5, -m 1 -p 20 -g 1 -e 1: band 70, full_scores).

Warm: both engines in this process, after the kernel library was built
and loaded and one run of each (outputs compared), N runs each in turns
(card, host, host, card, ...); the medians. Cold: fresh processes,
--cold-reps of each engine and point in turns, the medians (a fresh
process's time varies by tenths of a second); d1, d1f and d2 run
bin/swarm-torch (the seconds after `import torch`: the port's imports,
the CUDA context, the kernel library's load and the run); diffs and
batch run this script's --point in a fresh process, which sets up what
a run holds when the rule is read (the network engine's screen done, or
the aligner's rows on the card) and times one call of the card's
engine, its first, and one of the host's. Cold points start at the warm crossover and take 2x and 4x
above it, then go on doubling while the card lost, up to COLD_MAX.
Every point checks that both engines' outputs are equal. --cold-only
takes no warm point and a cold one at each size instead; --sizes,
--corpora, --ds and --threads replace a rule's own sizes, corpora, d
values and -t values (each where the rule has them).

Prints the card's name and power limit, then one JSON line a point, and
last one {"crossovers": ...} line: for each series (rule, corpus, d,
-t, warm or cold) the last size the host won and the first size from
which the card won at every larger size measured, and for each rule
the largest of those. --out FILE also writes every line to FILE as it
comes.
"""

import argparse
import compileall
import inspect
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
LAUNCHER = REPO / "bin" / "swarm-torch"

RULES = ("d1", "d1f", "d2", "diffs", "batch")
#: name -> (corpora.py generator, its arguments but n)
CORPORA = {
    "gen150": ("gen_corpus", {"length": 150}),
    "gen400": ("gen_corpus", {"length": 400}),
    "mixed": ("mixed_length_corpus", {}),
    "fast": ("fastidious_corpus", {}),
    "fast_asym": ("fastidious_corpus", {"satellites": 0.3}),
}
D1_SIZES = tuple(1 << k for k in range(12, 18))  # 4,096 .. 131,072
D2_SIZES = tuple(1 << k for k in range(10, 16))  # 1,024 .. 32,768
D2_DS = (2, 3, 4, 6)
DIFFS_N = 1 << 15
DIFFS_DS = (2, 6)
DIFFS_SIZES = tuple(1 << k for k in range(9, 17))  # 512 .. 65,536
BATCH_SIZES = tuple(1 << k for k in range(8, 15))  # 256 .. 16,384
#: batch corpora: (d, scoring options); one dense family of
#: 2 * BATCH_CLOUD + 2 amplicons of ~400 nt
BATCH_CASES = {"d2_device": (2, []),
               "d2_wide": (5, ["-m", "1", "-p", "20", "-g", "1", "-e", "1"])}
BATCH_CLOUD = 8192
#: the largest size a cold series reaches while the card loses
COLD_MAX = {"d1": 1 << 20, "d1f": 1 << 20, "d2": 1 << 16,
            "diffs": 1 << 17, "batch": BATCH_SIZES[-1]}
COLD_DS = (2, 6)
#: the variables that force each engine
FORCE = {
    "d1": ({"SWARM_TPU_D1_NATIVE_MAX": "0"},
           {"SWARM_TPU_D1_NATIVE_MAX": str(1 << 40)}),
    "d1f": ({"SWARM_TPU_D1_NATIVE_MAX": "0"},
            {"SWARM_TPU_D1_NATIVE_MAX": str(1 << 40)}),
    "d2": ({"SWARM_TPU_D2_ENGINE": "network"},
           {"SWARM_TPU_D2_ENGINE": "native"}),
    "diffs": ({"SWARM_TPU_D2_DIFFS": "device"},
              {"SWARM_TPU_D2_DIFFS": "native"}),
}
#: a rule's flags beside -d, -t, -o and -s
FLAGS = {"d1f": ["-f"]}
#: each run reads its input: a CLI run in a new process finds no cache
QUIET = {"SWARM_TPU_DB_CACHE": "0"}
OUTPUTS = ("out.txt", "stats.txt")

#: a cold CLI run: stamps after `import torch` and at the end of the
#: launcher's run, written as JSON to the file named by argument 1
COLD_PROBE = """import json, sys, time
t0 = time.time()
import torch
t1 = time.time()
import runpy
out, sys.argv = sys.argv[1], [{launcher!r}] + sys.argv[2:]
try:
    runpy.run_path({launcher!r}, run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
t2 = time.time()
with open(out, "w") as fh:
    json.dump({{"start": t0, "torch": t1, "end": t2}}, fh)
"""


def cores():
    return len(os.sched_getaffinity(0))


def corpus_file(work, corpus, n):
    """The FASTA file of `corpus` at n amplicons in `work`, made once."""
    from swarm_tpu_torch import corpora

    path = work / f"{corpus}_{n}.fasta"
    if not path.exists():
        maker, kwargs = CORPORA[corpus]
        tmp = path.with_suffix(".tmp")
        getattr(corpora, maker)(tmp, n=n, **kwargs)
        tmp.rename(path)
    return path


def batch_file(work):
    from swarm_tpu_torch import corpora

    path = work / f"dense400_{BATCH_CLOUD}.fasta"
    if not path.exists():
        tmp = path.with_suffix(".tmp")
        corpora.dense_cloud_corpus(tmp, n_centers=1, cloud=BATCH_CLOUD,
                                   length=400)
        tmp.rename(path)
    return path


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cli(argv, workdir, env, device):
    """One run of the port through main.run in `workdir`, the variables
    of `env` set: (seconds, the output files' bytes, metrics.last_run)."""
    from swarm_tpu_torch import metrics
    from swarm_tpu_torch.main import run

    workdir.mkdir(parents=True, exist_ok=True)
    cwd, real_err = os.getcwd(), sys.__stderr__
    env = {**QUIET, **env}
    saved = {k: os.environ.get(k) for k in env}
    os.chdir(workdir)
    sys.__stderr__ = io.StringIO()  # [timing] lines, when asked for
    os.environ.update(env)
    try:
        metrics.reset()
        sync(device)
        t0 = time.perf_counter()
        rc = run(argv + ["-l", "log.txt"], "swarm", device=device)
        sync(device)
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
    return sec, [(workdir / f).read_bytes() for f in OUTPUTS], \
        dict(metrics.last_run)


def in_turns(card, host, reps):
    """One call of each (warm-up, results compared), then `reps` calls
    of each in turns: (card seconds, host seconds, equal)."""
    _, want = host()
    _, got = card()
    equal = _same(got, want)
    secs = {"card": [], "host": []}
    for i in range(reps):
        for side, fn in (("card", card), ("host", host))[::1 - 2 * (i % 2)]:
            sec, out = fn()
            equal = equal and _same(out, want)
            secs[side].append(sec)
    return secs["card"], secs["host"], equal


def _same(a, b):
    import numpy as np

    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _record(rule, corpus, n, size, d, threads, card, host, equal, **extra):
    card_s, host_s = statistics.median(card), statistics.median(host)
    return {"rule": rule, "mode": "warm", "corpus": corpus, "n": n,
            "size": size, "d": d, "threads": threads, "host_s": host_s,
            "card_s": card_s, "host_runs_s": host, "card_runs_s": card,
            "card_won": card_s <= host_s, "equal": equal, **extra}


def measure_cli(rule, corpus, n, d, threads, work, device, reps=3):
    """A warm point of rule d1, d1f or d2: `swarm -d D -o -s -t T` (and
    the rule's FLAGS) on the corpus at n amplicons through main.run, each
    engine forced."""
    fasta = corpus_file(work, corpus, n)
    argv = FLAGS.get(rule, []) + [
        "-d", str(d), "-t", str(threads), "-o", OUTPUTS[0], "-s",
            OUTPUTS[1], str(fasta)]
    card_env, host_env = FORCE[rule]
    seen = {}

    def side(name, env):
        def call():
            sec, out, ran = run_cli(argv, work / "runs" / name, env, device)
            seen[name] = ran
            return sec, out
        return call

    card, host, equal = in_turns(side("card", card_env),
                                 side("host", host_env), reps)
    amplicons = fasta.read_bytes().count(b">")
    extra = {}
    if rule == "d2":
        extra["pairs"] = seen["card"].get("alignment_comparisons")
    return _record(rule, corpus, amplicons, n, d, threads, card, host,
                   equal, **extra)


def _scoring(options, d):
    from swarm_tpu_torch.params import Parameters, set_alignment_scoring_system

    p = Parameters()
    p.opt_differences = d
    for flag, value in zip(options[::2], options[1::2]):
        attr = {"-m": "opt_match_reward", "-p": "opt_mismatch_penalty",
                "-g": "opt_gap_opening_penalty",
                "-e": "opt_gap_extension_penalty"}[flag]
        setattr(p, attr, int(value))
    set_alignment_scoring_system(p)
    return p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend


class DiffsSetup:
    """The network engine of a corpus on `device` with its candidate
    pairs made (the screen ran: the state of a run when it reads the
    diffs rule)."""

    def __init__(self, corpus, n, d, work, device):
        from swarm_tpu_torch.corpora import read_db
        from swarm_tpu_torch.ops.d2_network import D2NetworkEngine

        self.db = read_db(corpus_file(work, corpus, n))
        self.eng = D2NetworkEngine(self.db, d, device)
        self.pa, self.pb, _ = self.eng.candidate_pairs()
        self.scores = _scoring([], d)
        self.device = device

    def call(self, side, size, threads):
        """One build_adjacency of `size` pairs on `side`: (seconds, the
        adjacency)."""
        import numpy as np
        import torch

        from swarm_tpu_torch.corpora import pairs_to_count

        ga, gb = (torch.from_numpy(x.astype(np.int32)).to(self.device)
                  for x in pairs_to_count(self.pa, self.pb, len(self.db),
                                          size))
        eng = self.eng
        eng.threads = threads
        eng.candidate_pairs_device = lambda shards=None: (ga, gb, size)
        eng.__dict__.pop("_diff_engine", None)  # a run builds its own
        env = FORCE["diffs"][side == "host"]
        saved = os.environ.get("SWARM_TPU_D2_DIFFS")
        os.environ.update(env)
        try:
            sync(self.device)
            t0 = time.perf_counter()
            adj = eng.build_adjacency(*self.scores, False)
            sync(self.device)
            sec = time.perf_counter() - t0
        finally:
            if saved is None:
                os.environ.pop("SWARM_TPU_D2_DIFFS")
            else:
                os.environ["SWARM_TPU_D2_DIFFS"] = saved
        return sec, list(adj)


def measure_diffs(setup, corpus, d, size, threads, reps=3):
    card, host, equal = in_turns(lambda: setup.call("card", size, threads),
                                 lambda: setup.call("host", size, threads),
                                 reps)
    return _record("diffs", corpus, len(setup.db), size, d, threads, card,
                   host, equal, pairs_made=len(setup.pa))


class BatchSetup:
    """One seed's gen-1 target list on a dense family, and the aligner's
    rows on `device` (the state of a device-engine run when it reads
    MIN_DEVICE_BATCH)."""

    def __init__(self, case, work, device):
        import numpy as np

        from swarm_tpu_torch import _native
        from swarm_tpu_torch.corpora import read_db
        from swarm_tpu_torch.ops.neighbors import pad_codes
        from swarm_tpu_torch.ops.qgram import qgram_profiles
        from swarm_tpu_torch.ops.search import set_bit_mode
        from swarm_tpu_torch.ops.search_torch import DeviceAligner

        self.d, options = BATCH_CASES[case]
        db = read_db(batch_file(work))
        self.n = len(db)
        self.lengths = db.lengths
        self.padded = pad_codes(db.codes, db.offsets, db.lengths,
                                max(int(db.longest), 1))
        self.scores = _scoring(options, self.d)
        self.bit_mode = set_bit_mode(self.d, *self.scores)
        self.cutoff = self.d * max(self.scores[0], sum(self.scores[1:]))
        # seed 0, the family's centre (the most abundant), against the
        # pool, as the seed loop's first screen finds it
        profiles = qgram_profiles(self.padded, db.lengths)
        ab = np.ascontiguousarray(db.abundances, dtype=np.int64)
        _, self.targets, _ = _native.d2_gen1_screen(
            profiles, np.arange(self.n, dtype=np.int64), ab,
            np.zeros(self.n, dtype=np.int64), 1, 0, int(ab[0]), False,
            self.d)
        self.aligner = DeviceAligner(self.padded, db.lengths, device)
        self.device = device

    def call(self, side, size):
        """The diffs of seed 0 against `size` targets, as
        models/general.py's aligner() gives them: (seconds, diffs capped
        at d + 1, accepted count on the card or None)."""
        import numpy as np

        from swarm_tpu_torch.ops.search import search_diffs_ref

        ids = np.resize(self.targets, size)
        sync(self.device)
        t0 = time.perf_counter()
        compute = None
        if side == "card":
            scr = self.aligner.scores(0, ids, *self.scores,
                                      cutoff=self.cutoff)
            compute = scr <= self.cutoff
        rows = self.padded[ids]
        lens = self.lengths[ids]
        _, diffs, _ = search_diffs_ref(
            self.padded[0, : self.lengths[0]], rows[:, : int(lens.max())],
            lens, *self.scores, self.bit_mode, compute)
        sec = time.perf_counter() - t0
        return sec, np.minimum(diffs, self.d + 1), (
            None if compute is None else int(compute.sum()))


def measure_batch(setup, case, size, reps=3):
    accepted = []

    def card():
        sec, diffs, acc = setup.call("card", size)
        accepted.append(acc)
        return sec, diffs

    card_s, host_s, equal = in_turns(
        card, lambda: setup.call("host", size)[:2], reps)
    return _record("batch", case, setup.n, size, setup.d, 1, card_s, host_s,
                   equal, accepted_on_card=accepted[0],
                   list_found=len(setup.targets))


def crossover(points):
    """(last size the host won, first size from which the card won at
    that and every larger size) of one series; None where there is
    none."""
    points = sorted(points, key=lambda p: p["size"])
    first = None
    for p in reversed(points):
        if not p["card_won"]:
            break
        first = p["size"]
    lost = [p["size"] for p in points if not p["card_won"]]
    return (max(lost) if lost else None), first


def series_key(p):
    return (p["rule"], p["mode"], p["corpus"], p["d"], p["threads"])


def summary(points, card):
    """The crossovers of every series, and each rule's number: the
    largest first size the card won over its series (null when the card
    did not win the top of some series)."""
    series = {}
    for p in points:
        series.setdefault(series_key(p), []).append(p)
    out, rules = [], {}
    for key, pts in sorted(series.items(), key=lambda kv: str(kv[0])):
        last_host, first_card = crossover(pts)
        out.append({"rule": key[0], "mode": key[1], "corpus": key[2],
                    "d": key[3], "threads": key[4],
                    "last_host_won": last_host,
                    "first_card_won": first_card})
        rule = rules.setdefault(key[0], {"number": 0, "card_never_won": []})
        if first_card is None:
            rule["card_never_won"].append(list(key[1:]))
        else:
            rule["number"] = max(rule["number"], first_card)
    return {"card": card, "series": out, "rules": rules}


def cold_cli(rule, corpus, n, d, threads, work, device, reps=1):
    """A cold point of rule d1, d1f or d2: bin/swarm-torch in a fresh
    process for each engine, `reps` of each in turns (card, host, host,
    card, ...)."""
    fasta = corpus_file(work, corpus, n)
    argv = FLAGS.get(rule, []) + [
        "-d", str(d), "-t", str(threads), "-o", OUTPUTS[0], "-s",
        OUTPUTS[1], "-l", "log.txt", str(fasta)]
    rec = {"card": [], "host": []}
    envs = dict(zip(("card", "host"), FORCE[rule]))
    for i in range(reps):
        for side in ("card", "host")[::1 - 2 * (i % 2)]:
            cwd = work / "cold" / side
            cwd.mkdir(parents=True, exist_ok=True)
            stamps = cwd / "stamps.json"
            full_env = {**os.environ, **QUIET, **envs[side],
                        "PYTHONPATH": str(REPO)}
            full_env.pop("SWARM_TORCH_SERVER", None)
            if str(device) == "cpu":
                full_env["SWARM_TORCH_DEVICE"] = "cpu"
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-c",
                 COLD_PROBE.format(launcher=str(LAUNCHER)), str(stamps),
                 *argv], cwd=cwd, env=full_env, capture_output=True,
                timeout=900)
            process_s = time.perf_counter() - t0
            if r.returncode != 0:
                raise AssertionError(
                    f"cold {side} run of {argv} returned {r.returncode}:\n"
                    f"{r.stderr.decode()[-2000:]}")
            t = json.loads(stamps.read_text())
            rec[side].append((t["end"] - t["torch"], process_s,
                              [(cwd / f).read_bytes() for f in OUTPUTS]))
    amplicons = fasta.read_bytes().count(b">")
    return _cold_record(rule, corpus, amplicons, n, d, threads, rec)


def _cold_record(rule, corpus, n, size, d, threads, rec):
    """rec: side -> [(seconds, process seconds or None, outputs)], one a
    fresh process; the medians, and whether every output is equal."""
    secs = {side: [r[0] for r in runs] for side, runs in rec.items()}
    card_s = statistics.median(secs["card"])
    host_s = statistics.median(secs["host"])
    want = rec["host"][0][2]
    return {"rule": rule, "mode": "cold", "corpus": corpus, "n": n,
            "size": size, "d": d, "threads": threads, "host_s": host_s,
            "card_s": card_s, "host_runs_s": secs["host"],
            "card_runs_s": secs["card"],
            "host_process_s": [r[1] for r in rec["host"]],
            "card_process_s": [r[1] for r in rec["card"]],
            "card_won": card_s <= host_s,
            "equal": all(_same(r[2], want)
                         for runs in rec.values() for r in runs)}


def point_main(spec):
    """--point: one cold point of rule diffs or batch in this (fresh)
    process; prints its JSON line."""
    import torch

    work = Path(spec["work"])
    device = torch.device(spec["device"])
    if spec["rule"] == "diffs":
        setup = DiffsSetup(spec["corpus"], spec["n"], spec["d"], work,
                           device)
        rec = {side: setup.call(side, spec["size"], spec["threads"])
               for side in ("card", "host")}
        n = len(setup.db)
    else:
        setup = BatchSetup(spec["corpus"], work, device)
        rec = {side: setup.call(side, spec["size"])[:2]
               for side in ("card", "host")}
        n = setup.n
    out = _cold_record(spec["rule"], spec["corpus"], n, spec["size"],
                       spec["d"], spec["threads"],
                       {k: [(v[0], None, v[1])] for k, v in rec.items()})
    print(json.dumps(out), flush=True)


def cold_point(rule, corpus, size, d, threads, work, device, n=DIFFS_N,
               reps=1):
    """A cold point of rule diffs or batch: this script's --point in
    `reps` fresh processes, each timing the card's first call and then
    the host's (n: the diffs corpus' amplicons); the medians."""
    spec = {"rule": rule, "corpus": corpus, "size": size, "d": d,
            "threads": threads, "work": str(work), "device": str(device),
            "n": n}
    recs, process_s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--point",
             json.dumps(spec)], env={**os.environ, **QUIET},
            capture_output=True, text=True, timeout=900)
        process_s.append(time.perf_counter() - t0)
        if r.returncode != 0:
            raise AssertionError(f"cold point {spec} returned "
                                 f"{r.returncode}:\n{r.stderr[-2000:]}")
        recs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    rec = recs[0]
    for side in ("card", "host"):
        rec[f"{side}_runs_s"] = [x[f"{side}_s"] for x in recs]
        rec[f"{side}_s"] = statistics.median(rec[f"{side}_runs_s"])
    rec["card_won"] = rec["card_s"] <= rec["host_s"]
    rec["equal"] = all(x["equal"] for x in recs)
    rec["process_s"] = process_s
    return rec


class Sweep:
    """Runs the rules' points and prints each line as it comes."""

    def __init__(self, work, device, reps, out=None, cold_reps=1):
        self.work, self.device, self.reps, self.out = work, device, reps, out
        self.cold_reps = cold_reps
        self.points = []

    def emit(self, rec):
        if rec["mode"] == "cold":
            # what a fresh process adds to the card's side beyond what it
            # adds to the host's, where the size was also measured warm
            warm = [p for p in self.points if p["size"] == rec["size"] and
                    series_key(p) == (rec["rule"], "warm", *series_key(rec)[2:])]
            if warm:
                rec["first_use_s"] = (rec["card_s"] - warm[0]["card_s"]) - (
                    rec["host_s"] - warm[0]["host_s"])
        self.points.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if self.out is not None:
            with open(self.out, "a") as fh:
                fh.write(line + "\n")
        if not rec["equal"]:
            raise AssertionError(f"the engines' outputs differ: {line}")
        return rec

    def warm_first(self, rule, corpus, d, threads):
        pts = [p for p in self.points if p["mode"] == "warm" and
               series_key(p) == (rule, "warm", corpus, d, threads)]
        return crossover(pts)

    def cold_series(self, rule, corpus, d, threads, one, sizes=None):
        """Cold points at each of `sizes` when given (--cold-only), else
        from the warm crossover up: 1x, 2x, 4x, then doubling while the
        card lost, up to COLD_MAX."""
        if sizes is not None:
            for size in sizes:
                self.emit(one(size))
            return
        _, first = self.warm_first(rule, corpus, d, threads)
        if first is None:
            return  # the card lost warm at the top: cold adds to its side
        size = first
        while size <= COLD_MAX[rule]:
            rec = self.emit(one(size))
            if size >= 4 * first and rec["card_won"]:
                break
            size *= 2

    def d1(self, sizes=D1_SIZES, corpora=("gen150", "mixed"), threads=None,
           cold=True, cold_only=False, rule="d1"):
        threads = threads or sorted({1, cores()})
        if not cold_only:
            for corpus in corpora:
                for t in threads:
                    for n in sizes:
                        self.emit(measure_cli(rule, corpus, n, 1, t,
                                              self.work, self.device,
                                              self.reps))
        if cold:
            for corpus in corpora:
                for t in threads:
                    self.cold_series(
                        rule, corpus, 1, t,
                        lambda n: cold_cli(rule, corpus, n, 1, t, self.work,
                                           self.device, self.cold_reps),
                        sizes if cold_only else None)

    def d1f(self, sizes=D1_SIZES, corpora=("fast", "fast_asym"),
            threads=None, cold=True, cold_only=False):
        self.d1(sizes, corpora, threads, cold, cold_only, rule="d1f")

    def d2(self, sizes=D2_SIZES, corpora=("gen150", "gen400"), ds=None,
           cold=True, cold_only=False):
        if not cold_only:
            for corpus in corpora:
                for d in ds or D2_DS:
                    for n in sizes:
                        self.emit(measure_cli("d2", corpus, n, d, 1,
                                              self.work, self.device,
                                              self.reps))
                if cores() > 1:
                    last_host, _ = self.warm_first("d2", corpus, 2, 1)
                    self.emit(measure_cli("d2", corpus,
                                          last_host or sizes[0], 2,
                                          cores(), self.work, self.device,
                                          self.reps))
        if cold:
            for corpus in corpora:
                for d in ds or COLD_DS:
                    self.cold_series(
                        "d2", corpus, d, 1,
                        lambda n: cold_cli("d2", corpus, n, d, 1, self.work,
                                           self.device, self.cold_reps),
                        sizes if cold_only else None)

    def diffs(self, sizes=DIFFS_SIZES, corpora=("gen150", "gen400"),
              ds=DIFFS_DS, threads=None, cold=True, cold_only=False,
              n=DIFFS_N):
        threads = threads or sorted({1, cores()})
        if not cold_only:
            for corpus in corpora:
                for d in ds:
                    setup = DiffsSetup(corpus, n, d, self.work, self.device)
                    for t in threads:
                        for size in sizes:
                            self.emit(measure_diffs(setup, corpus, d, size,
                                                    t, self.reps))
                    del setup
        if cold:
            for corpus in corpora:
                for d in ds:
                    for t in threads:
                        self.cold_series(
                            "diffs", corpus, d, t,
                            lambda s: cold_point("diffs", corpus, s, d, t,
                                                 self.work, self.device, n,
                                                 self.cold_reps),
                            sizes if cold_only else None)

    def batch(self, sizes=BATCH_SIZES, corpora=tuple(BATCH_CASES), cold=True,
              cold_only=False):
        if not cold_only:
            for case in corpora:
                setup = BatchSetup(case, self.work, self.device)
                for size in sizes:
                    self.emit(measure_batch(setup, case, size, self.reps))
                del setup
        if cold:
            for case in corpora:
                self.cold_series(
                    "batch", case, BATCH_CASES[case][0], 1,
                    lambda s: cold_point("batch", case, s,
                                         BATCH_CASES[case][0], 1, self.work,
                                         self.device, reps=self.cold_reps),
                    sizes if cold_only else None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rules", nargs="+", choices=RULES, default=RULES)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cold-reps", type=int, default=3)
    cold = ap.add_mutually_exclusive_group()
    cold.add_argument("--no-cold", action="store_true")
    cold.add_argument("--cold-only", action="store_true")
    ap.add_argument("--sizes", type=int, nargs="+")
    ap.add_argument("--corpora", nargs="+",
                    choices=sorted({*CORPORA, *BATCH_CASES}))
    ap.add_argument("--ds", type=int, nargs="+")
    ap.add_argument("--threads", type=int, nargs="+")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--point", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    if args.point:
        point_main(json.loads(args.point))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("FAIL no CUDA device", flush=True)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    from swarm_tpu_torch import _build, _native

    t0 = time.perf_counter()
    _native.available()
    _build.load()
    # the first process to import a module writes its bytecode: not a
    # cost of the first cold point's engine
    compileall.compile_dir(REPO / "swarm_tpu_torch", quiet=1)
    print(f"kernel library built and loaded in "
          f"{time.perf_counter() - t0:.1f}s; {cores()} cores", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(card + "\n")
    with tempfile.TemporaryDirectory(prefix="dispatch_sweep_") as tmp:
        sweep = Sweep(Path(tmp), torch.device("cuda", 0), args.reps,
                      args.out, args.cold_reps)
        for rule in args.rules:
            method = getattr(sweep, rule)
            given = {k: tuple(v) for k in ("sizes", "corpora", "ds",
                                          "threads")
                     if (v := getattr(args, k)) is not None and
                     k in inspect.signature(method).parameters}
            method(cold=not args.no_cold, cold_only=args.cold_only, **given)
    line = json.dumps({"crossovers": summary(sweep.points, card)})
    print(line, flush=True)
    if args.out is not None:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
