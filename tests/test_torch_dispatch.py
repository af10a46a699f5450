"""The port's engine-dispatch rules and scripts/dispatch_sweep.py, the
committed source of their thresholds, on the CPU.

- The device-diffs rule of D2NetworkEngine.build_adjacency at its
  threshold - 1 and at it, with the device kernel replaced by a
  recording stub and the engine's device reported as cuda.
- The sweep's measuring functions on a corpus of about 200 amplicons
  for each rule: both engines give equal outputs and each JSON line
  carries its fields. (The numbers the sweep gives on the CPU are no
  card's; the thresholds come from its run on the card, PERF.md §5.)
- The sweep's crossover: the last size the host won and the first size
  from which the card won at every larger size.
"""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from swarm_tpu_torch import _native, device
from swarm_tpu_torch.corpora import gen_corpus, read_db
from swarm_tpu_torch.ops import d2_diffs
from swarm_tpu_torch.ops.d2_network import D2NetworkEngine

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import dispatch_sweep as sweep  # noqa: E402

CPU = torch.device("cpu")
FIELDS = {"rule", "mode", "corpus", "n", "size", "d", "threads", "host_s",
          "card_s", "host_runs_s", "card_runs_s", "card_won", "equal"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ("SWARM_TPU_D2_DIFFS", "SWARM_TPU_D2_ENGINE",
                 "SWARM_TPU_D1_NATIVE_MAX", "SWARM_TPU_D2_TILE"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("threads", [1, 8])
def test_device_diffs_from_their_threshold(tmp_path, monkeypatch, threads,
                                           warm):
    """auto: native diffs below DEVICE_DIFFS_MIN pairs (at -t 1;
    DEVICE_DIFFS_MIN_THREADED above; their _COLD forms before the kernel
    has launched in the process), the device kernel from it up (on a
    cuda engine); the same adjacency. The pairs are every pair of the
    corpus in (a, b) order, an order the screen's CSR takes (each pair
    once, a source's targets ascending in both directions), cut to the
    sizes tried."""
    gen_corpus(tmp_path / "in.fasta", n=400, length=150)
    db = read_db(tmp_path / "in.fasta")
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "128")
    eng = D2NetworkEngine(db, 2, CPU, threads=threads)
    pa, pb = (x.astype(np.int64) for x in np.triu_indices(len(db), k=1))
    assert len(pa) >= 65_536
    calls = []

    class Recording:
        """Stands in for the device kernel: records the pairs it was
        given and answers with the native diffs, laid out as its tasks
        on the CPU (so the CSR takes its plain version)."""

        def __init__(self, db, d, device):
            self.db, self.d = db, d

        def diff_tasks(self, ga, gb, mismatch, gapopen, gapextend,
                       no_break):
            pa, pb = (x.numpy().astype(np.int64) for x in (ga, gb))
            calls.append(len(pa))
            diff_ab, diff_ba = _native.d2_diffs_pairs(
                self.db.codes, self.db.offsets, self.db.lengths,
                self.db.abundances, pa, pb, self.d, mismatch, gapopen,
                gapextend, no_break)
            need_ab, need_ba = d2_diffs.directions(self.db.abundances, pa,
                                                   pb, no_break)
            tasks = (np.concatenate([pb[need_ba], pa[need_ab]]),
                     np.concatenate([pa[need_ba], pb[need_ab]]),
                     np.concatenate([diff_ba[need_ba],
                                     diff_ab[need_ab]]).astype(np.int32))
            return tuple(torch.from_numpy(x) for x in tasks)

    monkeypatch.setattr(d2_diffs, "DeviceDiffEngine", Recording)
    monkeypatch.setattr(d2_diffs, "warm", warm)
    eng.device = torch.device("cuda", 0)  # no launch: the stub answers
    # measured on the card (scripts/dispatch_sweep.py, PERF.md §5)
    at = {(1, True): 1_024, (8, True): 8_192, (1, False): 16_384,
          (8, False): 65_536}[threads, warm]
    assert at == getattr(D2NetworkEngine, "DEVICE_DIFFS_MIN"
                         + ("_THREADED" if threads > 1 else "")
                         + ("" if warm else "_COLD"))
    got = {}
    ga, gb = (torch.from_numpy(x.astype(np.int32)) for x in (pa, pb))
    for size in (at - 1, at):
        qa, qb = ga[:size], gb[:size]
        eng.candidate_pairs_device = lambda shards=None: (qa, qb, size)
        eng.__dict__.pop("_diff_engine", None)
        got[size] = eng.build_adjacency(18, 24, 13, False)
    assert calls == [at]
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "native")
    eng.__dict__.pop("_diff_engine", None)
    want = eng.build_adjacency(18, 24, 13, False)
    assert calls == [at]
    for x, y in zip(got[at], want):
        np.testing.assert_array_equal(x, y)
    # the override still forces the kernel below the threshold, and
    # a CPU engine never takes it unasked
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "device")
    qa, qb = ga[:1], gb[:1]
    eng.candidate_pairs_device = lambda shards=None: (qa, qb, 1)
    eng.__dict__.pop("_diff_engine", None)
    eng.build_adjacency(18, 24, 13, False)
    assert calls == [at, 1]
    monkeypatch.delenv("SWARM_TPU_D2_DIFFS")
    eng.device = CPU
    qa, qb = ga[:at], gb[:at]
    eng.candidate_pairs_device = lambda shards=None: (qa, qb, at)
    eng.__dict__.pop("_diff_engine", None)
    eng.build_adjacency(18, 24, 13, False)
    assert calls == [at, 1]


def test_fastidious_runs_take_the_graft_threshold(monkeypatch, tmp_path):
    """-f's graft takes the card whatever n on a CUDA device (unless
    SWARM_TPU_GRAFT_PROBE_MAX is set) and in a sharded run, so the d=1
    network's rule knows it (NeighborIndex.graft_on_card): a fresh
    process takes NATIVE_MAX_GRAFT then, NATIVE_MAX_COLD without it, and
    one that holds the card NATIVE_MAX either way."""
    from swarm_tpu_torch import parallel
    from swarm_tpu_torch.main import run
    from swarm_tpu_torch.models import d1
    from swarm_tpu_torch.ops.neighbors import NeighborIndex

    cuda = torch.device("cuda", 0)
    monkeypatch.delenv("SWARM_TPU_GRAFT_PROBE_MAX", raising=False)
    monkeypatch.setattr(parallel, "requested", lambda: False)
    assert d1._graft_on_card(cuda) and not d1._graft_on_card(CPU)
    monkeypatch.setattr(parallel, "requested", lambda: True)
    assert d1._graft_on_card(CPU)
    monkeypatch.setattr(parallel, "requested", lambda: False)
    monkeypatch.setenv("SWARM_TPU_GRAFT_PROBE_MAX", "0")
    assert not d1._graft_on_card(cuda)
    monkeypatch.delenv("SWARM_TPU_GRAFT_PROBE_MAX")

    seen = []

    class Recording(NeighborIndex):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self.graft_on_card)

    monkeypatch.setattr(d1, "NeighborIndex", Recording)
    monkeypatch.setattr(d1, "_graft_on_card", lambda device: True)
    gen_corpus(tmp_path / "in.fasta", n=200, length=150)
    monkeypatch.chdir(tmp_path)
    for flags in (["-f"], []):
        assert run(["-d", "1", *flags, "-o", "out.txt", "in.fasta"],
                   "swarm", device="cpu") == 0
    assert seen == [True, False]
    # the rule at its thresholds, measured on the card
    # (scripts/dispatch_sweep.py, PERF.md §5)
    assert NeighborIndex.NATIVE_MAX_GRAFT == 65_536
    for ready, graft, at in ((False, True, 65_536), (False, False, 262_144),
                             (True, True, 4_096), (True, False, 4_096)):
        monkeypatch.setattr(device, "card_ready", lambda: ready)
        for n, native in ((at - 1, True), (at, False)):
            rows = types.SimpleNamespace(longest=150,
                                         lengths=np.full(n, 150))
            assert NeighborIndex(rows, device="cpu",
                                 graft_on_card=graft).uses_native() == native


def _sweep_point(rule, work, monkeypatch):
    if rule == "d1":
        return sweep.measure_cli("d1", "gen150", 200, 1, 2, work, CPU, reps=1)
    if rule == "d1f":
        return sweep.measure_cli("d1f", "fast", 200, 1, 2, work, CPU, reps=1)
    if rule == "d2":
        return sweep.measure_cli("d2", "gen400", 200, 2, 1, work, CPU, reps=1)
    if rule == "diffs":
        setup = sweep.DiffsSetup("gen150", 200, 2, work, CPU)
        return sweep.measure_diffs(setup, "gen150", 2, 48, 2, reps=1)
    monkeypatch.setattr(sweep, "BATCH_CLOUD", 99)  # 200 amplicons
    setup = sweep.BatchSetup("d2_wide", work, CPU)
    return sweep.measure_batch(setup, "d2_wide", 48, reps=1)


@pytest.mark.parametrize("rule", sweep.RULES)
def test_sweep_measures_each_rule_on_the_cpu(rule, tmp_path, monkeypatch):
    rec = _sweep_point(rule, tmp_path, monkeypatch)
    assert FIELDS <= set(rec)
    assert rec["rule"] == rule and rec["mode"] == "warm"
    assert rec["equal"] is True
    assert 150 <= rec["n"] <= 200
    assert len(rec["card_runs_s"]) == len(rec["host_runs_s"]) == 1
    assert rec["card_won"] == (rec["card_s"] <= rec["host_s"])
    if rule == "d2":
        assert rec["pairs"] > 0
    if rule == "batch":
        assert rec["d"] == 5 and rec["list_found"] > 0
    assert json.loads(json.dumps(rec)) == rec


def _pt(size, card_won, **key):
    return {"rule": "d1", "mode": "warm", "corpus": "gen150", "d": 1,
            "threads": 1, "size": size, "card_won": card_won, **key}


@pytest.mark.parametrize("wins,want", [
    ((False, False, True, True), (2, 4)),
    ((True, True, True, True), (None, 1)),
    ((False, False, False, False), (8, None)),
    # a win below a loss does not count: the card must win on upward
    ((False, True, False, True), (4, 8)),
    ((True, True, True, False), (8, None)),
])
def test_crossover_is_the_first_size_the_card_kept_winning(wins, want):
    points = [_pt(1 << k, w) for k, w in enumerate(wins)]
    assert sweep.crossover(points[::-1]) == want
    got = sweep.summary(points, "card")
    assert got["series"][0]["last_host_won"] == want[0]
    assert got["series"][0]["first_card_won"] == want[1]
    rule = got["rules"]["d1"]
    assert rule["number"] == (want[1] or 0)
    assert rule["card_never_won"] == ([] if want[1] else [
        ["warm", "gen150", 1, 1]])
