"""The benchmark's plain reference of -d 1 -f (swarmbench/references/d1f.py)
against the port (swarm_tpu_torch, on the CPU: by its dispatch, and with
the sort-join network and the device graft forced) and against
swarm_tpu, on seeded reads corpora and on hand-made cases; the control
fails; the cells' files load."""

import functools
import json
import os

import pytest
import torch

from swarm_tpu.main import run as jax_run
from swarm_tpu_torch.main import run as torch_run
from swarm_tpu_torch.ops import neighbors
from swarmbench import check, harness
from swarmbench.corpus import Corpus
from swarmbench.generators import reads
from swarmbench.harness import Run
from swarmbench.references import d1f

CONFIG = harness.find_cell("d1f_150nt_1m")[2]
OUTPUTS = CONFIG["outputs"]
#: the port's sort-join network and device graft, forced at any n
FORCED = {"SWARM_TPU_D1_NATIVE_MAX": "0", "SWARM_TPU_GRAFT_PROBE_MAX": "0"}


def reads_corpus(amplicons, per_base, seed):
    """The 1M cell's traffic at `amplicons` amplicons (its community cut
    in proportion, with twice the room), at `per_base` errors."""
    params = dict(harness.find_cell("d1f_150nt_1m")[3])
    params["community"] = dict(params["community"], sequences=max(
        100, 2 * params["community"]["sequences"] * amplicons
        // params["amplicons"]))
    params["errors"] = dict(params["errors"], per_base=per_base)
    params["amplicons"] = amplicons
    return reads.make_corpus(params, seed)


@functools.lru_cache(maxsize=None)
def reads_case(amplicons, per_base, seed):
    """(corpus, the reference's result) of a reads corpus, made once in
    this module and shared by the tests that use it."""
    corp = reads_corpus(amplicons, per_base, seed)
    return corp, d1f.cluster(corp, CONFIG, "cpu")


def run_side(side, corp, work, env=None):
    """One -d 1 -f run of `side` ("torch" or "jax") on the corpus:
    (tag-free streams, the port's network edges or None)."""
    work.mkdir(parents=True, exist_ok=True)
    tag = corp.write(work / "in.fasta", 1)
    argv = list(CONFIG["args"])
    for flag in OUTPUTS:
        argv += [flag, str(work / f"out{flag}")]
    argv += ["-l", str(work / "log.txt"), str(work / "in.fasta")]
    seen = []
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith(("SWARM_TPU_", "SWARM_TORCH_"))}
    os.environ.update(env or {})
    build = neighbors.NeighborIndex.build_network

    def capture(index, *args, **kwargs):
        seen.append(build(index, *args, **kwargs))
        return seen[-1]

    neighbors.NeighborIndex.build_network = capture
    try:
        rc = torch_run(argv, "swarm", device="cpu") if side == "torch" \
            else jax_run(argv, "swarm")
    finally:
        neighbors.NeighborIndex.build_network = build
        for k in env or {}:
            os.environ.pop(k)
        os.environ.update(saved)
    assert rc == 0
    streams = {f: (work / f"out{f}").read_bytes().replace(tag, b"")
               for f in OUTPUTS}
    return streams, d1f.program_edges(seen[-1]) if seen else None


def numbers(ref, streams, edges, n):
    return check.compare(ref, [Run(edges=edges, streams=streams)], n)


def assert_all_equal(corp, tmp_path, ref=None):
    """The reference (`ref`, or computed here), the port by its dispatch
    and forced, and swarm_tpu agree exactly; returns the reference's
    result."""
    ref = ref or d1f.cluster(corp, CONFIG, "cpu")
    want, _ = run_side("jax", corp, tmp_path / "jax")
    for name, env in (("dispatch", None), ("forced", FORCED)):
        got, edges = run_side("torch", corp, tmp_path / name, env)
        assert got == want, name
        counts = numbers(ref, got, edges, corp.n)
        assert set(counts.values()) == {0}, (name, counts)
    return ref


READS = [(3000, 0.001, 2 ** 33 + 5), (4000, 0.01, 2 ** 31 + 11)]


@pytest.mark.parametrize("amplicons,per_base,seed", READS,
                         ids=["reads", "reads_high_errors"])
def test_reference_equals_port_and_swarm_tpu(tmp_path, amplicons, per_base,
                                             seed):
    corp, ref = reads_case(amplicons, per_base, seed)
    assert_all_equal(corp, tmp_path, ref)
    assert ref.counts["edges"] > 0
    # many light swarms grafted: every reads corpus has some, the one of
    # more errors hundreds
    assert ref.counts["grafts"] >= (300 if per_base > 0.005 else 100)


ACGT = {c: k for k, c in enumerate("ACGT")}


def hand_corpus(rows):
    """A Corpus of (label number, sequence, abundance) rows, in that file
    order; headers b<number>_<abundance>."""
    width = max(len(s) for _, s, _ in rows)
    codes = torch.zeros((len(rows), width), dtype=torch.uint8)
    for i, (_, seq, _) in enumerate(rows):
        codes[i, :len(seq)] = torch.tensor([ACGT[c] for c in seq])
    return Corpus(codes=codes,
                  lengths=torch.tensor([len(s) for _, s, _ in rows]),
                  abundances=torch.tensor([a for _, _, a in rows]),
                  labels=torch.tensor([k for k, _, _ in rows]), label=b"b")


def _sub(seq, at):
    """seq with the base at `at` replaced by the next one of ACGT."""
    return seq[:at] + "ACGT"[(ACGT[seq[at]] + 1) % 4] + seq[at + 1:]


def _random(seed, length=64):
    g = torch.Generator().manual_seed(seed)
    return "".join("ACGT"[int(k)] for k in torch.randint(0, 4, (length,),
                                                         generator=g))


def _homopolymer():
    """A deletion inside a run of six Ts: one edge, whichever T goes."""
    base = _random(1)
    seq = base[:20] + "TTTTTT" + base[26:]
    return [(1, seq, 9), (2, seq[:22] + seq[23:], 1),
            (3, _sub(seq, 40), 1), (4, _random(2), 1)]


def _kept_apart():
    """L (abundance 2) lies at distance 1 from X (abundance 1), but the
    edge goes L -> X only, and X was claimed first by S's swarm (S -> P
    -> X, P and X tied): L's swarm is light, and its candidate is X, the
    lowest-id heavy amplicon within 2 (P, also within 2, sorts after X
    by its header; S lies 3 away)."""
    s = _random(3)
    p = _sub(s, 10)
    x = _sub(p, 20)
    low = _sub(x, 30)
    return [(7, p, 1), (5, low, 2), (1, s, 10), (2, x, 1)]


def _two_heavy():
    """A light swarm {L1, L2} (both of abundance 1: edges both ways)
    whose members have candidates in two heavy swarms, A and B: the
    first pair (A, L1) grafts it onto A, once."""
    a = _random(4)
    b = a
    for at in (5, 15, 25, 35, 45):
        b = _sub(b, at)
    l1 = _sub(_sub(a, 5), 15)
    l2 = _sub(l1, 25)
    return [(3, l2, 1), (1, a, 5), (2, b, 4), (4, l1, 1)]


def _ties():
    """Ties in abundance: a centre of 3 and variants of 1 whose header
    order (b10 < b11 < b2 < b9) is not their file order, chained at
    distance 1 among themselves."""
    c = _random(5)
    v1 = _sub(c, 8)
    v2 = _sub(v1, 16)
    v3 = _sub(v2, 24)
    far = _random(6)
    return [(9, v3, 1), (2, v2, 1), (11, v1, 1), (10, c, 3),
            (12, far, 1), (13, _sub(far, 3), 1), (14, _random(7), 2)]


@pytest.mark.parametrize("case", [_homopolymer, _kept_apart, _two_heavy,
                                  _ties],
                         ids=lambda f: f.__name__.strip("_"))
def test_hand_made_cases(tmp_path, case):
    corp = hand_corpus(case())
    ref = assert_all_equal(corp, tmp_path)
    streams = {k: bytes(v.numpy()) for k, v in ref.streams.items()}
    if case is _homopolymer:
        assert b"b1\tb2\t1\t1\t1\n" in streams["-i"]
    if case is _kept_apart:
        assert streams["-i"].endswith(b"b2\tb5\t2\t1\t3\n")
    if case is _two_heavy:
        # one graft line, L1 onto A (swarm 1), though L2 (b3) is the
        # light swarm's seed; the swarm follows A whole, in its order
        assert streams["-i"].count(b"\t2\t") == 1
        assert b"b1\tb4\t2\t1\t1\n" in streams["-i"]
        assert streams["-o"].split(b"\n")[0] == b"b1_5 b3_1 b4_1"
    if case is _ties:
        assert streams["-o"].split(b"\n")[0] == b"b10_3 b11_1 b2_1 b9_1"


def test_control_fails_the_comparison():
    """The Hamming control against the reference: it loses every indel
    edge and graft, on three corpora (the two above, and one more)."""
    for case in READS + [(3000, 0.001, 1)]:
        corp, ref = reads_case(*case)
        ctl = d1f.cluster(corp, CONFIG, "cpu", control=True)
        got = {k: bytes(v.numpy()) for k, v in ctl.streams.items()}
        correct, table = check.verdict(numbers(ref, got, ctl.edges, corp.n))
        assert not correct
        assert table["edges_missing"]["value"] > 0
        assert table["edges_extra"]["value"] == 0


def test_cells_load_through_the_harness():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    _, cell, config, traffic = harness.find_cell("d1f_150nt_1m")
    assert cell in bench["workloads"]
    assert config["name"] == cell["config"] == "swarm-d1-fastidious-150nt"
    assert config["args"] == ["-d", "1", "-f"] and config["d"] == 1
    assert harness.load_part("references", config["reference"]).ENGINE == (
        "swarm_tpu_torch.ops.neighbors", "NeighborIndex", "build_network")
    assert traffic["amplicons"] == 1_000_000
    _, cell, config, traffic = harness.find_cell("d2_150nt_fixed_500k")
    assert config["name"] == "swarm-d2-150nt"
    assert traffic["truncate"] == 150 and traffic["amplicons"] == 500_000
    small = dict(traffic, amplicons=2000,
                 community=dict(traffic["community"], sequences=228))
    corp = reads.make_corpus(small, 2 ** 32 + 3)
    assert int(corp.lengths.min()) == int(corp.lengths.max()) == 150
    names = {m["name"] for m in bench["per_layer"]
             if "d1f_150nt_1m" in m.get("workloads", [])}
    assert len(names) == 12 and {"db.read_s", "device.idle_pct"} < names
    for name in names:
        assert callable(harness.metric_reader(name))
    # every per-layer metric of the d>=2 cells is read in the fixed one
    for m in bench["per_layer"]:
        if "d2_150nt_500k" in m["workloads"]:
            assert "d2_150nt_fixed_500k" in m["workloads"], m["name"]


def test_harness_runs_the_cell_correct_and_traced(tmp_path, monkeypatch):
    """The harness's whole run of the cell's files at 2,000 amplicons on
    the CPU, traced, with the port's sort-join network and device graft
    forced: correct, every check number 0, and the per-layer metrics that
    a CPU run can read (no kernel runs there)."""
    import shutil

    root = tmp_path / "root"
    (root / "swarmbench").mkdir(parents=True)
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "cells", "metrics", "generators",
                "references"):
        shutil.copytree(harness.ROOT / "swarmbench" / sub,
                        root / "swarmbench" / sub)
    shutil.copy(harness.ROOT / "swarmbench" / "peaks.json",
                root / "swarmbench" / "peaks.json")
    params = harness.find_cell("d1f_150nt_1m")[3]
    params = dict(params, amplicons=2000, community=dict(
        params["community"], sequences=220))
    (root / "swarmbench" / "traffic" / "tiny_d1f.json").write_text(
        json.dumps(params))
    (root / "swarmbench" / "cells" / "tiny_d1f.json").write_text(json.dumps(
        {"name": "tiny_d1f", "config": "swarm-d1-fastidious-150nt",
         "traffic": "tiny_d1f", "chips": 1, "why": "test"}))
    for key, value in FORCED.items():
        monkeypatch.setenv(key, value)
    # this test process holds JAX (tests/conftest.py, swarm_tpu above):
    # the harness's refusal of it is for its own processes
    monkeypatch.setattr(harness, "FORBIDDEN", ())
    # a traced run points SWARM_TPU_TRACE at its own temporary folder, for
    # the process it runs in: the tests after this one get theirs back
    saved = dict(os.environ)
    try:
        result = harness.run_cell("tiny_d1f", 2 ** 31 + 17, 0.5, 1, "cpu",
                                  root)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert "SWARM_TPU_TRACE" not in os.environ
    assert result["correct"] is True, result["check"]
    assert {row["value"] for row in result["check"].values()} == {0}
    assert set(result["check"]) == set(check.LIMITS)
    assert result["failed"] == 0 and result["attempted"] >= 1
    # a cell kept out of BENCHMARK.json reports every metric it can read
    want = {"d1_network.build_s", "d1_network.finish_s",
            "d1_network.verified_pct", "d1.dup_check_s", "d1.cluster_s",
            "fastidious.attach_s", "d1.writers_s", "fastidious.graft_s"}
    assert want <= set(result["metrics"])
    assert "d1_network.kernel_ms" not in result["metrics"]
