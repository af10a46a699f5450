"""bin/swarm-torch against bin/swarm, run as subprocesses on the same
corpora and flags: exit code, stdout, stderr and every output file must
be byte-identical. Both sides run the d>=2 network engine with device
diffs (on the CPU here, through each engine's plain path), the
seed/subseed loop under SWARM_TPU_D2_ENGINE=device and python, and the
d=1 sort-join engine (SWARM_TPU_BACKEND=jax on the JAX side,
SWARM_TPU_D1_NATIVE_MAX=0 on the port's), and the sharded engines
(SWARM_TORCH_SHARDS=3 on the port's side, swarm_tpu's jax_shard backend
on its virtual 8-device mesh; and two gloo ranks of the port). The port
runs on the CPU because the tests ask for it (SWARM_TORCH_DEVICE=cpu)."""

import os
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from genfasta import amplicon_cloud, mutate, random_seq

REPO_ROOT = Path(__file__).resolve().parent.parent

OUTPUT_FLAGS = {
    "-o": "out.txt",
    "-s": "stats.txt",
    "-u": "uclust.txt",
    "-i": "structure.txt",
    "-j": "network.txt",
    "-w": "seeds.fasta",
    "-l": "log.txt",
}
D2_OUTPUTS = [x for f, name in OUTPUT_FLAGS.items() if f != "-j"
              for x in (f, name)]

ENV = {
    "SWARM_TPU_D2_ENGINE": "network",
    "SWARM_TPU_D2_DIFFS": "device",
    "SWARM_TPU_D2_TILE": "128",
    "SWARM_TORCH_DEVICE": "cpu",
}

#: a launcher for either side that lowers DeviceAligner's batch
#: threshold, so the aligner really runs on a small corpus
ALIGNER_LAUNCHER = """import sys
if {side!r} == "jax":
    from swarm_tpu.main import main
    from swarm_tpu.ops.search_jax import DeviceAligner
else:
    from swarm_tpu_torch.main import main
    from swarm_tpu_torch.ops.search_torch import DeviceAligner
DeviceAligner.MIN_DEVICE_BATCH = 4
sys.exit(main())
"""


def _run(launcher, workdir, args, fasta, engine=None, extra_env=None):
    """One run of bin/<launcher> (under SWARM_TPU_D2_ENGINE=engine when
    given, and `extra_env`); for the seed/subseed-loop engines, of the
    aligner launcher for that side instead."""
    workdir.mkdir(parents=True)
    (workdir / "input.fasta").write_text(fasta)
    # argv[0] is "swarm" on both sides: diagnostics print it
    env = {**os.environ, **ENV, **(extra_env or {}),
           "PYTHONPATH": str(REPO_ROOT)}
    if engine is not None:
        env["SWARM_TPU_D2_ENGINE"] = engine
    if engine in ("device", "python"):
        side = "jax" if launcher == "swarm" else "torch"
        (workdir / "swarm").write_text(ALIGNER_LAUNCHER.format(side=side))
    else:
        shutil.copy2(REPO_ROOT / "bin" / launcher, workdir / "swarm")
    return subprocess.run(
        [sys.executable, "swarm", *args, "input.fasta"],
        cwd=workdir, capture_output=True, timeout=600, env=env,
    )


def compare(tmp_path, args, fasta, engine=None, extra_env=None):
    want = _run("swarm", tmp_path / "jax", args, fasta, engine, extra_env)
    got = _run("swarm-torch", tmp_path / "torch", args, fasta, engine,
               extra_env)
    assert got.returncode == want.returncode, got.stderr
    assert got.stdout == want.stdout
    assert got.stderr == want.stderr
    for flag, name in OUTPUT_FLAGS.items():
        if flag in args:
            a = tmp_path / "jax" / name
            b = tmp_path / "torch" / name
            assert (b.read_bytes() if b.exists() else None) == (
                a.read_bytes() if a.exists() else None), name
    return got


@pytest.mark.parametrize("seed", [41, 42])
def test_d2_all_outputs(tmp_path, seed):
    fasta = amplicon_cloud(
        seed=seed, n_centers=6, cloud_size=20, length=70, max_edits=3)
    compare(tmp_path, ["-d", "2"] + D2_OUTPUTS, fasta)


def test_d3(tmp_path):
    fasta = amplicon_cloud(
        seed=43, n_centers=4, cloud_size=15, length=60, max_edits=4)
    compare(tmp_path, ["-d", "3"] + D2_OUTPUTS, fasta)


def test_no_otu_breaking(tmp_path):
    fasta = amplicon_cloud(
        seed=44, n_centers=4, cloud_size=12, length=50, max_edits=3)
    compare(tmp_path, ["-d", "2", "-n"] + D2_OUTPUTS, fasta)


def test_equal_abundances(tmp_path):
    rng = np.random.default_rng(45)
    recs, seqs = [], set()
    base = rng.integers(0, 4, size=50)
    for i in range(60):
        v = base.copy()
        for _ in range(rng.integers(1, 4)):
            v[rng.integers(0, len(v))] = rng.integers(0, 4)
        if v.tobytes() in seqs:
            continue
        seqs.add(v.tobytes())
        recs.append(f">s{i}_3\n" + "".join("ACGT"[c] for c in v) + "\n")
    compare(tmp_path, ["-d", "2"] + D2_OUTPUTS, "".join(recs))


def test_multi_tile(tmp_path):
    fasta = amplicon_cloud(
        seed=46, n_centers=30, cloud_size=18, length=64, max_edits=3)
    compare(tmp_path, ["-d", "2", "-o", "out.txt", "-s", "stats.txt",
                       "-l", "log.txt"], fasta)


def test_custom_scores(tmp_path):
    fasta = amplicon_cloud(
        seed=47, n_centers=4, cloud_size=10, length=50, max_edits=3)
    compare(tmp_path, ["-d", "2", "-m", "2", "-p", "3", "-g", "6", "-e", "2"]
            + D2_OUTPUTS, fasta)


def test_16bit_falls_back_to_native(tmp_path):
    fasta = amplicon_cloud(
        seed=48, n_centers=2, cloud_size=10, length=50, max_edits=8)
    compare(tmp_path, ["-d", "30"] + D2_OUTPUTS, fasta)


#: (flags, corpus) of the seed/subseed-loop cases: d = 2 (band 4),
#: d = 3 (band 7) and a 16-bit case (d = 30: band 84, so the aligner
#: takes its full-row scores)
LOOP_CASES = {
    "d2": (["-d", "2"], dict(seed=54, n_centers=5, cloud_size=14, length=70,
                              max_edits=3)),
    "d3": (["-d", "3"], dict(seed=55, n_centers=4, cloud_size=12, length=60,
                              max_edits=4)),
    "16bit": (["-d", "30"], dict(seed=56, n_centers=2, cloud_size=10,
                                 length=50, max_edits=8)),
}


@pytest.mark.parametrize("engine", ["device", "python"])
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_seed_loop_engines(tmp_path, case, engine):
    flags, corpus = LOOP_CASES[case]
    got = compare(tmp_path, flags + D2_OUTPUTS, amplicon_cloud(**corpus),
                  engine)
    assert got.returncode == 0, got.stderr
    assert (tmp_path / "torch" / "out.txt").stat().st_size > 0


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_device_engine_runs_the_aligner(tmp_path, monkeypatch, case):
    """With the threshold lowered as in that launcher, the port's device
    engine hands target lists to DeviceAligner on these corpora."""
    from swarm_tpu_torch import metrics
    from swarm_tpu_torch.main import run
    from swarm_tpu_torch.ops.search_torch import DeviceAligner

    flags, corpus = LOOP_CASES[case]
    (tmp_path / "in.fasta").write_text(amplicon_cloud(**corpus))
    monkeypatch.setattr(DeviceAligner, "MIN_DEVICE_BATCH", 4)
    monkeypatch.setenv("SWARM_TPU_D2_ENGINE", "device")
    monkeypatch.chdir(tmp_path)
    metrics.reset()
    assert run(flags + ["-o", "out.txt", "-l", "log.txt", "in.fasta"],
               "swarm", device="cpu") == 0
    assert metrics.last_run["d2_device_batches"] > 0


def test_d0(tmp_path):
    fasta = amplicon_cloud(seed=49, n_centers=5, cloud_size=10, length=60)
    fasta += fasta.replace(">", ">dup")  # duplicate sequences to merge
    compare(tmp_path, ["-d", "0", "-o", "out.txt", "-s", "stats.txt",
                       "-u", "uclust.txt", "-w", "seeds.fasta",
                       "-l", "log.txt"], fasta)


def test_d1_all_outputs(tmp_path):
    fasta = amplicon_cloud(
        seed=50, n_centers=6, cloud_size=15, length=70, max_edits=2)
    compare(tmp_path, ["-d", "1"] + [x for kv in OUTPUT_FLAGS.items()
                                     for x in kv], fasta)


def test_d1_fastidious(tmp_path):
    # light swarms one edit from a heavy swarm's members: the graft join
    fasta = amplicon_cloud(
        seed=57, n_centers=6, cloud_size=15, length=70, max_edits=2)
    compare(tmp_path, ["-d", "1", "-f"] + [x for kv in OUTPUT_FLAGS.items()
                                           for x in kv], fasta)


def test_d1_no_otu_breaking_network(tmp_path):
    fasta = amplicon_cloud(
        seed=58, n_centers=5, cloud_size=12, length=60, max_edits=2)
    compare(tmp_path, ["-d", "1", "-n", "-j", "network.txt", "-o", "out.txt",
                       "-s", "stats.txt", "-i", "structure.txt",
                       "-l", "log.txt"], fasta)


#: both sides on their d=1 sort-join engine, whatever the corpus' size:
#: swarm_tpu's device backend (JAX on the CPU here) and the port's torch
#: engine; each variable is read by one side only
D1_ENGINE_ENV = {"SWARM_TPU_BACKEND": "jax", "SWARM_TPU_D1_NATIVE_MAX": "0"}

ALL_OUTPUTS = [x for kv in OUTPUT_FLAGS.items() for x in kv]


def _d1_corpus(case):
    fasta = amplicon_cloud(
        seed=60, n_centers=6, cloud_size=15, length=70, max_edits=2)
    if case == "no_abundances":  # -a 3 supplies them
        return re.sub(r"_[0-9]+\n", "\n", fasta)
    if case == "usearch":  # -z: ";size=N;" abundances
        return re.sub(r"_([0-9]+)\n", r";size=\1;\n", fasta)
    if case == "duplicate":  # the duplicate-sequence fatal
        head, seq = fasta.split("\n")[:2]
        return fasta + f">dup_{head.split('_')[-1]}\n{seq}\n"
    return fasta


#: name -> (flags, corpus case) of the d=1 torch-engine cases
D1_ENGINE_CASES = {
    "all_outputs": (["-d", "1"] + ALL_OUTPUTS, "plain"),
    "no_otu_breaking": (["-d", "1", "-n"] + ALL_OUTPUTS, "plain"),
    "append_abundance": (["-d", "1", "-a", "3"] + ALL_OUTPUTS,
                         "no_abundances"),
    "usearch_abundance": (["-d", "1", "-z"] + ALL_OUTPUTS, "usearch"),
    "fastidious": (["-d", "1", "-f"] + ALL_OUTPUTS, "plain"),
    "duplicate_fatal": (["-d", "1", "-o", "out.txt", "-l", "log.txt"],
                        "duplicate"),
}


@pytest.mark.parametrize("case", sorted(D1_ENGINE_CASES))
def test_d1_sortjoin_engine(tmp_path, case):
    flags, corpus = D1_ENGINE_CASES[case]
    got = compare(tmp_path, flags, _d1_corpus(corpus),
                  extra_env=D1_ENGINE_ENV)
    if case == "duplicate_fatal":
        assert got.returncode != 0
        assert b"identical sequences" in got.stderr + (
            tmp_path / "torch" / "log.txt").read_bytes()
    else:
        assert got.returncode == 0, got.stderr
        assert (tmp_path / "torch" / "network.txt").stat().st_size > 0


#: both sides on their device graft, whatever the smaller side's keys:
#: swarm_tpu's GraftEngine (JAX on the CPU here) and the port's
#: GraftEngine; both read SWARM_TPU_GRAFT_PROBE_MAX, and only swarm_tpu
#: reads SWARM_TPU_GRAFT (its sort or probe mode)
GRAFT_ENGINE_ENV = {**D1_ENGINE_ENV, "SWARM_TPU_GRAFT_PROBE_MAX": "0"}


def graft_fasta():
    """Clouds of low abundance: 79 light swarms, 23 of them grafted."""
    return amplicon_cloud(seed=777, n_centers=12, cloud_size=35, length=70,
                          max_edits=4, max_abundance=8)


@pytest.mark.parametrize("mode", ["sorted", "chunked"])
def test_d1_fastidious_device_graft(tmp_path, mode):
    """-d 1 -f with the device graft on both sides (JAX's in its sort
    and its probe mode): every output and the log byte for byte, the
    "Got N graft candidates" line included."""
    flags = ["-d", "1", "-f", "-o", "out.txt", "-s", "stats.txt", "-i",
             "structure.txt", "-l", "log.txt"]
    got = compare(tmp_path, flags, graft_fasta(),
                  extra_env={**GRAFT_ENGINE_ENV, "SWARM_TPU_GRAFT": mode})
    assert got.returncode == 0, got.stderr
    log = (tmp_path / "torch" / "log.txt").read_bytes()
    assert int(re.search(rb"Made (\d+) grafts", log).group(1)) > 0
    assert int(re.search(rb"Got (\d+) graft candidates", log).group(1)) > 0


#: the port over 3 in-process shards (SWARM_TORCH_SHARDS, read by the
#: port only) and swarm_tpu's sharded engines (its jax_shard backend on
#: the virtual 8-device mesh of tests/conftest.py, read by swarm_tpu only)
SHARDS_ENV = {"SWARM_TORCH_SHARDS": "3", "SWARM_TPU_BACKEND": "jax_shard"}

#: name -> (flags, corpus, environment) of the sharded cases: the d=1
#: network, -f's graft, the d>=2 screen of the network engine (ENV)
SHARDED_CASES = {
    "d1": (["-d", "1"] + ALL_OUTPUTS,
           lambda: _d1_corpus("plain"), SHARDS_ENV),
    "d1_fastidious": (["-d", "1", "-f", "-o", "out.txt", "-s", "stats.txt",
                       "-i", "structure.txt", "-l", "log.txt"],
                      lambda: graft_fasta(), SHARDS_ENV),
    "d2": (["-d", "2"] + D2_OUTPUTS,
           lambda: amplicon_cloud(seed=41, n_centers=6, cloud_size=20,
                                  length=70, max_edits=3),
           {"SWARM_TORCH_SHARDS": "3"}),
}


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_engines(tmp_path, case):
    """The port's sharded engines against swarm_tpu's, every output and
    the log byte for byte ("Got N graft candidates" included)."""
    flags, corpus, env = SHARDED_CASES[case]
    got = compare(tmp_path, flags, corpus(), extra_env=env)
    assert got.returncode == 0, got.stderr
    assert (tmp_path / "torch" / "out.txt").stat().st_size > 0


def test_two_gloo_ranks_write_once(tmp_path):
    """-d 1 -f over two gloo ranks of bin/swarm-torch (the same argv on
    the same input): rank 0's stdout, stderr and files equal one
    process', and rank 1 writes none. (TORCH_CPP_LOG_LEVEL=ERROR: c10d
    warns on stderr where the host's name does not resolve.)"""
    from swarm_tpu_torch.parallel.dryrun import free_port

    port = free_port()
    flags = ["-d", "1", "-f"] + ALL_OUTPUTS
    fasta = graft_fasta()
    one = _run("swarm-torch", tmp_path / "one", flags, fasta)
    assert one.returncode == 0, one.stderr
    procs = []
    for rank in range(2):
        work = tmp_path / f"rank{rank}"
        work.mkdir()
        (work / "input.fasta").write_text(fasta)
        shutil.copy2(REPO_ROOT / "bin" / "swarm-torch", work / "swarm")
        procs.append(subprocess.Popen(
            [sys.executable, "swarm", *flags, "input.fasta"], cwd=work,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env={**os.environ, **ENV, "PYTHONPATH": str(REPO_ROOT),
                 "SWARM_TPU_COORDINATOR": f"127.0.0.1:{port}",
                 "SWARM_TPU_NUM_PROCESSES": "2",
                 "TORCH_CPP_LOG_LEVEL": "ERROR",
                 "SWARM_TPU_PROCESS_ID": str(rank)}))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs[1][1]
    assert outs[0] == (one.stdout, one.stderr)
    assert outs[1] == (b"", b"")
    for flag, name in OUTPUT_FLAGS.items():
        assert (tmp_path / "rank0" / name).read_bytes() == \
            (tmp_path / "one" / name).read_bytes(), name
    assert sorted(p.name for p in (tmp_path / "rank1").iterdir()) == [
        "input.fasta", "swarm"]


def mixed_lengths_fasta():
    """Amplicon clouds of 60-80 nt and two reads of 900 and 960 nt with
    three single edits each: a corpus that swarm_tpu gives its
    width-bucketed engine (BucketedSortJoinEngine.worthwhile)."""
    rng = random.Random(62)
    fasta = amplicon_cloud(
        seed=61, n_centers=6, cloud_size=15, length=70, max_edits=2)
    for i, length in enumerate((900, 960)):
        read = random_seq(rng, length)
        for j, seq in enumerate([read] + [mutate(read, rng, 1)
                                          for _ in range(3)]):
            fasta += f">long{i}v{j}_{rng.randint(1, 50)}\n{seq}\n"
    return fasta


def test_d1_sortjoin_engine_on_mixed_lengths(tmp_path):
    """Mixed lengths: swarm_tpu's width-bucketed engine against the
    port's engine over ragged rows, every d=1 output byte for byte."""
    from swarm_tpu.ops.neighbors_sortjoin import BucketedSortJoinEngine

    fasta = mixed_lengths_fasta()
    lengths = [len(x) for x in fasta.split("\n")[1::2]]
    assert BucketedSortJoinEngine.worthwhile(np.array(lengths))
    flags = ["-d", "1", "-o", "out.txt", "-s", "stats.txt", "-u",
             "uclust.txt", "-i", "structure.txt", "-w", "seeds.fasta", "-l",
             "log.txt"]
    got = compare(tmp_path, flags, fasta, extra_env=D1_ENGINE_ENV)
    assert got.returncode == 0, got.stderr
    assert (tmp_path / "torch" / "seeds.fasta").read_bytes().count(b">") \
        < len(lengths)


def test_d1_sortjoin_engine_runs_in_process(tmp_path, monkeypatch):
    """The same forcing in one process: the port's d=1 run builds its
    network with the sort-join engine, on the CPU as asked."""
    from swarm_tpu_torch import metrics
    from swarm_tpu_torch.main import run
    from swarm_tpu_torch.ops import neighbors_sortjoin

    (tmp_path / "in.fasta").write_text(_d1_corpus("plain"))
    monkeypatch.setenv("SWARM_TPU_D1_NATIVE_MAX", "0")
    monkeypatch.chdir(tmp_path)
    started = []
    real_start = neighbors_sortjoin.SortJoinNeighborEngine.start

    def start(self):
        started.append(self.device)
        return real_start(self)

    monkeypatch.setattr(neighbors_sortjoin.SortJoinNeighborEngine, "start",
                        start)
    metrics.reset()
    assert run(["-d", "1", "-o", "out.txt", "-l", "log.txt", "in.fasta"],
               "swarm", device="cpu") == 0
    assert started and {d.type for d in started} == {"cpu"}
    assert metrics.last_run["d1_join_comparisons"] > 0


@pytest.mark.parametrize("flags", [["-d", "2"], ["-d", "3", "-n"]],
                         ids=["d2", "d3n"])
def test_native_engine(tmp_path, flags):
    fasta = amplicon_cloud(
        seed=59, n_centers=6, cloud_size=15, length=70, max_edits=3)
    compare(tmp_path, flags + D2_OUTPUTS, fasta, engine="native")


def test_option_error_exit_code(tmp_path):
    # -j is a d=1 output: both sides refuse it at d=2 with one message
    got = compare(tmp_path, ["-d", "2", "-j", "network.txt"],
                  amplicon_cloud(seed=51, n_centers=2, cloud_size=3))
    assert got.returncode != 0


@pytest.mark.parametrize("d", ["0", "1", "2"])
def test_port_imports_no_jax(tmp_path, d):
    fasta = amplicon_cloud(seed=52, n_centers=4, cloud_size=10, length=60)
    (tmp_path / "in.fasta").write_text(fasta)
    code = (
        "import sys\n"
        "from swarm_tpu_torch.main import run\n"
        f"assert run(['-d', '{d}', '-o', 'out.txt', '-l', 'log.txt', "
        "'in.fasta'], 'swarm', device='cpu') == 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if 'jax' in m)[:5]\n"
        "assert 'swarm_tpu' not in sys.modules\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        timeout=300,
        env={**os.environ, **ENV, "PYTHONPATH": str(REPO_ROOT)},
    )
    assert r.returncode == 0, r.stderr.decode()
    assert (tmp_path / "out.txt").stat().st_size > 0


def test_profile_dir_writes_torch_trace(tmp_path):
    fasta = amplicon_cloud(seed=53, n_centers=3, cloud_size=8, length=50)
    prof = tmp_path / "prof"
    r = _run("swarm-torch", tmp_path / "run",
             ["-d", "2", "-o", "out.txt", "-l", "log.txt"], fasta)
    assert r.returncode == 0
    env_run = subprocess.run(
        [sys.executable, "swarm", "-d", "2", "-o", "out2.txt", "-l",
         "log2.txt", "input.fasta"],
        cwd=tmp_path / "run", capture_output=True, timeout=300,
        env={**os.environ, **ENV, "PYTHONPATH": str(REPO_ROOT),
             "SWARM_TPU_PROFILE_DIR": str(prof)},
    )
    assert env_run.returncode == 0, env_run.stderr.decode()
    assert (prof / "trace.json").stat().st_size > 0
    assert (tmp_path / "run" / "out.txt").read_bytes() == \
        (tmp_path / "run" / "out2.txt").read_bytes()
