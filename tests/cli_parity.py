"""Shared by the CLI parity tests (tests/test_torch_cli*.py): one run of
bin/swarm or bin/swarm-torch as a subprocess, the comparison of the two
sides byte for byte, the variables that put both sides on the same
engine, and the corpora more than one test file runs."""

import os
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path

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


def run_side(launcher, workdir, args, fasta, engine=None, extra_env=None):
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
    want = run_side("swarm", tmp_path / "jax", args, fasta, engine, extra_env)
    got = run_side("swarm-torch", tmp_path / "torch", args, fasta, engine,
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


ALL_OUTPUTS = [x for kv in OUTPUT_FLAGS.items() for x in kv]

#: both sides on their d=1 sort-join engine, whatever the corpus' size:
#: swarm_tpu's device backend (JAX on the CPU here) and the port's torch
#: engine; each variable is read by one side only
D1_ENGINE_ENV = {"SWARM_TPU_BACKEND": "jax", "SWARM_TPU_D1_NATIVE_MAX": "0"}


def d1_corpus(case):
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


#: both sides on their device graft, whatever the smaller side's keys:
#: swarm_tpu's GraftEngine (JAX on the CPU here) and the port's
#: GraftEngine; both read SWARM_TPU_GRAFT_PROBE_MAX, and only swarm_tpu
#: reads SWARM_TPU_GRAFT (its sort or probe mode)
GRAFT_ENGINE_ENV = {**D1_ENGINE_ENV, "SWARM_TPU_GRAFT_PROBE_MAX": "0"}


def graft_fasta():
    """Clouds of low abundance: 79 light swarms, 23 of them grafted."""
    return amplicon_cloud(seed=777, n_centers=12, cloud_size=35, length=70,
                          max_edits=4, max_abundance=8)


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
