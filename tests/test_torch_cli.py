"""bin/swarm-torch against bin/swarm, run as subprocesses on the same
corpora and flags: exit code, stdout, stderr and every output file must
be byte-identical. Both sides run the d>=2 network engine with device
diffs (on the CPU here, through each engine's plain path)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from genfasta import amplicon_cloud
from swarm_tpu import _native

pytestmark = pytest.mark.skipif(
    not _native.available(), reason="native kernels unavailable"
)

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
}


def _run(launcher, workdir, args, fasta):
    workdir.mkdir(parents=True)
    (workdir / "input.fasta").write_text(fasta)
    # argv[0] is "swarm" on both sides: diagnostics print it
    shutil.copy2(REPO_ROOT / "bin" / launcher, workdir / "swarm")
    return subprocess.run(
        [sys.executable, "swarm", *args, "input.fasta"],
        cwd=workdir, capture_output=True, timeout=600,
        env={**os.environ, **ENV, "PYTHONPATH": str(REPO_ROOT)},
    )


def compare(tmp_path, args, fasta):
    want = _run("swarm", tmp_path / "jax", args, fasta)
    got = _run("swarm-torch", tmp_path / "torch", args, fasta)
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
        "'in.fasta'], 'swarm') == 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if 'jax' in m)[:5]\n"
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
