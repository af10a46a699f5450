"""-f's device graft and the sharded engines of bin/swarm-torch against
bin/swarm, byte for byte (tests/cli_parity.py): the graft on both
sides' device engines, the port over 3 in-process shards
(SWARM_TORCH_SHARDS=3) against swarm_tpu's jax_shard backend on its
virtual 8-device mesh, and two gloo ranks of the port against one
process."""

import os
import re
import shutil
import subprocess
import sys

import pytest

from cli_parity import (
    ALL_OUTPUTS,
    D2_OUTPUTS,
    ENV,
    GRAFT_ENGINE_ENV,
    OUTPUT_FLAGS,
    REPO_ROOT,
    compare,
    d1_corpus,
    graft_fasta,
    run_side,
)
from genfasta import amplicon_cloud


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
           lambda: d1_corpus("plain"), SHARDS_ENV),
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
    one = run_side("swarm-torch", tmp_path / "one", flags, fasta)
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
