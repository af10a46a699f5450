"""The d=0 and d=1 engines of bin/swarm-torch against bin/swarm, byte
for byte (tests/cli_parity.py): the native d=1 builder on small corpora,
and both sides' d=1 sort-join engine forced (SWARM_TPU_BACKEND=jax on
the JAX side, SWARM_TPU_D1_NATIVE_MAX=0 on the port's), on one width
and on mixed lengths."""

import numpy as np
import pytest

from cli_parity import (
    ALL_OUTPUTS,
    D1_ENGINE_ENV,
    OUTPUT_FLAGS,
    compare,
    d1_corpus,
    mixed_lengths_fasta,
)
from genfasta import amplicon_cloud


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
    got = compare(tmp_path, flags, d1_corpus(corpus),
                  extra_env=D1_ENGINE_ENV)
    if case == "duplicate_fatal":
        assert got.returncode != 0
        assert b"identical sequences" in got.stderr + (
            tmp_path / "torch" / "log.txt").read_bytes()
    else:
        assert got.returncode == 0, got.stderr
        assert (tmp_path / "torch" / "network.txt").stat().st_size > 0


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

    (tmp_path / "in.fasta").write_text(d1_corpus("plain"))
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
