"""bin/swarm-torch against bin/swarm, run as subprocesses on the same
corpora and flags: exit code, stdout, stderr and every output file must
be byte-identical (tests/cli_parity.py). This file holds the d>=2
network engine with device diffs (on the CPU here, through each engine's
plain path); tests/test_torch_cli_d1.py the d=0 and d=1 engines,
tests/test_torch_cli_shards.py -f's device graft and the sharded
engines, tests/test_torch_cli_engines.py the seed/subseed loop, the
native engine, the scores and the options. The port runs on the CPU
because the tests ask for it (SWARM_TORCH_DEVICE=cpu)."""

import numpy as np
import pytest

from cli_parity import D2_OUTPUTS, compare
from genfasta import amplicon_cloud


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
