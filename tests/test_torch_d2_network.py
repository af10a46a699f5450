"""The port's d>=2 network engine (swarm_tpu_torch/ops/d2_network.py)
against swarm_tpu's JAX engine, on the CPU with a small tile so the
multi-tile scan runs."""

import numpy as np
import pytest
import torch

from swarm_tpu import _native
from swarm_tpu.ops.d2_diffs_jax import DeviceDiffEngine as JaxDiffEngine
from swarm_tpu.ops.d2_network import D2NetworkEngine as JaxNetworkEngine
from swarm_tpu_torch.models.general import choose_engine
from swarm_tpu_torch.ops.d2_diffs import DeviceDiffEngine
from swarm_tpu_torch.ops.d2_network import D2NetworkEngine

from test_d2_network import _db_from_seqs

pytestmark = pytest.mark.skipif(
    not _native.available(), reason="native kernels unavailable"
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _small_tile(monkeypatch):
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "128")


def _clouds(seed, n_centers, cloud, length, max_edits):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_centers):
        base = rng.integers(0, 4, size=length).astype(np.uint8)
        for _ in range(cloud):
            v = base.copy()
            for _ in range(int(rng.integers(0, max_edits + 1))):
                pos = int(rng.integers(0, len(v)))
                op = int(rng.integers(0, 3))
                if op == 0:
                    v[pos] = rng.integers(0, 4)
                elif op == 1:
                    v = np.delete(v, pos)
                else:
                    v = np.insert(v, pos, rng.integers(0, 4))
            seqs.append(v.astype(np.uint8))
    db = _db_from_seqs(seqs)
    db.abundances = rng.integers(1, 6, size=len(seqs)).astype(np.int64)
    return db


@pytest.mark.parametrize("d", [2, 3])
def test_candidate_pairs_match_jax(d):
    db = _clouds(60 + d, 30, 14, 64, d + 1)  # 420 amplicons: 4 tiles
    pa, pb, tot = D2NetworkEngine(db, d, CPU).candidate_pairs()
    ja, jb, jtot = JaxNetworkEngine(db, d).candidate_pairs()
    assert tot == jtot == len(pa) > 0
    got = sorted(zip(pa.tolist(), pb.tolist()))
    assert got == sorted(zip(ja.tolist(), jb.tolist()))
    assert pa.dtype == np.int64 and pb.dtype == np.int64


@pytest.mark.parametrize(
    "seed,d,no_break,scores",
    [
        (70, 2, False, (4, 12, 4)),
        (71, 3, False, (4, 12, 4)),
        (72, 2, True, (4, 12, 4)),   # -n
        (73, 2, False, (2, 3, 1)),   # custom scores
    ],
)
def test_build_adjacency_matches_jax(monkeypatch, seed, d, no_break, scores):
    """Equal arrays across several tiles; the port's diffs go through
    its d2_diffs path, swarm_tpu's through the native kernel."""
    db = _clouds(seed, 24, 12, 56, d + 1)  # 288 amplicons: 3 tiles
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "device")
    got = D2NetworkEngine(db, d, CPU).build_adjacency(*scores, no_break)
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "native")
    want = JaxNetworkEngine(db, d).build_adjacency(*scores, no_break)
    assert len(got) == len(want) == 6
    for x, y in zip(got, want):
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
    assert len(got[2]) > 0  # some accepted edges


def test_engine_state_matches_jax():
    """The state carried to the device: profile bytes, lengths, code
    rows and row lengths equal what the JAX engines upload."""
    db = _clouds(80, 10, 20, 50, 3)  # 200 amplicons: 2 tiles
    eng = D2NetworkEngine(db, 2, CPU)
    jeng = JaxNetworkEngine(db, 2)
    np.testing.assert_array_equal(eng.prof.numpy(), np.asarray(jeng.prof_dev))
    np.testing.assert_array_equal(eng.lengths.numpy(),
                                  np.asarray(jeng.len_dev))
    diff = DeviceDiffEngine(db, 2, CPU)
    jdiff = JaxDiffEngine(db, 2)
    jrows = np.asarray(jdiff.rows_dev)
    # swarm_tpu rounds the row width up to a 64 multiple for XLA
    np.testing.assert_array_equal(diff.rows.numpy(), jrows[:, : diff.Lmax])
    assert not jrows[:, diff.Lmax:].any()
    np.testing.assert_array_equal(diff.lens.numpy(),
                                  np.asarray(jdiff.len_dev))


def test_out_of_range_pair_fails_loudly(monkeypatch):
    db = _clouds(81, 4, 10, 40, 2)
    eng = D2NetworkEngine(db, 2, CPU)
    bad = np.array([0, len(db)], dtype=np.int64)
    monkeypatch.setattr(eng, "candidate_pairs",
                        lambda: (bad[:1], bad[1:], 1))
    with pytest.raises(AssertionError, match="out-of-range"):
        eng.build_adjacency(4, 12, 4, False)


def test_engine_choice(monkeypatch):
    cuda = torch.device("cuda", 0)
    monkeypatch.delenv("SWARM_TPU_D2_ENGINE", raising=False)
    assert choose_engine(16384, 8, cuda) == "network"
    assert choose_engine(16383, 8, cuda) == "native"
    assert choose_engine(16384, 16, cuda) == "native"
    assert choose_engine(100_000, 8, CPU) == "native"
    monkeypatch.setenv("SWARM_TPU_D2_ENGINE", "network")
    assert choose_engine(10, 8, CPU) == "network"
    assert choose_engine(10, 16, CPU) == "native"
    monkeypatch.setenv("SWARM_TPU_D2_ENGINE", "python")
    with pytest.raises(ValueError):
        choose_engine(10, 8, CPU)
