"""swarm_tpu_torch on a CUDA card: the hand-written kernels against their
plain PyTorch versions, on the same card. Every test is marked `cuda`
and skips without a CUDA device. This file imports no JAX, so it runs
on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from swarm_tpu_torch import _native
from swarm_tpu_torch.corpora import (
    D2_DIFFS_KERNEL_CASES,
    chain_corpus,
    dense_cloud_corpus,
    make_db,
    read_db,
)
from swarm_tpu_torch.ops import d2_diffs as torch_diffs
from swarm_tpu_torch.ops import nw_scores
from swarm_tpu_torch.ops.d2_diffs import (
    DeviceDiffEngine,
    d2_diffs,
    d2_diffs_reference,
)
from swarm_tpu_torch.ops.d2_network import D2NetworkEngine
from swarm_tpu_torch.ops.neighbors import pad_codes
from swarm_tpu_torch.ops.search_torch import DeviceAligner

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed,d,scores", D2_DIFFS_KERNEL_CASES)
def test_d2_diffs_kernel_matches_reference(tmp_path, cuda_device, seed, d,
                                           scores):
    mismatch, go, ge = scores
    db = make_db(tmp_path, chain_corpus(seed, 50, 48, d + 1))
    eng = DeviceDiffEngine(db, d, cuda_device)
    pa, pb = np.triu_indices(len(db), k=1)
    tq = torch.from_numpy(np.concatenate([pa, pb]).astype(np.int64))
    td = torch.from_numpy(np.concatenate([pb, pa]).astype(np.int64))
    tq, td = tq.to(cuda_device), td.to(cuda_device)
    B = eng.band_for_exact(d * max(mismatch, go + ge), go, ge)
    before = torch_diffs.launches
    got = d2_diffs(eng.rows, eng.lens, tq, td, B, mismatch, go, ge, d)
    torch.cuda.synchronize()
    assert torch_diffs.launches == before + 1
    want = d2_diffs_reference(
        eng.rows[tq], eng.rows[td], eng.lens[tq], eng.lens[td], B,
        eng.Lmax, mismatch, go, ge, d)
    assert torch.equal(got.cpu(), want.cpu())
    assert (want >= 0).any()


def test_d2_diffs_engine_matches_native_on_card(tmp_path, cuda_device):
    mismatch, go, ge, d = 4, 12, 4, 2
    db = make_db(tmp_path, chain_corpus(11, 80, 60, 3))
    pa, pb = np.triu_indices(len(db), k=1)
    pa, pb = pa.astype(np.int64), pb.astype(np.int64)
    eng = DeviceDiffEngine(db, d, cuda_device)
    for no_break in (False, True):
        want = _native.d2_diffs_pairs(
            db.codes, db.offsets, db.lengths, db.abundances, pa, pb,
            d, mismatch, go, ge, no_break, nthreads=1)
        got = eng.diffs_pairs(pa, pb, mismatch, go, ge, no_break)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


def test_screen_on_card_matches_cpu(tmp_path, cuda_device, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "128")
    db = make_db(tmp_path, chain_corpus(12, 300, 60, 3))  # 3 tiles
    got = D2NetworkEngine(db, 2, cuda_device).candidate_pairs()
    want = D2NetworkEngine(db, 2, torch.device("cpu")).candidate_pairs()
    assert got[2] == want[2] > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture
def cloud_aligner(tmp_path, cuda_device):
    """DeviceAligner over a small dense-cloud corpus (~250 nt), with the
    ids of every record but the seed (record 0, a centre)."""
    path = tmp_path / "dense.fasta"
    dense_cloud_corpus(path, n_centers=2, cloud=300, length=250)
    db = read_db(path)
    padded = pad_codes(db.codes, db.offsets, db.lengths, int(db.longest))
    al = DeviceAligner(padded, db.lengths, cuda_device)
    ids = torch.arange(1, len(db), device=cuda_device)
    return al, ids


@pytest.mark.parametrize("scores", [(4, 12, 4), (3, 6, 2), (18, 24, 13)])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_full_scores_kernel_matches_reference(cloud_aligner, scores,
                                              ids_dtype):
    al, ids = cloud_aligner
    mm, go, ge = scores
    ids = ids.to(ids_dtype)
    before = nw_scores.launches["full_scores"]
    got = nw_scores.full_scores(al.padded, al.lengths, 0, ids, mm, go, ge)
    torch.cuda.synchronize()
    assert nw_scores.launches["full_scores"] == before + 1
    want = nw_scores.nw_scores_reference(
        al.padded, al.lengths, 0, ids, mm, go, ge)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("scores", [(4, 12, 4), (3, 6, 2), (18, 24, 13)])
@pytest.mark.parametrize("band", [1, 4, 20, 21, 63])
def test_banded_scores_kernel_matches_reference(cloud_aligner, scores, band):
    """Exact equality with the same-band plain version (B <= 20: register
    variants; above: the local-memory variant), and the screen's contract
    against the full-row kernel."""
    al, ids = cloud_aligner
    mm, go, ge = scores
    nb = ids.numel()
    before = nw_scores.launches["banded_scores"]
    got = nw_scores.banded_scores(
        al.padded, al.lengths, 0, ids, mm, go, ge, band)
    torch.cuda.synchronize()
    assert nw_scores.launches["banded_scores"] == before + 1
    want = nw_scores.banded_scores_reference(
        al.padded[0].expand(nb, -1), al.padded[ids],
        al.lengths[0].expand(nb), al.lengths[ids], mm, go, ge, band)
    assert torch.equal(got, want)
    full = nw_scores.full_scores(al.padded, al.lengths, 0, ids, mm, go, ge)
    cutoff = go + band * ge - 1
    inside = full <= cutoff
    assert inside.any()
    assert torch.equal(got[inside], full[inside])
    assert bool((got[~inside] > cutoff).all())


def test_score_kernels_take_empty_rows_and_empty_lists(cuda_device):
    padded = torch.zeros((3, 40), dtype=torch.uint8, device=cuda_device)
    padded[0, :30] = 1
    padded[1, :28] = 1
    lengths = torch.tensor([30, 28, 0], dtype=torch.int32, device=cuda_device)
    ids = torch.tensor([1, 2], device=cuda_device)
    full = nw_scores.full_scores(padded, lengths, 0, ids, 18, 24, 13)
    band = nw_scores.banded_scores(padded, lengths, 0, ids, 18, 24, 13, 4)
    assert full.tolist() == [24 + 2 * 13, nw_scores.INF]
    assert band.tolist() == [24 + 2 * 13, nw_scores.INF]
    none = ids[:0]
    assert nw_scores.full_scores(
        padded, lengths, 0, none, 18, 24, 13).numel() == 0
    # an empty seed: INF for every target
    assert nw_scores.full_scores(
        padded, lengths, 2, ids[:1], 18, 24, 13).tolist() == [nw_scores.INF]
    assert nw_scores.banded_scores(
        padded, lengths, 2, ids[:1], 18, 24, 13, 4).tolist() == [nw_scores.INF]


def test_device_aligner_on_card_matches_cpu(cloud_aligner):
    al, ids = cloud_aligner
    cpu = DeviceAligner(al.padded.cpu().numpy(), al.lengths.cpu().numpy(),
                        torch.device("cpu"))
    ids_np = ids[:200].cpu().numpy()
    for cutoff in (None, 74, 30 * 37):  # full-row, band 4, band 84: full-row
        np.testing.assert_array_equal(
            al.scores(0, ids_np, 18, 24, 13, cutoff=cutoff),
            cpu.scores(0, ids_np, 18, 24, 13, cutoff=cutoff))
