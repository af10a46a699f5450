"""swarm_tpu_torch on a CUDA card: the hand-written kernels against their
plain PyTorch versions, on the same card. Every test is marked `cuda`
and skips without a CUDA device. This file imports no JAX, so it runs
on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from swarm_tpu import _native
from swarm_tpu_torch.ops import d2_diffs as torch_diffs
from swarm_tpu_torch.ops.d2_diffs import (
    DeviceDiffEngine,
    d2_diffs,
    d2_diffs_reference,
)
from swarm_tpu_torch.ops.d2_network import D2NetworkEngine

from test_d2_diffs_jax import _chain_corpus, _mkdb

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not _native.available(),
                       reason="native kernels unavailable"),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


#: (seed, d, (mismatch, gapopen, gapextend)) tie-heavy chain corpora of
#: tests/test_pallas_d2_diffs.py, plus two bands above the register
#: variants; chip_smoke.py checks the kernel on the same cases
KERNEL_CASES = [
    (1, 2, (4, 12, 4)),
    (4, 2, (2, 2, 2)),
    (5, 4, (1, 1, 1)),
    (6, 2, (9, 3, 1)),
    (3, 3, (4, 12, 4)),
    (8, 9, (4, 2, 1)),    # B=39: local-memory variant
    (7, 16, (4, 2, 1)),   # B=67: local-memory variant
]


@pytest.mark.parametrize("seed,d,scores", KERNEL_CASES)
def test_d2_diffs_kernel_matches_reference(tmp_path, cuda_device, seed, d,
                                           scores):
    mismatch, go, ge = scores
    db = _mkdb(tmp_path, _chain_corpus(seed, 50, 48, d + 1))
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
    db = _mkdb(tmp_path, _chain_corpus(11, 80, 60, 3))
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
    db = _mkdb(tmp_path, _chain_corpus(12, 300, 60, 3))  # 3 tiles
    got = D2NetworkEngine(db, 2, cuda_device).candidate_pairs()
    want = D2NetworkEngine(db, 2, torch.device("cpu")).candidate_pairs()
    assert got[2] == want[2] > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
