"""The port's forward-diff DP (swarm_tpu_torch/ops/d2_diffs.py) against
the JAX scan program and the native oracle.

Integer DP: every comparison is exact. The CUDA kernel's own tests are
in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swarm_tpu.ops.d2_diffs_jax import d2_diffs_program
from swarm_tpu.ops.neighbors import pad_codes
from swarm_tpu_torch import _native
from swarm_tpu_torch.ops import d2_diffs as torch_diffs
from swarm_tpu_torch.ops.d2_diffs import (
    DeviceDiffEngine,
    d2_diffs,
    d2_diffs_reference,
)

from test_d2_diffs_jax import _chain_corpus, _mkdb

# the parametrisations of tests/test_pallas_d2_diffs.py
PALLAS_CASES = [
    (1, 2, (4, 12, 4)),
    (4, 2, (2, 2, 2)),   # gap-open == extend: dense b4/b8 ties
    (5, 4, (1, 1, 1)),   # everything ties
    (6, 2, (9, 3, 1)),
    (3, 3, (4, 12, 4)),
]

BLOCK = 1024  # the Pallas kernel's task block


def task_arrays(tmp_path, seed, d, scores):
    """The task arrays of tests/test_pallas_d2_diffs.py: every ordered
    pair of a 50-sequence chain corpus, rows padded to the JAX engine's
    64-multiple width, the task count padded to a 1024 multiple with
    empty (rejected) lanes. Returns numpy arrays and the band."""
    mismatch, go, ge = scores
    db = _mkdb(tmp_path, _chain_corpus(seed, 50, 48, d + 1))
    n = len(db)
    Lmax = -(-max(int(db.longest), 1) // 64) * 64
    rows = pad_codes(db.codes, db.offsets, db.lengths, Lmax)
    lens = np.ascontiguousarray(db.lengths, dtype=np.int32)
    pa, pb = np.triu_indices(n, k=1)
    tq = np.concatenate([pa, pb]).astype(np.int64)
    td = np.concatenate([pb, pa]).astype(np.int64)
    npad = -(-len(tq) // BLOCK) * BLOCK
    qi = np.zeros(npad, dtype=np.int64)
    di = np.zeros(npad, dtype=np.int64)
    qi[: len(tq)] = tq
    di[: len(td)] = td
    qlen = np.where(np.arange(npad) < len(tq), lens[qi], 0).astype(np.int32)
    dlen = lens[di]
    cutoff = d * max(mismatch, go + ge)
    B = DeviceDiffEngine.band_for_exact(cutoff, go, ge)
    return rows[qi], rows[di], qlen, dlen, B, Lmax


def reference_diffs(arrays, d, scores):
    lanes_q, lanes_d, qlen, dlen, B, Lmax = arrays
    mismatch, go, ge = scores
    return d2_diffs_reference(
        torch.from_numpy(lanes_q), torch.from_numpy(lanes_d),
        torch.from_numpy(qlen), torch.from_numpy(dlen),
        B, Lmax, mismatch, go, ge, d).numpy()


@pytest.mark.parametrize("seed,d,scores", PALLAS_CASES)
def test_reference_matches_scan(tmp_path, seed, d, scores):
    arrays = task_arrays(tmp_path, seed, d, scores)
    lanes_q, lanes_d, qlen, dlen, B, Lmax = arrays
    mismatch, go, ge = scores
    want = np.asarray(d2_diffs_program(
        jnp.asarray(lanes_q), jnp.asarray(lanes_d), jnp.asarray(qlen),
        jnp.asarray(dlen), B=B, Lmax=Lmax, mismatch=mismatch, go=go, ge=ge,
        d=d))
    got = reference_diffs(arrays, d, scores)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got < 0).any()


def _tasks_match_native(eng, db, pa, pb, d, scores, no_break):
    """diff_tasks equals the native diffs laid out as its tasks
    (native_tasks), where the native kernel skips every direction that
    `directions` does not admit; returns the diffs."""
    mismatch, go, ge = scores
    want_ab, want_ba = _native.d2_diffs_pairs(
        db.codes, db.offsets, db.lengths, db.abundances, pa, pb,
        d, mismatch, go, ge, no_break, nthreads=1,
    )
    need_ab, need_ba = torch_diffs.directions(db.abundances, pa, pb,
                                              no_break)
    assert (want_ab[~need_ab] < 0).all() and (want_ba[~need_ba] < 0).all()
    got = eng.diff_tasks(*(torch.from_numpy(x.astype(np.int32))
                           for x in (pa, pb)), mismatch, go, ge, no_break)
    want = torch_diffs.native_tasks(db, pa, pb, d, mismatch, go, ge,
                                    no_break)
    assert len(want[0]) == need_ab.sum() + need_ba.sum()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    return got[2]


# the parametrisations of tests/test_d2_diffs_jax.py
@pytest.mark.parametrize(
    "seed,d,scores",
    [
        (1, 2, (4, 12, 4)),
        (2, 2, (4, 12, 4)),
        (3, 3, (4, 12, 4)),
        (4, 2, (2, 2, 2)),
        (5, 4, (1, 1, 1)),
        (6, 2, (9, 3, 1)),
    ],
)
def test_engine_matches_native(tmp_path, seed, d, scores):
    db = _mkdb(tmp_path, _chain_corpus(seed, 80, 60, d + 1))
    pa, pb = np.triu_indices(len(db), k=1)
    pa = pa.astype(np.int64)
    pb = pb.astype(np.int64)
    eng = DeviceDiffEngine(db, d, torch.device("cpu"))
    for no_break in (False, True):
        _tasks_match_native(eng, db, pa, pb, d, scores, no_break)


def test_wide_band_matches_native(tmp_path):
    """-m 1 -p 1 -g 1 -e 0 gives penalties (4, 2, 1); d=16 then needs a
    band of B=67, beyond what swarm_tpu's Pallas kernel takes."""
    mismatch, go, ge, d = 4, 2, 1, 16
    eng_band = DeviceDiffEngine.band_for_exact(d * max(mismatch, go + ge),
                                               go, ge)
    assert eng_band == 67
    db = _mkdb(tmp_path, _chain_corpus(7, 36, 40, 6))
    pa, pb = np.triu_indices(len(db), k=1)
    pa = pa.astype(np.int64)
    pb = pb.astype(np.int64)
    eng = DeviceDiffEngine(db, d, torch.device("cpu"))
    got = _tasks_match_native(eng, db, pa, pb, d, (mismatch, go, ge), True)
    assert (got > 2).any() and (got < 0).any()


def test_wrapper_checks_inputs_and_never_falls_back():
    rows = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.full((4,), 8, dtype=torch.int32)
    idx = torch.arange(4, dtype=torch.int64)
    assert d2_diffs(rows, lens, idx, idx.flip(0), 3, 4, 12, 4, 2).tolist() \
        == [0, 0, 0, 0]
    with pytest.raises(ValueError):
        d2_diffs(rows, lens.to(torch.int64), idx, idx, 3, 4, 12, 4, 2)
    with pytest.raises(ValueError):
        d2_diffs(rows, lens, idx[:2], idx, 3, 4, 12, 4, 2)
    # a tensor that is neither on the CPU nor on a CUDA device has no
    # kernel: the wrapper raises instead of computing on the CPU
    meta = [t.to("meta") for t in (rows, lens, idx, idx)]
    before = torch_diffs.launches
    with pytest.raises(ValueError):
        d2_diffs(*meta, 3, 4, 12, 4, 2)
    assert torch_diffs.launches == before
