"""swarm_tpu_torch.ops.nw_scores on the CPU against the JAX functions.

The same numpy inputs, made from a seed, go through the JAX function
(the jnp references, and the Pallas kernels in interpret mode) and its
counterpart in the port. Tolerance: 0 (integer scores). The full-row
scores must be equal everywhere; the banded scores equal the JAX
same-band reference everywhere, and against the Pallas band kernel and
the host kernel they hold the screen's contract: equal where the true
score is <= cutoff, > cutoff elsewhere, never below the true score.
"""

import numpy as np
import pytest
import torch

from swarm_tpu.ops.search import search_diffs
from swarm_tpu_torch.ops import nw_scores
from test_pallas_nw import _host_scores, _pairs
from test_search_jax import _random_batch

PENALTIES = [(4, 12, 4), (3, 6, 2), (18, 24, 13)]


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


def _as_database(qseq, rows, lens, W):
    """[n, W] matrix with the targets first and the seed last."""
    n = len(lens) + 1
    padded = np.zeros((n, W), dtype=np.uint8)
    padded[: n - 1, : rows.shape[1]] = rows
    padded[n - 1, : len(qseq)] = qseq
    lengths = np.concatenate([lens, [len(qseq)]]).astype(np.int32)
    return padded, lengths


def _band_corpus(seed=5, P=16, W=256):
    """The corpus of test_pallas_nw.test_banded_kernel_interpret: even
    pairs within a few edits, odd pairs far apart."""
    rng = np.random.default_rng(seed)
    qrows = np.zeros((P, W), np.uint8)
    trows = np.zeros((P, W), np.uint8)
    qlens = np.zeros(P, np.int32)
    tlens = np.zeros(P, np.int32)
    for p in range(P):
        L = int(rng.integers(150, 230))
        q = rng.integers(1, 5, L).astype(np.uint8)
        t = q.copy()
        n_ed = int(rng.integers(1, 4) if p % 2 == 0 else rng.integers(30, 60))
        for _ in range(n_ed):
            op = int(rng.integers(0, 3))
            pos = int(rng.integers(0, len(t)))
            if op == 0:
                t[pos] = 1 + (t[pos] % 4)
            elif op == 1 and len(t) > 5:
                t = np.delete(t, pos)
            else:
                t = np.insert(t, pos, rng.integers(1, 5))
        t = t[:W]
        qrows[p, :L] = q
        qlens[p] = L
        tlens[p] = len(t)
        trows[p, : len(t)] = t
    return qrows, trows, qlens, tlens


def _contract(got, ideal, cutoff):
    got = np.asarray(got, dtype=np.int64)
    ideal = np.asarray(ideal, dtype=np.int64)
    inside = ideal <= cutoff
    np.testing.assert_array_equal(got[inside], ideal[inside])
    assert (got[~inside] > cutoff).all()
    assert (got >= ideal).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("penalties", PENALTIES)
def test_full_scores_equal_jax_scan_and_host(seed, penalties):
    import jax.numpy as jnp

    from swarm_tpu.ops.search_jax import nw_scores_device

    mm, go, ge = penalties
    qseq, rows, lens = _random_batch(seed)
    padded, lengths = _as_database(qseq, rows, lens, 64)
    n = len(lengths)
    ids = np.arange(n - 1)
    want = np.asarray(nw_scores_device(
        jnp.asarray(padded), jnp.asarray(lengths), jnp.int32(n - 1),
        jnp.asarray(ids.astype(np.int32)),
        jnp.int32(mm), jnp.int32(go), jnp.int32(ge)))
    host, _, _ = search_diffs(qseq, rows, lens, mm, go, ge, 16)
    for dtype in (np.int32, np.int64):
        got = nw_scores.full_scores(
            _t(padded), _t(lengths), n - 1, _t(ids, dtype), mm, go, ge)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("penalties", [(4, 12, 4), (18, 24, 13)])
def test_full_scores_equal_pallas_interpret(penalties):
    from swarm_tpu.ops.pallas_nw import make_banded_scores_pallas

    mm, go, ge = penalties
    qrows, trows, qlens, tlens = _pairs(3, P=16, W=128)
    call = make_banded_scores_pallas(P_TILE=8, interpret=True)
    want = np.asarray(call(qrows, trows, qlens, tlens, mm, go, ge))
    # one seed per launch in the port: each pair is its own database
    got = []
    for p in range(len(qlens)):
        padded = np.stack([trows[p], qrows[p]])
        lengths = np.array([tlens[p], qlens[p]], dtype=np.int32)
        got.append(int(nw_scores.full_scores(
            _t(padded), _t(lengths), 1, _t([0], np.int64), mm, go, ge)[0]))
    np.testing.assert_array_equal(np.array(got), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("band", [4, 8, 16])
@pytest.mark.parametrize("penalties", PENALTIES)
def test_banded_reference_equals_jax_reference(seed, band, penalties):
    import jax.numpy as jnp

    from swarm_tpu.ops.pallas_nw import banded_scores_reference

    mm, go, ge = penalties
    qrows, trows, qlens, tlens = _pairs(seed)
    want = np.asarray(banded_scores_reference(
        jnp.asarray(qrows), jnp.asarray(trows),
        jnp.asarray(qlens.astype(np.int32)),
        jnp.asarray(tlens.astype(np.int32)), mm, go, ge, band))
    got = nw_scores.banded_scores_reference(
        _t(qrows), _t(trows), _t(qlens, np.int32), _t(tlens, np.int32),
        mm, go, ge, band)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the contract against the exact host kernel
    host = _host_scores(qrows, trows, qlens, tlens, mm, go, ge)
    _contract(got.numpy(), host, go + band * ge - 1)


def test_banded_scores_hold_contract_against_pallas_band_kernel():
    from swarm_tpu.ops.pallas_nw import (
        band_for_cutoff, make_banded_scores_pallas_band)

    mm, go, ge = 18, 24, 13
    cutoff = 3 * max(mm, go + ge)
    band = band_for_cutoff(cutoff, go, ge)
    assert band == nw_scores.band_for_cutoff(cutoff, go, ge)
    qrows, trows, qlens, tlens = _band_corpus()
    call = make_banded_scores_pallas_band(P_TILE=8, interpret=True)
    pallas = np.asarray(call(qrows, trows, qlens, tlens, mm, go, ge, band))
    host = _host_scores(qrows, trows, qlens.astype(np.int64),
                        tlens.astype(np.int64), mm, go, ge)
    got = nw_scores.banded_scores_reference(
        _t(qrows), _t(trows), _t(qlens), _t(tlens), mm, go, ge, band).numpy()
    _contract(got, host, cutoff)
    _contract(pallas, host, cutoff)
    inside = host <= cutoff
    assert inside.any() and (~inside).any()
    np.testing.assert_array_equal(got[inside], pallas[inside])


@pytest.mark.parametrize("cutoff,go,ge", [
    (74, 24, 13), (111, 24, 13), (32, 12, 4), (16, 6, 2), (5, 6, 2),
    (255 * 37, 24, 13)])
def test_band_for_cutoff_equals_jax(cutoff, go, ge):
    from swarm_tpu.ops.pallas_nw import band_for_cutoff

    B = nw_scores.band_for_cutoff(cutoff, go, ge)
    assert B == band_for_cutoff(cutoff, go, ge)
    assert B >= 1 and go + B * ge > cutoff


def test_wrappers_on_one_seed_equal_their_plain_versions():
    """The wrappers read rows through the ids; the plain versions take
    gathered rows. Lengths 0 and out-of-band length gaps report INF."""
    mm, go, ge = 18, 24, 13
    qseq, rows, lens = _random_batch(7, B=24, qlen=50, max_dlen=72)
    lens[3] = 0
    padded, lengths = _as_database(qseq, rows, lens, 80)
    n = len(lengths)
    ids = np.array([5, 3, 0, 22, 7, 7, 1], dtype=np.int64)
    full = nw_scores.full_scores(
        _t(padded), _t(lengths), n - 1, _t(ids), mm, go, ge).numpy()
    host, _, _ = search_diffs(qseq, rows[ids], lens[ids], mm, go, ge, 16)
    ok = lens[ids] > 0
    np.testing.assert_array_equal(full[ok], host[ok])
    assert full[1] == nw_scores.INF
    for band in (1, 4, 20, 63):
        got = nw_scores.banded_scores(
            _t(padded), _t(lengths), n - 1, _t(ids), mm, go, ge, band).numpy()
        assert got[1] == nw_scores.INF
        _contract(got[ok], host[ok], go + band * ge - 1)
        far = np.abs(lens[ids] - len(qseq)) > band
        assert (got[far] == nw_scores.INF).all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    padded = torch.zeros((4, 16), dtype=torch.uint8)
    lengths = torch.full((4,), 16, dtype=torch.int32)
    ids = torch.arange(3)
    with pytest.raises(ValueError):
        nw_scores.banded_scores(padded, lengths, 3, ids, 4, 12, 4, 64)
    with pytest.raises(ValueError):
        nw_scores.banded_scores(padded, lengths, 3, ids, 4, 12, 4, 0)
    with pytest.raises(ValueError):
        nw_scores.full_scores(padded.int(), lengths, 3, ids, 4, 12, 4)
    with pytest.raises(ValueError):
        nw_scores.full_scores(padded, lengths.long(), 3, ids, 4, 12, 4)
    with pytest.raises(ValueError):
        nw_scores.full_scores(padded, lengths, 4, ids, 4, 12, 4)
    with pytest.raises(ValueError):
        nw_scores.full_scores(padded, lengths, 3, ids.float(), 4, 12, 4)
    assert nw_scores.launches == {"banded_scores": 0, "full_scores": 0}
