"""swarm_tpu_torch's DeviceAligner on the CPU against swarm_tpu's.

Both aligners are built from one [n, W] code matrix and one length
array (the state carried across the port), and answer the same
(seed, target list, penalties, cutoff) questions. On the CPU the JAX
aligner gives exact scores (its scan), the port's gives its banded
plain version when a cutoff is given and the band fits, so with a
cutoff the screen's contract is compared: the mask `scores <= cutoff`
is equal, and the values are equal where <= cutoff. Without a cutoff
the scores are equal everywhere. Tolerance: 0 (integers).
"""

import numpy as np
import pytest
import torch

from swarm_tpu.ops.search import search_diffs
from swarm_tpu_torch.ops import nw_scores
from swarm_tpu_torch.ops.search_torch import DeviceAligner

PENALTIES = [(4, 12, 4), (3, 6, 2), (18, 24, 13)]


def _database(seed, n=40, length=90, W=110):
    """[n, W] codes: three families of variants 0..5 edits from their
    centre (so lists hold near and far targets), zero padded."""
    rng = np.random.default_rng(seed)
    padded = np.zeros((n, W), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int64)
    centres = [rng.integers(0, 4, size=length + 3 * c).astype(np.uint8)
               for c in range(3)]
    for r in range(n):
        v = centres[r % 3].copy()
        for _ in range(int(rng.integers(0, 6))):
            op = int(rng.integers(0, 3))
            pos = int(rng.integers(0, len(v)))
            if op == 0:
                v[pos] = (v[pos] + 1 + rng.integers(0, 3)) % 4
            elif op == 1:
                v = np.delete(v, pos)
            else:
                v = np.insert(v, pos, rng.integers(0, 4))
        padded[r, : len(v)] = v
        lengths[r] = len(v)
    return padded, lengths


@pytest.fixture(scope="module")
def aligners():
    from swarm_tpu.ops.search_jax import DeviceAligner as JaxAligner

    padded, lengths = _database(61)
    return (padded, lengths, JaxAligner(padded, lengths),
            DeviceAligner(padded, lengths, torch.device("cpu")))


def test_aligner_keeps_the_jax_state(aligners):
    padded, lengths, jax_al, torch_al = aligners
    assert torch_al.n == jax_al.n == len(lengths)
    assert torch_al.MIN_DEVICE_BATCH == jax_al.MIN_DEVICE_BATCH
    W = padded.shape[1]
    np.testing.assert_array_equal(
        torch_al.padded.numpy(), np.asarray(jax_al.padded)[:, :W])
    np.testing.assert_array_equal(
        torch_al.lengths.numpy(), np.asarray(jax_al.lengths))


@pytest.mark.parametrize("penalties", PENALTIES)
@pytest.mark.parametrize("seed_id", [0, 1, 17])
def test_scores_without_cutoff_are_equal(aligners, penalties, seed_id):
    padded, lengths, jax_al, torch_al = aligners
    mm, go, ge = penalties
    ids = np.array([i for i in range(len(lengths)) if i != seed_id])
    want = jax_al.scores(seed_id, ids, mm, go, ge)
    got = torch_al.scores(seed_id, ids, mm, go, ge)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    host, _, _ = search_diffs(
        padded[seed_id, : lengths[seed_id]], padded[ids], lengths[ids],
        mm, go, ge, 16)
    np.testing.assert_array_equal(got, host)


@pytest.mark.parametrize("penalties", PENALTIES)
@pytest.mark.parametrize("d", [1, 2, 3, 9])
def test_scores_with_cutoff_hold_the_screen_contract(aligners, penalties, d):
    padded, lengths, jax_al, torch_al = aligners
    mm, go, ge = penalties
    cutoff = d * max(mm, go + ge)
    for seed_id in (0, 1, 17):
        ids = np.array([i for i in range(len(lengths)) if i != seed_id])
        want = jax_al.scores(seed_id, ids, mm, go, ge, cutoff=cutoff)
        got = torch_al.scores(seed_id, ids, mm, go, ge, cutoff=cutoff)
        inside = want <= cutoff
        np.testing.assert_array_equal(got <= cutoff, inside)
        np.testing.assert_array_equal(got[inside], want[inside])
        assert (got >= want).all()
    assert inside.any() and (~inside).any()


def test_band_rule(aligners, monkeypatch):
    """Band kernel when a cutoff is given and its band is at most 63,
    else full-row scores (the rule of swarm_tpu's DeviceAligner)."""
    from swarm_tpu_torch.ops import search_torch

    _, lengths, _, torch_al = aligners
    calls = []
    monkeypatch.setattr(
        search_torch, "banded_scores",
        lambda *a: calls.append(("band", a[-1])) or torch.zeros(3))
    monkeypatch.setattr(
        search_torch, "full_scores",
        lambda *a: calls.append(("full", None)) or torch.zeros(3))
    ids = np.array([1, 2, 3])
    torch_al.scores(0, ids, 18, 24, 13, cutoff=74)       # B = 4
    torch_al.scores(0, ids, 18, 24, 13)                  # no cutoff
    torch_al.scores(0, ids, 18, 24, 13, cutoff=30 * 37)  # B = 84
    torch_al.scores(0, ids, 42, 2, 3, cutoff=187)        # B = 62
    torch_al.scores(0, ids, 42, 2, 3, cutoff=190)        # B = 63
    torch_al.scores(0, ids, 42, 2, 3, cutoff=193)        # B = 64
    assert calls == [("band", 4), ("full", None), ("full", None),
                     ("band", 62), ("band", 63), ("full", None)]
    assert nw_scores.MAX_BAND == 63
