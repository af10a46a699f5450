"""swarm_tpu_torch on a CUDA card, the one check of the port there: the
hand-written kernels against their plain PyTorch versions on the same
card (on their edge cases and on corpora), the engines against the
native host engines, and the runs of chip_smoke.py's main-path pass
(each of its MAIN_PATHS through the CLI, also over four in-process
shards, as a one-rank NCCL group, forwarded to the resident server, and
at the dispatch rules' thresholds), made by its own functions, against
the native engine or the single-device run byte for byte. Every test
is marked `cuda` and skips without a CUDA device. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(chip_smoke.py times the kernels and counts the main paths' launches;
it checks only the outputs it times.)
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swarm_tpu_torch import _native
from swarm_tpu_torch.corpora import (
    D2_DIFFS_BAND_CASES,
    D2_DIFFS_KERNEL_CASES,
    CSR_CASES,
    SCREEN_CASES,
    SCREEN_EDGE_CASES,
    band_edge_cases,
    chain_corpus,
    d1_edge_rows,
    dense_cloud_corpus,
    fastidious_corpus,
    gen_corpus,
    graft_edge_rows,
    insertion_run,
    make_db,
    mixed_length_corpus,
    ragged_edge_rows,
    ragged_rows,
    read_db,
    record_index,
    rows_records,
    score_edge_cases,
    screen_edge_rows,
    screen_order_tasks,
)
from swarm_tpu_torch.ops import d2_diffs as torch_diffs
from swarm_tpu_torch.ops import d2_network as d2n
from swarm_tpu_torch.ops import fastidious_torch as ft
from swarm_tpu_torch.ops import neighbors_sortjoin as sj
from swarm_tpu_torch.ops import nw_scores
from swarm_tpu_torch.ops.d2_diffs import (
    DeviceDiffEngine,
    d2_diffs,
    d2_diffs_reference,
)
from swarm_tpu_torch.ops.d2_network import D2NetworkEngine
from swarm_tpu_torch.ops.neighbors import pad_codes
from swarm_tpu_torch.ops.search_torch import DeviceAligner

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from chip_smoke import MAIN_PATHS  # noqa: E402

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


@pytest.mark.parametrize("B,d,scores", D2_DIFFS_BAND_CASES)
def test_d2_diffs_kernel_matches_reference_at_every_band(cuda_device, B, d,
                                                         scores):
    """Every register variant (B = 1..20) and the general variant (the
    last two cases), on lengths that differ by up to B and more; the
    matrix' width is no multiple of 16, so the wrapper re-strides it."""
    from swarm_tpu_torch._build import load

    mismatch, go, ge = scores
    rows_np, lens_np = ragged_rows(100 + B, 96, 61 + B, B + 2)
    rows = torch.from_numpy(rows_np).to(cuda_device)
    lens = torch.from_numpy(lens_np).to(cuda_device)
    n = len(lens_np)
    tq = torch.arange(n, device=cuda_device).repeat_interleave(n)
    td = torch.arange(n, device=cuda_device).repeat(n)
    got = d2_diffs(rows, lens, tq, td, B, mismatch, go, ge, d)
    torch.cuda.synchronize()
    want = d2_diffs_reference(rows[tq], rows[td], lens[tq], lens[td], B,
                              rows.shape[1], mismatch, go, ge, d)
    assert torch.equal(got, want)
    assert (want >= 0).any() and (want < 0).any()
    packed = load().swarm_d2_packed(
        -(-rows.shape[1] // 16) * 16, B, mismatch, go, ge, d)
    assert packed == (1 if B <= 20 and mismatch < 70000 else 0)


def test_d2_diffs_engine_matches_native_on_card(tmp_path, cuda_device):
    mismatch, go, ge, d = 4, 12, 4, 2
    db = make_db(tmp_path, chain_corpus(11, 80, 60, 3))
    pa, pb = np.triu_indices(len(db), k=1)
    pa, pb = pa.astype(np.int64), pb.astype(np.int64)
    eng = DeviceDiffEngine(db, d, cuda_device)
    for no_break in (False, True):
        want = torch_diffs.native_tasks(db, pa, pb, d, mismatch, go, ge,
                                        no_break)
        got = eng.diff_tasks(
            *(torch.from_numpy(x.astype(np.int32)).to(cuda_device)
              for x in (pa, pb)), mismatch, go, ge, no_break)
        assert (want[2] >= 0).any() and (want[2] < 0).any()
        for x, y in zip(got, want):
            assert x.is_cuda
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y)


def test_screen_on_card_matches_cpu(tmp_path, cuda_device, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "128")
    db = make_db(tmp_path, chain_corpus(12, 300, 60, 3))  # 3 tiles
    got = D2NetworkEngine(db, 2, cuda_device).candidate_pairs()
    want = D2NetworkEngine(db, 2, torch.device("cpu")).candidate_pairs()
    assert got[2] == want[2] > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _screen_steps(tmp_path, monkeypatch, dev, T, n, d, seed=130):
    monkeypatch.setenv("SWARM_TPU_D2_TILE", str(T))
    db = make_db(tmp_path, rows_records(screen_edge_rows(seed, n, d)))
    eng = D2NetworkEngine(db, d, dev)
    tis, tjs = (torch.from_numpy(t).to(dev)
                for t in d2n.tile_steps(eng.n_pad // T))
    return eng, tis, tjs


def _screen_kernels_agree(prof, lengths, tis, tjs, T, n, d):
    """Both kernels against their plain versions: words and row counts
    element for element, pairs in order, one launch of each; returns
    the pairs."""
    before = dict(d2n.launches)
    words, counts = d2n.screen_words(prof, lengths, tis, tjs, T, n, d)
    ga, gb = d2n.extract_pairs(words, counts, tis, tjs, T)
    torch.cuda.synchronize()
    assert d2n.launches == {**before, "d2_screen": before["d2_screen"] + 1,
                            "d2_extract": before["d2_extract"] + 1}
    want = d2n.screen_words_reference(prof, lengths, tis, tjs, T, n, d)
    assert torch.equal(words, want)
    assert torch.equal(counts, d2n.row_counts_reference(want, T))
    pa, pb = d2n.extract_pairs_reference(want, tis, tjs, T)
    assert torch.equal(ga, pa) and torch.equal(gb, pb)
    return ga, gb


@pytest.mark.parametrize("T,n,d", SCREEN_CASES)
def test_d2_screen_kernels_match_reference(tmp_path, cuda_device,
                                           monkeypatch, T, n, d):
    """Words and row counts element for element, pairs in order; one
    launch of each kernel."""
    eng, tis, tjs = _screen_steps(tmp_path, monkeypatch, cuda_device, T, n, d)
    ga, _ = _screen_kernels_agree(eng.prof, eng.lengths, tis, tjs, T, eng.n,
                                  d)
    assert len(ga) > 0


@pytest.mark.parametrize("T,n,d", SCREEN_EDGE_CASES)
def test_d2_screen_kernels_on_the_edges_of_their_schedule(
        tmp_path, cuda_device, monkeypatch, T, n, d):
    """T = 32, 160 and 4096 with n below T and on a tile's edge (items
    and row tiles past T, columns past n), and d = 20 (dense words)."""
    eng, tis, tjs = _screen_steps(tmp_path, monkeypatch, cuda_device, T, n, d)
    ga, _ = _screen_kernels_agree(eng.prof, eng.lengths, tis, tjs, T, eng.n,
                                  d)
    assert len(ga) > 0


def test_d2_screen_steps_of_identical_profiles(cuda_device):
    """Every pair passes: full words, rows of 4,096 survivors in the
    off-diagonal step for the extraction, the triangle in the diagonal
    ones."""
    T, n = 4096, 8192
    row = torch.from_numpy(np.random.default_rng(132).integers(
        0, 256, 128, dtype=np.uint8))
    prof = row.repeat(n, 1).to(cuda_device)
    lengths = torch.full((n,), 150, dtype=torch.int32, device=cuda_device)
    tis, tjs = (torch.from_numpy(t).to(cuda_device)
                for t in d2n.tile_steps(2))
    ga, _ = _screen_kernels_agree(prof, lengths, tis, tjs, T, n, 2)
    assert len(ga) == n * (n - 1) // 2
    assert int(torch.bincount(ga.long()).max()) == n - 1  # row 0


@pytest.mark.parametrize("chunk", ["1", "2", "512"])
@pytest.mark.parametrize("n,d", [(383, 3), (384, 2), (385, 5)])
def test_d2_screen_chunks_on_card_match_cpu(tmp_path, cuda_device,
                                            monkeypatch, n, d, chunk):
    """T = 128, n one below, at and one above a multiple of it."""
    monkeypatch.setenv("SWARM_TPU_D2_CHUNK", chunk)
    eng, _, _ = _screen_steps(tmp_path, monkeypatch, cuda_device, 128, n, d)
    cpu = D2NetworkEngine(eng.db, d, torch.device("cpu"))
    got, want = eng.candidate_pairs(), cpu.candidate_pairs()
    assert got[2] == want[2] > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_d2_extract_decodes_past_int32(cuda_device):
    """Survivor bits of a late step, whose global bit position passes
    2^31 (JAX's round-4 wrap), decode exactly."""
    T, K = 512, 8400
    wpr = T // 32
    words = torch.zeros((K, T * wpr), dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(K * T, dtype=torch.int32, device=cuda_device)
    planted = [(3, 17, 5), (8300, 8000, 31), (8399, 8191, 31)]
    for k, w, b in planted:
        words[k, w] = np.int32(np.uint32(1 << b).view(np.int32))
        counts[k * T + w // wpr] += 1
    tis = torch.arange(K, dtype=torch.int32, device=cuda_device) % 11
    tjs = torch.arange(K, dtype=torch.int32, device=cuda_device) % 13
    ga, gb = d2n.extract_pairs(words, counts, tis, tjs, T)
    want = [(k % 11 * T + (w * 32 + b) // T, k % 13 * T + (w * 32 + b) % T)
            for k, w, b in planted]
    assert list(zip(ga.tolist(), gb.tolist())) == want


def test_d2_screen_empty_chunk_launches_no_extraction(tmp_path, cuda_device,
                                                     monkeypatch):
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "128")
    rng = np.random.default_rng(131)
    rows = [rng.integers(0, 4, size=200).astype(np.uint8) for _ in range(40)]
    db = make_db(tmp_path, rows_records(rows))
    eng = D2NetworkEngine(db, 2, cuda_device)
    before = dict(d2n.launches)
    assert eng.candidate_pairs()[2] == 0
    assert d2n.launches["d2_screen"] == before["d2_screen"] + 1
    assert d2n.launches["d2_extract"] == before["d2_extract"]


def test_d2_screen_refuses_a_tile_it_cannot_take(tmp_path, cuda_device,
                                                  monkeypatch):
    eng, tis, tjs = _screen_steps(tmp_path, monkeypatch, cuda_device, 128,
                                  100, 2)
    before = dict(d2n.launches)
    with pytest.raises(ValueError, match="multiple of 32"):
        d2n.screen_words(eng.prof, eng.lengths, tis, tjs, 64 + 16, eng.n, 2)
    with pytest.raises(ValueError, match="share a device"):
        d2n.screen_words(eng.prof, eng.lengths.cpu(), tis, tjs, 128, eng.n, 2)
    assert d2n.launches == before


def _csr_on(tasks, dev, n):
    return d2n.csr_partition(*(torch.from_numpy(x).to(dev) for x in tasks),
                             n)


@pytest.mark.parametrize("n,cloud,dense", CSR_CASES)
def test_d2_csr_partition_matches_reference(cuda_device, n, cloud, dense):
    """The partition kernels against their plain version: one pass and
    several, n on both sides of a digit boundary, one cloud of thousands
    (sources with thousands of edges), sparse sources."""
    tasks = screen_order_tasks(n, cloud, 11, T=128, dense=dense)
    before = d2n.launches["d2_csr"]
    got = _csr_on(tasks, cuda_device, n)
    torch.cuda.synchronize()
    passes = len(d2n.csr_passes(n))
    assert d2n.launches["d2_csr"] == before + 2 * passes + 1
    want = _csr_on(tasks, torch.device("cpu"), n)
    assert int(want[3]) == 0
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y)


@pytest.mark.parametrize("case", ["empty", "all_rejected"])
def test_d2_csr_partition_takes_no_kept_tasks(cuda_device, case):
    n = 1000
    size = 0 if case == "empty" else 5000
    src = torch.randint(0, n, (size,), device=cuda_device)
    diff = torch.full((size,), -1, dtype=torch.int32, device=cuda_device)
    before = d2n.launches["d2_csr"]
    starts, adj_to, adj_diff, bad = d2n.csr_partition(src, src.clone(), diff,
                                                      n)
    assert d2n.launches["d2_csr"] == before + (case != "empty")
    assert starts.tolist() == [0] * (n + 1)
    assert adj_to.numel() == adj_diff.numel() == int(bad) == 0


@pytest.mark.parametrize("fault", ["shuffled", "source_range", "wide_diff",
                                   "none"])
def test_d2_csr_partition_flags_on_card(cuda_device, fault):
    n = 65_537
    tq, td, diffs = screen_order_tasks(n, 30, 12, T=4096)
    if fault == "shuffled":
        perm = np.random.default_rng(13).permutation(len(tq))
        tq, td, diffs = tq[perm], td[perm], diffs[perm]
    elif fault == "source_range":
        tq[-3], diffs[-3] = n, 1
    elif fault == "wide_diff":
        diffs[7] = 300
    bad = _csr_on((tq, td, diffs), cuda_device, n)[3]
    assert int(bad) == (fault != "none")
    assert int(_csr_on((tq, td, diffs), torch.device("cpu"), n)[3]) == \
        int(bad)


def _tasks_pairs(size, kind, seed=14):
    """(pa, pb, ab, n): `size` pairs a < b of n = 2 size ids, pa
    ascending, and abundances all tied ("ties") or all distinct."""
    rng = np.random.default_rng(seed)
    n = max(2 * size, 2)
    pa = np.sort(rng.integers(0, n - 1, size=size))
    pb = pa + 1 + rng.integers(0, 4, size=size) % (n - 1 - pa)
    ab = np.ones(n, np.int64) if kind == "ties" else \
        rng.permutation(n).astype(np.int64)
    return pa, pb, ab, n


@pytest.mark.parametrize("no_break", [False, True])
@pytest.mark.parametrize("kind", ["ties", "distinct"])
@pytest.mark.parametrize("size", [0, 1, 2047, 2048, 2049, (1 << 20) + 3])
def test_d2_tasks_kernel_matches_reference(cuda_device, size, kind,
                                           no_break):
    """The task layout's kernels against their plain version: no pair,
    one, either side of a tile (2,048 pairs) and 2^20 + 3; every
    abundance tied (both directions), none tied, and no_break."""
    pa, pb, ab, n = _tasks_pairs(size, kind)
    ga, gb = (torch.from_numpy(x.astype(np.int32)).to(cuda_device)
              for x in (pa, pb))
    abd = torch.from_numpy(ab).to(cuda_device)
    before = d2n.launches["d2_tasks"]
    tq, td, bad = d2n.d2_tasks(ga, gb, abd, n, no_break)
    torch.cuda.synchronize()
    assert d2n.launches["d2_tasks"] == before + 2 * (size > 0)
    want = d2n.tasks_reference(ga.cpu(), gb.cpu(), abd.cpu(), n, no_break)
    assert bad is want[2] is False
    for x, y in zip((tq, td), want):
        assert x.is_cuda and x.dtype == y.dtype == torch.int64
        assert torch.equal(x.cpu(), y)
    if size and kind == "distinct" and not no_break:
        assert 0 < tq.numel() == size  # one direction a pair
    elif size:
        assert tq.numel() == 2 * size


@pytest.mark.parametrize("fault", ["high", "low", "equal", "swapped"])
def test_d2_tasks_flags_on_card(cuda_device, fault):
    """A pair outside [0, n) or out of order is flagged by the count
    kernel, read back with the tasks' count, and nothing is emitted."""
    pa, pb, ab, n = _tasks_pairs(5000, "ties")
    at = 4321
    if fault == "high":
        pb[at] = n
    elif fault == "low":
        pa[at] = -1
    elif fault == "equal":
        pb[at] = pa[at]
    else:
        pa[at], pb[at] = pb[at], pa[at]
    ga, gb = (torch.from_numpy(x.astype(np.int32)).to(cuda_device)
              for x in (pa, pb))
    before = d2n.launches["d2_tasks"]
    tq, td, bad = d2n.d2_tasks(ga, gb, torch.from_numpy(ab).to(cuda_device),
                               n, False)
    assert bad is True and tq.numel() == td.numel() == 0
    assert d2n.launches["d2_tasks"] == before + 1
    assert d2n.tasks_reference(ga.cpu(), gb.cpu(), torch.from_numpy(ab), n,
                               False)[2] is True


@pytest.mark.parametrize("d", [2, 3])
def test_d2_tasks_build_adjacency_equals_host_layout(tmp_path, cuda_device,
                                                     monkeypatch, d):
    """One build_adjacency on the card lays its tasks out with one count
    and one emit launch, records them as d2_network.device_tasks, and
    gives the CSR that the host's layout gave (the pairs read back,
    directions and task_layout on the host, the tasks uploaded, then the
    same diffs kernel and partition)."""
    from swarm_tpu_torch import metrics

    gen_corpus(tmp_path / "c.fasta", n=30_000, length=150 + 100 * (d - 2))
    db = read_db(tmp_path / "c.fasta")
    eng = D2NetworkEngine(db, d, cuda_device)
    scores = (4, 12, 4)
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "device")
    metrics.reset()
    before = d2n.launches["d2_tasks"]
    got = eng.build_adjacency(*scores, False)
    assert d2n.launches["d2_tasks"] == before + 2
    assert metrics.last_run["d2_network.device_tasks"] == \
        metrics.last_run["d2_network.alignments"] > 0
    pa, pb, _ = eng.candidate_pairs()
    tq, td = (torch.from_numpy(x).to(cuda_device)
              for x in torch_diffs.task_layout(pa, pb, *torch_diffs.directions(
                  db.abundances, pa, pb, False)))
    diff = eng._diff_engine
    B = diff.band_for_exact(d * max(4, 12 + 4), 12, 4)
    diffs = d2_diffs(diff.rows, diff.lens, tq, td, B, *scores, d)
    starts, adj_to, adj_diff, bad = d2n.csr_partition(tq, td, diffs, len(db))
    assert int(bad) == 0
    want = d2n.csr_to_host(starts, adj_to, adj_diff)
    assert len(want[2]) > 0 and got[4] == got[5] == len(pa)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_d2_csr_build_adjacency_on_card_equals_host_path(tmp_path,
                                                        cuda_device,
                                                        monkeypatch):
    """d2_100k's corpus: the CSR partitioned on the card equals the
    native diffs' CSR, partitioned on the host, array for array, and an
    np.lexsort of the native tasks; the guard raises on either path
    where the pairs come out of step order."""
    from swarm_tpu_torch import metrics

    gen_corpus(tmp_path / "c.fasta", n=100_000, length=150)
    db = read_db(tmp_path / "c.fasta")
    eng = D2NetworkEngine(db, 2, cuda_device)
    metrics.reset()
    before = d2n.launches["d2_csr"]
    got = eng.build_adjacency(4, 12, 4, False)
    assert d2n.launches["d2_csr"] > before
    assert metrics.last_run["d2_network.csr_device_edges"] == len(got[2]) > 0
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "native")
    want = eng.build_adjacency(4, 12, 4, False)
    for x, y in zip(got, want):
        if isinstance(y, np.ndarray):
            assert x.dtype == np.int64
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
    pa, pb, _ = eng.candidate_pairs()
    tq, td, diffs = (x.numpy() for x in torch_diffs.native_tasks(
        db, pa, pb, 2, 4, 12, 4, False))
    keep = diffs >= 0
    order = np.lexsort((td[keep], tq[keep]))
    np.testing.assert_array_equal(got[1], np.bincount(tq[keep],
                                                      minlength=len(db)))
    np.testing.assert_array_equal(got[2], td[keep][order])
    np.testing.assert_array_equal(got[3], diffs[keep][order])
    extract = d2n.extract_pairs
    monkeypatch.setattr(d2n, "extract_pairs",
                        lambda *args: tuple(x.flip(0) for x in extract(*args)))
    for mode in ("device", "native"):
        monkeypatch.setenv("SWARM_TPU_D2_DIFFS", mode)
        with pytest.raises(AssertionError, match="CSR check failed"):
            eng.build_adjacency(4, 12, 4, False)


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


def test_full_scores_kernel_on_the_edges_of_its_schedule(cuda_device):
    """Seed and target lengths 1, 31, 32, 33, one below, at and above
    32 * C for every strip width C the kernel is built with, rows of
    more than one pass, targets longer and shorter than the seed, an
    empty row, one-element lists; int32 and int64 ids."""
    assert nw_scores.built_full_strips() == nw_scores.FULL_STRIPS
    n_cases = 0
    for i, (name, padded, lengths, seed_id, ids) in enumerate(
            score_edge_cases(nw_scores.FULL_STRIPS)):
        mm, go, ge = ((4, 12, 4), (18, 24, 13), (1, 1, 1))[i % 3]
        padded, lengths, ids = (torch.from_numpy(x).to(cuda_device)
                                for x in (padded, lengths, ids))
        if i % 2:
            ids = ids.to(torch.int32)
        got = nw_scores.full_scores(padded, lengths, seed_id, ids, mm, go, ge)
        torch.cuda.synchronize()
        want = nw_scores.nw_scores_reference(
            padded, lengths, seed_id, ids, mm, go, ge)
        assert torch.equal(got, want), name
        n_cases += 1
    assert n_cases > 100


@pytest.mark.parametrize("scores", [(4, 12, 4), (3, 6, 2), (18, 24, 13)])
@pytest.mark.parametrize("band", [1, 4, 20, 21, 63])
def test_banded_scores_kernel_matches_reference(cloud_aligner, scores, band):
    """Exact equality with the same-band plain version (B <= 20: register
    variants; above: the general variant), and the screen's contract
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


BAND_EDGE_CASES = list(band_edge_cases())


@pytest.mark.parametrize("case", BAND_EDGE_CASES,
                         ids=[c[0] for c in BAND_EDGE_CASES])
def test_banded_scores_kernel_on_the_edges_of_the_band(cuda_device, case):
    """Every band B = 1..20 (register variants) and 21, 40, 63 (general
    variant) on ragged lengths; seeds shorter than the band, of length
    1, targets of length 0, 1, at the band's last slots and one beyond;
    an empty seed, an empty list; widths that are no multiple of 16
    (the wrapper re-strides them); int32 and int64 ids. Exact for every
    pair, above the cutoff too."""
    name, padded, lengths, seed_id, ids, band, (mm, go, ge) = case
    padded, lengths, ids = (torch.from_numpy(x).to(cuda_device)
                            for x in (padded, lengths, ids))
    nb = ids.numel()
    before = nw_scores.launches["banded_scores"]
    got = nw_scores.banded_scores(
        padded, lengths, seed_id, ids, mm, go, ge, band)
    torch.cuda.synchronize()
    assert nw_scores.launches["banded_scores"] == before + (1 if nb else 0)
    tid = ids.long()
    want = nw_scores.banded_scores_reference(
        padded[seed_id].expand(nb, -1), padded[tid],
        lengths[seed_id].expand(nb), lengths[tid], mm, go, ge, band)
    assert got.dtype == torch.int32
    assert torch.equal(got, want), name


def test_banded_scores_kernel_refuses_what_its_clamp_cannot_take(
        cuda_device):
    """Penalties under which a state could pass 2^31 before the single
    clamp at the end: the wrapper raises and launches nothing, and the
    library's own check agrees with the wrapper's."""
    from swarm_tpu_torch._build import load

    padded = torch.zeros((2, 32), dtype=torch.uint8, device=cuda_device)
    lengths = torch.tensor([24, 22], dtype=torch.int32, device=cuda_device)
    ids = torch.tensor([1], device=cuda_device)
    before = nw_scores.launches["banded_scores"]
    for scores in ((1 << 24, 24, 13), (-1, 24, 13), (18, -1, 13)):
        with pytest.raises(ValueError):
            nw_scores.banded_scores(padded, lengths, 0, ids, *scores, 4)
    assert nw_scores.launches["banded_scores"] == before
    lib = load()
    for width, scores in ((401, (18, 24, 13)), (401, (1 << 21, 24, 13)),
                          (1 << 20, (300, 300, 300)), (48, (1 << 22, 0, 0)),
                          (16384, (255, 255, 255)), (401, (18, 24, -1))):
        assert bool(lib.swarm_nw_band_fits(width, *scores)) == \
            nw_scores.band_fits(width, *scores)
    assert nw_scores.banded_scores(
        padded, lengths, 0, ids, 18, 24, 13, 4).tolist() == [24 + 2 * 13]


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


# ---- the d=1 sort-join kernels (csrc/d1_join.cu) -------------------------

D1_CASES = ["edge_rows", "insertion_run", "ragged_edge_rows", "one_row",
            "gen_corpus", "mixed_corpus", "long_insertion_run",
            "longer_insertion_run"]

#: an insertion run whose 2,105 equal keys outgrow the join's
#: shared-memory tile (kJoinCap = 2,048): its bucket takes the kernel's
#: oversized variant; LONGER_RUN's 4,505 more than twice the tile
LONG_RUN = 700
LONGER_RUN = 1500


def _d1_db(tmp_path, case):
    if case in ("gen_corpus", "mixed_corpus"):
        if case == "gen_corpus":
            gen_corpus(tmp_path / "c.fasta", n=3000, length=150, seed=5)
        else:
            mixed_length_corpus(tmp_path / "c.fasta", n=3000, seed=5)
        return read_db(tmp_path / "c.fasta")
    rows = {"edge_rows": d1_edge_rows, "insertion_run": insertion_run,
            "ragged_edge_rows": ragged_edge_rows,
            "long_insertion_run": lambda: insertion_run(length=LONG_RUN),
            "longer_insertion_run": lambda: insertion_run(length=LONGER_RUN),
            "one_row": lambda: [np.array([1, 1, 0, 3], np.uint8)]}[case]()
    return make_db(tmp_path, rows_records(rows))


def _d1_rows(db, device):
    """(codes, offsets, lengths, row_word, n_words): the code arena and
    its ragged layout as SortJoinNeighborEngine puts them on the device."""
    return sj.SortJoinNeighborEngine(db, device).arena()


@pytest.mark.parametrize("case", D1_CASES)
def test_d1_count_and_pack_match_reference(tmp_path, cuda_device, case):
    """The count pass's packed words and counts, word for word."""
    codes, offsets, lengths, row_word, n_words = _d1_rows(
        _d1_db(tmp_path, case), cuda_device)
    before = sj.launches["d1_keygen"]
    counts, words = sj.keygen_count(codes, offsets, lengths, row_word,
                                    n_words)
    torch.cuda.synchronize()
    want_words, layout = sj.pack_ragged(codes, offsets, lengths)
    assert torch.equal(layout, row_word)
    assert torch.equal(words, want_words)
    _, _, want_counts = sj.ragged_keys_reference(want_words, row_word, lengths)
    assert torch.equal(counts, want_counts)
    assert sj.launches["d1_keygen"] == before + 1


@pytest.mark.parametrize("case", D1_CASES)
def test_d1_kernels_match_reference(tmp_path, cuda_device, case):
    """keygen and verify element for element, the join in the kernel's
    order, each against its plain version on the same card tensors."""
    codes, offsets, lengths, row_word, n_words = _d1_rows(
        _d1_db(tmp_path, case), cuda_device)
    before = dict(sj.launches)
    keys, owners, words = sj.deletion_keys(codes, offsets, lengths,
                                           row_word, n_words)
    torch.cuda.synchronize()
    want_keys, want_owners, _ = sj.ragged_keys_reference(
        words, row_word, lengths)
    assert torch.equal(keys, want_keys)
    assert torch.equal(owners, want_owners)

    bits = sj.bucket_bits(keys.numel())
    want_keys, want_owners, want_ends = sj.partition_reference(
        keys, owners, bits)
    pkeys, powners, ends = sj.partition(keys, owners, bits)
    pairs = sj.join_pairs(pkeys, powners, ends)
    torch.cuda.synchronize()
    assert torch.equal(pkeys, want_keys) and torch.equal(powners, want_owners)
    assert torch.equal(ends, want_ends)
    assert torch.equal(pairs, sj.join_buckets_reference(pkeys, powners, ends))
    skeys, order = torch.sort(keys)
    assert torch.equal(torch.sort(pairs).values, torch.sort(
        sj.join_pairs_reference(skeys, owners[order])).values)
    assert torch.equal(sj.join_count(pkeys, powners, ends)[0], torch.bincount(
        torch.searchsorted(ends, sj._join_links(pkeys, powners)[0],
                           right=True), minlength=ends.numel()))

    uniq = torch.unique(pairs)
    ok = sj.verify_pairs(words, row_word, lengths, uniq)
    want = sj.verify_ragged_reference(words, row_word, lengths, uniq)
    assert torch.equal(ok, want)
    assert sj.launches["d1_keygen"] == before["d1_keygen"] + 2
    assert sj.launches["d1_partition"] == before["d1_partition"] + (
        5 if bits else 0)
    assert sj.launches["d1_join"] == before["d1_join"] + 2 + int(
        pairs.numel() > 0)
    if case != "one_row":
        assert want.any()


@pytest.mark.parametrize("case", ["word_edges", "edge_rows",
                                  "ragged_edge_rows"])
def test_d1_verify_kernel_on_every_pair(tmp_path, cuda_device, case):
    """Every pair of rows, whatever their keys: equal lengths, lengths
    one apart (one uint4 apart too), prefixes, others."""
    rows = {"edge_rows": d1_edge_rows,
            "ragged_edge_rows": ragged_edge_rows}.get(case, lambda: [
                np.random.default_rng(L).integers(0, 4, L).astype(np.uint8)
                for L in (15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129)])()
    if case == "word_edges":  # each row less its last base, and plus one
        rows = rows + [r[:-1] for r in rows] + [np.append(r, 2) for r in rows]
    codes, offsets, lengths, row_word, n_words = _d1_rows(
        make_db(tmp_path, rows_records(rows)), cuda_device)
    words, _ = sj.pack_ragged(codes, offsets, lengths)
    a, b = np.triu_indices(len(rows), k=1)
    pairs = torch.from_numpy(a.astype(np.int64) << 32 | b).to(cuda_device)
    got = sj.verify_pairs(words, row_word, lengths, pairs)
    want = sj.verify_ragged_reference(words, row_word, lengths, pairs)
    assert torch.equal(got, want)
    assert want.any()


@pytest.mark.parametrize("no_break", [False, True])
@pytest.mark.parametrize("case", D1_CASES)
def test_d1_engine_on_card_matches_native(tmp_path, cuda_device, case,
                                          no_break):
    db = _d1_db(tmp_path, case)
    ab = db.abundances.astype(np.int64)
    eng = sj.SortJoinNeighborEngine(db, cuda_device)
    eng.start()
    ef, et = eng.build_network(no_break, ab)
    nf, nt = _native.d1_network(db.codes, db.offsets, db.lengths, ab,
                                no_break)
    np.testing.assert_array_equal(ef, nf)
    np.testing.assert_array_equal(et, nt)


def test_d1_wrappers_refuse_what_the_kernels_cannot_read(cuda_device):
    codes = torch.zeros(200, dtype=torch.uint8, device=cuda_device)
    offsets = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    lengths = torch.full((2,), 100, dtype=torch.int32, device=cuda_device)
    row_word = torch.tensor([0, 8], device=cuda_device)
    words = torch.zeros(17, dtype=torch.int32, device=cuda_device)
    pairs = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        sj.keygen_count(codes, offsets, lengths.long(), row_word, 16)
    with pytest.raises(ValueError, match="int64"):
        sj.keygen_count(codes, offsets, lengths, row_word.int(), 16)
    with pytest.raises(ValueError, match="uint8"):
        sj.keygen_count(codes.int(), offsets, lengths, row_word, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sj.verify_pairs(words[1:], row_word, lengths, pairs)
    with pytest.raises(ValueError, match="beside the rows"):
        sj.verify_pairs(words[:16], row_word, lengths, pairs.cpu())


def _partition_input(case, device):
    """(keys, owners, bits) on the card: random keys with many equal ones
    (empty buckets at 2^12 buckets), or one run of 5,000 equal keys
    among 40,000 others (a bucket over the join's tile)."""
    rng = np.random.default_rng(31)
    if case == "random":
        keys = rng.integers(-300, 300, 20_000) * (1 << 40) + rng.integers(
            0, 4, 20_000)
        owners = rng.integers(0, 5_000, 20_000)
        bits = 12
    else:
        keys = np.concatenate([np.full(5_000, 12345), rng.integers(
            0, 1 << 62, 40_000)])
        owners = np.concatenate([np.arange(5_000), rng.integers(
            0, 40_000, 40_000)])
        order = rng.permutation(keys.size)
        keys, owners = keys[order], owners[order]
        bits = sj.bucket_bits(keys.size)
    return (torch.from_numpy(keys.astype(np.int64)).to(device),
            torch.from_numpy(owners.astype(np.int32)).to(device), bits)


@pytest.mark.parametrize("case", ["random", "oversized"])
def test_d1_partition_and_join_match_reference(cuda_device, case):
    """The partition element for element and the join in its order,
    against the plain versions; the same order on a second run."""
    keys, owners, bits = _partition_input(case, cuda_device)
    want = sj.partition_reference(keys, owners, bits)
    got = sj.partition(keys.clone(), owners.clone(), bits)
    again = sj.partition(keys.clone(), owners.clone(), bits)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)
    sizes = torch.diff(want[2], prepend=want[2].new_zeros(1))
    if case == "random":
        assert int((sizes == 0).sum()) > 0
    else:
        assert int(sizes.max()) > sj.join_cap()
    pairs = sj.join_pairs(*got)
    assert torch.equal(pairs, sj.join_buckets_reference(*want))
    assert torch.equal(pairs, sj.join_pairs(*again))
    skeys, order = torch.sort(keys)
    assert torch.equal(torch.sort(pairs).values, torch.sort(
        sj.join_pairs_reference(skeys, owners[order])).values)


def test_d1_partition_and_join_refuse_what_the_kernels_cannot_read(
        cuda_device):
    keys, owners, bits = _partition_input("random", cuda_device)
    with pytest.raises(ValueError, match="int64"):
        sj.partition(keys.int(), owners, bits)
    with pytest.raises(ValueError, match="int32"):
        sj.partition(keys, owners.long(), bits)
    with pytest.raises(ValueError, match="share a device"):
        sj.partition(keys, owners.cpu(), bits)
    with pytest.raises(ValueError, match="contiguous"):
        sj.partition(keys[::2], owners[::2], bits)
    pkeys, powners, ends = sj.partition(keys, owners, bits)
    with pytest.raises(ValueError, match="2\\^bits"):
        sj.join_count(pkeys, powners, ends[:-1])
    with pytest.raises(ValueError, match="2\\^bits"):
        sj.join_count(pkeys, powners, ends.cpu())
    with pytest.raises(ValueError, match="int64"):
        sj.join_emit(pkeys, powners, ends, None, ends.int(), 0)
    counts, record = sj.join_count(pkeys, powners, ends)
    with pytest.raises(ValueError, match="record"):
        sj.join_emit(pkeys, powners, ends, (record[0][1:], record[1]),
                     torch.cumsum(counts, 0), int(counts.sum()))


#: a row_word that starts row 1 inside row 0's words (not a multiple of 4)
TRAP_PROBE = """import torch
from swarm_tpu_torch.ops import neighbors_sortjoin as sj
dev = torch.device("cuda", 0)
codes = torch.zeros(200, dtype=torch.uint8, device=dev)
offsets = torch.zeros(2, dtype=torch.int64, device=dev)
lengths = torch.full((2,), 100, dtype=torch.int32, device=dev)
row_word = torch.tensor([0, {start}], device=dev)
sj.keygen_count(codes, offsets, lengths, row_word, {n_words})
torch.cuda.synchronize()
"""


@pytest.mark.parametrize("start,n_words", [(6, 14), (8, 12), (8, 20)],
                         ids=["misaligned", "past_the_words", "short"])
def test_d1_kernels_trap_on_a_layout_that_does_not_fit(cuda_device, start,
                                                        n_words):
    """A layout the kernels cannot read fails its launch (in a process of
    its own: the trap ends the CUDA context), and the next synchronisation
    raises."""
    import subprocess
    import sys
    from pathlib import Path

    r = subprocess.run(
        [sys.executable, "-c", TRAP_PROBE.format(start=start,
                                                 n_words=n_words)],
        capture_output=True, timeout=300,
        env={**__import__("os").environ,
             "PYTHONPATH": str(Path(__file__).resolve().parent.parent)})
    assert r.returncode != 0
    assert b"CUDA error" in r.stderr or b"AcceleratorError" in r.stderr


# ---- the fastidious graft kernels (csrc/graft.cu) -------------------------

GRAFT_CASES = ["ragged_edge_rows", "insertion_run", "fastidious_corpus",
               "empty_side", "long_insertion_run", "graft_edge_rows"]

#: an insertion run of 4,204 rows sharing one variant (the row they are
#: insertions of): all but every 500th row light, a light bucket beyond
#: the join's shared-memory table (ft.JOIN_TILE = 1,024), so tiled, against
#: 9 heavy rows
LONG_GRAFT_RUN = 1400


def _graft_case(tmp_path, case):
    """(db, heavy, light) of a case: every other row light on the short
    rows cases, all but every 500th on long_insertion_run, a quarter
    light at random on the corpus, no light row on empty_side, the rows
    two edits from a base row on graft_edge_rows."""
    if case == "fastidious_corpus":
        fastidious_corpus(tmp_path / "c.fasta", n=3000, seed=7)
        db = read_db(tmp_path / "c.fasta")
        light = np.random.default_rng(7).random(len(db)) < 0.25
    elif case == "graft_edge_rows":
        rows, light = graft_edge_rows()
        db = make_db(tmp_path, rows_records(rows))
        light = light[record_index(db)]
    else:
        rows = {"ragged_edge_rows": ragged_edge_rows,
                "insertion_run": insertion_run, "empty_side": insertion_run,
                "long_insertion_run": lambda: insertion_run(
                    length=LONG_GRAFT_RUN)}[case]()
        db = make_db(tmp_path, rows_records(rows))
        light = np.arange(len(db)) % (
            500 if case == "long_insertion_run" else 2) != 0
        if case == "empty_side":
            light[:] = False
    return db, np.nonzero(~light)[0], np.nonzero(light)[0]


def _graft_rows(db, device):
    """(words, row_word, lengths): the ragged rows on the device, packed
    by d1_keygen's count pass, as GraftEngine packs them."""
    return ft.GraftEngine(db, device).packed_rows()


def _check_join(skeys, spays, s_buckets, bkeys, bpays, b_buckets):
    """graft_join on partitioned sides against its plain versions: the
    count pass' counts and records (join_record_reference), the pairs
    element for element (join_reference), neither side written; returns
    the pairs."""
    before = [x.clone() for x in (skeys, spays, bkeys, bpays)]
    counts, record = ft.join_count(skeys, s_buckets, bkeys, b_buckets)
    ends, total = sj._cumsum_total(counts)
    pairs = ft.join_emit(spays, bpays, record, ends, total)
    torch.cuda.synchronize()
    want_counts, want = ft.join_record_reference(skeys, s_buckets, bkeys,
                                                 b_buckets)
    assert torch.equal(counts, want_counts)
    assert torch.equal(record.n_rec, want.n_rec)
    e = torch.arange(bkeys.numel(), device=bkeys.device)
    valid = e % ft.JOIN_CHUNK < want.n_rec.long()[e // ft.JOIN_CHUNK]
    assert torch.equal(record.rec[valid], want.rec[valid])
    assert torch.equal(pairs, ft.join_reference(skeys, spays, bkeys, bpays))
    for x, y in zip(before, (skeys, spays, bkeys, bpays)):
        assert torch.equal(x, y)
    return pairs


@pytest.mark.parametrize("case", GRAFT_CASES)
def test_graft_kernels_match_reference(tmp_path, cuda_device, case):
    """graft_keygen (counts, keys, payloads), graft_join (counts and
    records a chunk, pairs in the kernel's order, both sides unwritten)
    and graft_verify (flags, each light row's smallest heavy one) against
    their plain versions on the same card tensors; the partition between
    them is d1_partition."""
    db, heavy, light = _graft_case(tmp_path, case)
    words, row_word, lengths = _graft_rows(db, cuda_device)
    zob_np = ft.make_zobrist_pair(int(db.longest))
    zob = ft.zobrist_tensor(zob_np, cuda_device)
    zob_plain = ft.zobrist_tensor(zob_np, "cpu").to(cuda_device)
    before = dict(ft.launches)
    sides = []
    for amps in (light, heavy):  # the light side as the small one
        ids = torch.from_numpy(amps.astype(np.int64)).to(cuda_device)
        counts = ft.keygen_count(words, row_word, lengths, ids)
        ends, total = sj._cumsum_total(counts)
        keys, pays = ft.keygen_emit(words, row_word, lengths, ids, zob, ends,
                                    total)
        torch.cuda.synchronize()
        want_keys, want_counts = ft.variant_keys_reference(
            words, row_word, lengths, ids, zob_plain)
        assert torch.equal(counts.long(), want_counts)
        assert torch.equal(counts, ft.variant_counts_reference(
            words, row_word, lengths, ids))
        assert torch.equal(keys, want_keys)
        assert torch.equal(pays.long(), torch.arange(total,
                                                     device=cuda_device))
        sides.append((ids, ends, keys, pays))
    (s_ids, s_ends, skeys, spays), (b_ids, b_ends, bkeys, bpays) = sides
    bits = sj.bucket_bits(skeys.numel() + bkeys.numel())
    skeys, spays, s_buckets = sj.partition(skeys, spays, bits)
    bkeys, bpays, b_buckets = sj.partition(bkeys, bpays, bits)
    before_join = ft.launches["graft_join"]
    pairs = _check_join(skeys, spays, s_buckets, bkeys, bpays, b_buckets)
    join_launches = ft.launches["graft_join"] - before_join
    best = torch.full((len(db),), 2**31 - 1, dtype=torch.int32,
                      device=cuda_device)
    want_best = best.clone()
    ok = ft.verify(words, row_word, lengths, s_ids, s_ends, b_ids, b_ends,
                   pairs, False, best)
    torch.cuda.synchronize()
    want = ft.verify_reference(words, row_word, lengths, s_ids, s_ends,
                               b_ids, b_ends, pairs)
    ft.best_reference(s_ids, s_ends, b_ids, b_ends, pairs[want], False,
                      want_best)
    assert torch.equal(ok, want)
    assert torch.equal(best, want_best)
    sizes = torch.diff(s_buckets, prepend=s_buckets.new_zeros(1))
    if case == "long_insertion_run":
        assert int(sizes.max()) > ft.JOIN_TILE
    n_keygen = 2 * sum(int(x.numel() > 0) for x in (s_ids, b_ids))
    assert ft.launches["graft_keygen"] == before["graft_keygen"] + n_keygen
    assert join_launches == int(bkeys.numel() > 0) + int(pairs.numel() > 0)
    assert ft.launches["graft_verify"] == before["graft_verify"] + int(
        pairs.numel() > 0)
    assert bool(want.any()) == (case != "empty_side")


@pytest.mark.parametrize("small_is_heavy", [False, True])
@pytest.mark.parametrize("case", ["graft_edge_rows", "ragged_edge_rows",
                                  "fastidious_corpus", "long_insertion_run"])
def test_graft_verify_on_join_and_random_pairs(tmp_path, cuda_device, case,
                                               small_is_heavy):
    """graft_verify against verify_reference and best_reference element
    for element, on the join's pairs (edits on word edges, deletions in
    runs, rows of 1 to 5,006 nt) and on 4,096 pairs of random keys of the
    two sides, whose variants mostly differ, in length too; the small
    side (the light one) labelled heavy or light."""
    db, heavy, light = _graft_case(tmp_path, case)
    words, row_word, lengths = _graft_rows(db, cuda_device)
    zob = ft.zobrist_tensor(ft.make_zobrist_pair(int(db.longest)),
                            cuda_device)
    sides = []
    for amps in (light, heavy):
        ids = torch.from_numpy(amps.astype(np.int64)).to(cuda_device)
        ends, total = sj._cumsum_total(ft.keygen_count(words, row_word,
                                                       lengths, ids))
        keys, pays = ft.keygen_emit(words, row_word, lengths, ids, zob, ends,
                                    total)
        sides.append((ids, ends, total, *sj.partition(keys, pays, 8)))
    (s_ids, s_ends, s_total, skeys, spays, s_buckets), \
        (b_ids, b_ends, b_total, bkeys, bpays, b_buckets) = sides
    g = torch.Generator(device=cuda_device)
    g.manual_seed(20261019)
    rand = (torch.randint(0, s_total, (4096,), generator=g,
                          device=cuda_device) << 32) | torch.randint(
        0, b_total, (4096,), generator=g, device=cuda_device)
    pairs = torch.cat([ft.join_pairs(skeys, spays, s_buckets, bkeys, bpays,
                                     b_buckets), rand])
    best = torch.full((len(db),), 2**31 - 1, dtype=torch.int32,
                      device=cuda_device)
    want_best = best.clone()
    ok = ft.verify(words, row_word, lengths, s_ids, s_ends, b_ids, b_ends,
                   pairs, small_is_heavy, best)
    torch.cuda.synchronize()
    want = ft.verify_reference(words, row_word, lengths, s_ids, s_ends,
                               b_ids, b_ends, pairs)
    ft.best_reference(s_ids, s_ends, b_ids, b_ends, pairs[want],
                      small_is_heavy, want_best)
    assert torch.equal(ok, want)
    assert torch.equal(best, want_best)
    assert bool(want[:-4096].all()) and not bool(want[-4096:].all())


#: graft_verify on one row of ten A (65 keys: 4 + 60 + one run start),
#: given a payload PAY of a side that claims ENDS keys: past the side's
#: keys (65 of 65) and a deletion slot past the row's run starts (65 of
#: 66) trap
GRAFT_VERIFY_TRAP_PROBE = """import torch
from swarm_tpu_torch.ops import fastidious_torch as ft
dev = torch.device("cuda", 0)
words = torch.zeros(4, dtype=torch.int32, device=dev)
lengths = torch.tensor([10], dtype=torch.int32, device=dev)
row_word = torch.zeros(1, dtype=torch.int64, device=dev)
ids = torch.zeros(1, dtype=torch.int64, device=dev)
ends = torch.tensor([ENDS], device=dev)
best = torch.full((1,), 2**31 - 1, dtype=torch.int32, device=dev)
ft.verify(words, row_word, lengths, ids, ends, ids, ends,
          torch.tensor([PAY << 32], device=dev), True, best)
torch.cuda.synchronize()
"""


@pytest.mark.parametrize("ends,pay", [(65, 65), (66, 65)])
def test_graft_verify_traps_on_a_payload_it_cannot_decode(cuda_device, ends,
                                                          pay):
    words = torch.zeros(4, dtype=torch.int32)
    lengths = torch.tensor([10], dtype=torch.int32)
    ids, row_word = torch.zeros(1, dtype=torch.int64), torch.zeros(
        1, dtype=torch.int64)
    with pytest.raises(ValueError):  # the plain version refuses it too
        ft.verify_reference(words, row_word, lengths, ids,
                            torch.tensor([ends]), ids, torch.tensor([ends]),
                            torch.tensor([pay << 32]))
    assert _traps(GRAFT_VERIFY_TRAP_PROBE.replace("ENDS", str(ends))
                  .replace("PAY", str(pay)))


def _random_sides(dev, n_small, n_big, distinct, bits, seed):
    """Two sides of random keys drawn from `distinct` values, partitioned
    into 2^bits buckets on the card."""
    rng = np.random.default_rng(seed)
    values = rng.integers(-(1 << 62), 1 << 62, distinct)
    sides = []
    for n in (n_small, n_big):
        keys = torch.from_numpy(values[rng.integers(0, distinct, n)])
        sides.extend(sj.partition(keys.to(dev), torch.arange(
            n, dtype=torch.int32, device=dev), bits))
    return sides


@pytest.mark.parametrize("case", ["skewed", "small_beyond_the_table",
                                  "many_tiny_buckets"])
def test_graft_join_on_bucket_shapes(cuda_device, case):
    """graft_join against its plain versions on a skewed bucket (a big
    bucket over many chunks against a small one over several tables),
    small buckets beyond one table (spans taken in tiles, keys repeated
    across them), and many buckets a chunk."""
    n_small, n_big, distinct, bits = {
        "skewed": (5_000, 60_000, 1_500, 0),
        "small_beyond_the_table": (9_000, 20_000, 20_000, 2),
        "many_tiny_buckets": (3_000, 200_000, 150_000, 12)}[case]
    skeys, spays, s_buckets, bkeys, bpays, b_buckets = _random_sides(
        cuda_device, n_small, n_big, distinct, bits, 20261017)
    pairs = _check_join(skeys, spays, s_buckets, bkeys, bpays, b_buckets)
    s_sizes = torch.diff(s_buckets, prepend=s_buckets.new_zeros(1))
    b_sizes = torch.diff(b_buckets, prepend=b_buckets.new_zeros(1))
    assert pairs.numel() > 0
    if case != "many_tiny_buckets":
        assert int(s_sizes.max()) > ft.JOIN_TILE
        assert int(b_sizes.max()) > ft.JOIN_CHUNK
    else:
        assert int(b_sizes.max()) < ft.JOIN_CHUNK // 4


def test_graft_keygen_spans_that_start_unaligned(tmp_path, cuda_device):
    """keygen_emit into keys and payloads whose rows start on every key
    parity and every place in a 16-byte quad of payloads (rows of 1 to 9
    bases, whose key counts are odd and even), on an aligned output."""
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, 4, L).astype(np.uint8)
            for L in rng.integers(1, 10, 300)]
    rows = list({r.tobytes(): r for r in rows}.values())
    db = make_db(tmp_path, rows_records(rows))
    words, row_word, lengths = _graft_rows(db, cuda_device)
    zob_np = ft.make_zobrist_pair(int(db.longest))
    ids = torch.arange(len(db), device=cuda_device)
    ends, total = sj._cumsum_total(ft.keygen_count(words, row_word, lengths,
                                                   ids))
    starts = (ends - torch.diff(ends, prepend=ends.new_zeros(1))).cpu()
    assert set((starts % 4).tolist()) == {0, 1, 2, 3}
    want, _ = ft.variant_keys_reference(
        words, row_word, lengths, ids,
        ft.zobrist_tensor(zob_np, "cpu").to(cuda_device))
    keys, pays = ft.keygen_emit(words, row_word, lengths, ids,
                                ft.zobrist_tensor(zob_np, cuda_device),
                                ends, total)
    torch.cuda.synchronize()
    assert torch.equal(keys, want)
    assert torch.equal(pays.long(), torch.arange(total, device=cuda_device))


def test_graft_join_constants_are_the_kernels(cuda_device):
    from swarm_tpu_torch._build import load

    assert load().swarm_graft_join_chunk() == ft.JOIN_CHUNK
    assert load().swarm_graft_join_tile() == ft.JOIN_TILE
    assert ft.PLACE_BITS == 10 and ft.COUNT_MAX == (1 << 22) - 1


@pytest.mark.parametrize("case,strip_keys", [
    (case, strip_keys) for case in GRAFT_CASES[:4]
    for strip_keys in (None, 5_000)] + [
    ("long_insertion_run", None), ("graft_edge_rows", None)])
def test_graft_engine_on_card_matches_native(tmp_path, cuda_device, case,
                                             strip_keys):
    """GraftEngine on the card against the native host join: count and
    candidates, in one pass and in strips of the bigger side. The native
    joins emit no deletion of a 1-nt row, so they do not count the empty
    midpoint of a heavy and a light 1-nt row; the engine counts it, as
    swarm_tpu's GraftEngine does."""
    db, heavy, light = _graft_case(tmp_path, case)
    eng = ft.GraftEngine(db, cuda_device)
    eng.MAX_STRIP_KEYS = strip_keys
    count, cand = eng.graft_candidates(heavy, light)
    want = _native.graft_join(db.codes, db.offsets, db.lengths, len(db),
                              heavy, light)
    want_count, want_cand = want if want is not None else (0, np.full(
        len(db), -1))
    one = db.lengths == 1
    assert count == want_count + int(one[heavy].sum()) * int(one[light].sum())
    np.testing.assert_array_equal(cand, want_cand)
    assert (count > 0) == (case != "empty_side")


def test_graft_dispatch_on_card_takes_the_device(tmp_path, cuda_device,
                                                monkeypatch):
    """-d 1 -f through main.run on the card: the device graft serves a
    corpus whose smaller side is far under 2<<20 keys unless
    SWARM_TPU_GRAFT_PROBE_MAX is set; the host join then serves; same
    bytes."""
    from swarm_tpu_torch.main import run

    fastidious_corpus(tmp_path / "in.fasta", n=3000, seed=7)
    calls = []
    real = ft.GraftEngine.graft_candidates

    def spy(self, heavy, light):
        calls.append(self.device.type)
        return real(self, heavy, light)

    monkeypatch.setattr(ft.GraftEngine, "graft_candidates", spy)
    out = {}
    for probe_max in (None, str(1 << 40)):
        if probe_max is None:
            monkeypatch.delenv("SWARM_TPU_GRAFT_PROBE_MAX", raising=False)
        else:
            monkeypatch.setenv("SWARM_TPU_GRAFT_PROBE_MAX", probe_max)
        work = tmp_path / str(probe_max)
        work.mkdir()
        monkeypatch.chdir(work)
        assert run(["-d", "1", "-f", "-o", "out.txt", "-s", "stats.txt",
                    "-l", "log.txt", "../in.fasta"], "swarm",
                   device=cuda_device) == 0
        out[probe_max] = [(work / f).read_bytes()
                          for f in ("out.txt", "stats.txt", "log.txt")]
    assert calls == ["cuda"]
    assert out[None] == out[str(1 << 40)]
    assert b"Made 0 grafts" not in out[None][2]


def test_graft_wrappers_refuse_what_the_kernels_cannot_read(tmp_path,
                                                            cuda_device):
    db, heavy, light = _graft_case(tmp_path, "insertion_run")
    words, row_word, lengths = _graft_rows(db, cuda_device)
    ids = torch.from_numpy(light.astype(np.int64)).to(cuda_device)
    zob_np = ft.make_zobrist_pair(int(db.longest))
    zob = ft.zobrist_tensor(zob_np, cuda_device)
    ends, total = sj._cumsum_total(ft.keygen_count(words, row_word, lengths,
                                                   ids))
    with pytest.raises(ValueError, match="int64"):
        ft.keygen_count(words, row_word, lengths, ids.int())
    with pytest.raises(ValueError, match="beside the rows"):
        ft.keygen_count(words, row_word, lengths, ids.cpu())
    with pytest.raises(ValueError, match="int32 table"):
        ft.keygen_emit(words, row_word, lengths, ids,
                       ft.zobrist_tensor(zob_np, "cpu").to(cuda_device),
                       ends, total)
    with pytest.raises(ValueError, match="2\\^31"):
        ft.keygen_emit(words, row_word, lengths, ids, zob, ends, 1 << 31)
    keys, pays = ft.keygen_emit(words, row_word, lengths, ids, zob, ends,
                                total)
    keys, pays, buckets = sj.partition(keys, pays, 2)
    with pytest.raises(ValueError, match="same buckets"):
        ft.join_pairs(keys, pays, buckets, keys, pays,
                      torch.cat([buckets, buckets]))
    with pytest.raises(RuntimeError, match="graft_join kernel launch"):
        ft.join_count(keys, buckets, torch.cat([keys, keys[:1]])[1:],
                      buckets)  # big keys off a 16-byte boundary
    counts, record = ft.join_count(keys, buckets, keys, buckets)
    pair_ends, n_pairs = sj._cumsum_total(counts)
    with pytest.raises(ValueError, match="share a device"):
        ft.join_emit(pays, pays, record._replace(rec=record.rec.cpu()),
                     pair_ends, n_pairs)
    with pytest.raises(ValueError, match="contiguous record"):
        ft.join_emit(pays, pays, record._replace(
            rec=torch.stack([record.rec, record.rec], 1)[:, 0]),
            pair_ends, n_pairs)
    best = torch.zeros(len(db), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="best"):
        ft.verify(words, row_word, lengths, ids, ends, ids, ends,
                  torch.zeros(1, dtype=torch.int64, device=cuda_device),
                  True, best)


#: a row_word whose row 1 lies past the words: the graft keygen traps
GRAFT_TRAP_PROBE = """import torch
from swarm_tpu_torch.ops import fastidious_torch as ft
dev = torch.device("cuda", 0)
words = torch.zeros(12, dtype=torch.int32, device=dev)
lengths = torch.full((2,), 100, dtype=torch.int32, device=dev)
row_word = torch.tensor([0, 8], device=dev)
ids = torch.tensor([0, 1], device=dev)
ft.keygen_count(words, row_word, lengths, ids)
torch.cuda.synchronize()
"""


#: an emit pass given fewer pairs than the chunk's record holds (3 small
#: keys equal to the one big key): it traps
GRAFT_JOIN_TRAP_PROBE = """import torch
from swarm_tpu_torch.ops import fastidious_torch as ft
dev = torch.device("cuda", 0)
one = torch.tensor([1], device=dev)
counts, record = ft.join_count(torch.ones(3, dtype=torch.int64, device=dev),
                               torch.tensor([3], device=dev), one, one)
ft.join_emit(torch.arange(3, dtype=torch.int32, device=dev), one.int(),
             record, one, 1)
torch.cuda.synchronize()
"""


def _traps(probe):
    import subprocess
    import sys
    from pathlib import Path

    r = subprocess.run(
        [sys.executable, "-c", probe], capture_output=True,
        timeout=300,
        env={**__import__("os").environ,
             "PYTHONPATH": str(Path(__file__).resolve().parent.parent)})
    return r.returncode != 0 and (b"CUDA error" in r.stderr
                                  or b"AcceleratorError" in r.stderr)


def test_graft_kernels_trap_on_a_layout_that_does_not_fit(cuda_device):
    assert _traps(GRAFT_TRAP_PROBE)


def test_graft_join_traps_on_more_pairs_than_counted(cuda_device):
    assert _traps(GRAFT_JOIN_TRAP_PROBE)


# ---- the sharded engines (swarm_tpu_torch/parallel) ----------------------

SHARDED_D1_CASES = ["ragged_edge_rows", "gen_corpus", "long_insertion_run",
                    "one_row"]


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("case", SHARDED_D1_CASES)
def test_d1_sharded_engine_on_card_matches_one_device(tmp_path, cuda_device,
                                                      case, k):
    """k in-process shards on cuda:0 against SortJoinNeighborEngine, both
    ways of cluster breaking; the shards launch the d=1 kernels."""
    from swarm_tpu_torch.parallel.mesh import (
        LocalShards,
        SortJoinShardedEngine,
    )

    db = _d1_db(tmp_path, case)
    ab = db.abundances.astype(np.int64)
    for no_break in (False, True):
        want = sj.SortJoinNeighborEngine(db, cuda_device).build_network(
            no_break, ab)
        before = dict(sj.launches)
        got = SortJoinShardedEngine(db, LocalShards(k, cuda_device)) \
            .build_network(no_break, ab)
        # the count pass, and the emit of each shard that holds rows
        assert 2 <= sj.launches["d1_keygen"] - before["d1_keygen"] <= 1 + k
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("case", ["ragged_edge_rows", "graft_edge_rows",
                                  "fastidious_corpus", "empty_side"])
def test_graft_sharded_engine_on_card_matches_one_device(
        tmp_path, cuda_device, case, k):
    """k in-process shards on cuda:0 against GraftEngine: count and
    candidates, with the sides as given and swapped, and in strips of
    50,000 keys (several on every case; strips of 5,000, as GraftEngine's
    card test takes, make hundreds on the 3,000-row corpus, each with its
    readbacks, and this test ran for minutes)."""
    from swarm_tpu_torch.parallel.mesh import LocalShards, ShardedGraftEngine

    db, heavy, light = _graft_case(tmp_path, case)
    for sides in ((heavy, light), (light, heavy)):
        want = ft.GraftEngine(db, cuda_device).graft_candidates(*sides)
        for strip_keys in (None, 50_000):
            eng = ShardedGraftEngine(db, LocalShards(k, cuda_device))
            eng.MAX_STRIP_KEYS = strip_keys
            got = eng.graft_candidates(*sides)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
        assert (want[0] > 0) == (case != "empty_side")


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("T,n,d", SCREEN_EDGE_CASES)
def test_d2_sharded_screen_on_card_matches_one_device(
        tmp_path, cuda_device, monkeypatch, T, n, d, k):
    """The screen over k in-process shards on cuda:0: the same pairs in
    the same order as one device's, over chunks of 2 steps."""
    from swarm_tpu_torch.parallel.mesh import LocalShards

    eng, _, _ = _screen_steps(tmp_path, monkeypatch, cuda_device, T, n, d)
    monkeypatch.setenv("SWARM_TPU_D2_CHUNK", "2")
    want = eng.candidate_pairs()
    before = dict(d2n.launches)
    got = eng.candidate_pairs_sharded(LocalShards(k, cuda_device))
    assert d2n.launches["d2_screen"] > before["d2_screen"]
    assert got[2] == want[2] > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_one_rank_nccl_group_matches_one_device(cuda_device, monkeypatch):
    """A one-rank NCCL group (NCCL takes one rank a card): its d=1
    edges, graft and d>=2 pairs equal the single-device engines'."""
    from swarm_tpu_torch.parallel import distributed, dryrun

    monkeypatch.setenv("SWARM_TPU_COORDINATOR",
                       f"127.0.0.1:{dryrun.free_port()}")
    monkeypatch.setenv("SWARM_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("SWARM_TPU_PROCESS_ID", "0")
    assert distributed.maybe_initialize(cuda_device) == 0
    try:
        import torch.distributed as dist

        assert dist.get_backend() == "nccl"
        db = dryrun.planted_db()
        got = dryrun.run_engines(db, cuda_device,
                                 distributed.RankShards(cuda_device))
    finally:
        distributed.finalize()
    assert got == dryrun.run_engines(db, cuda_device, None)
    assert len(got["edges"][0]) > 0 and got["graft"][0] > 0


# ---- the main-path pass of chip_smoke.py, byte for byte ------------------

def _differ(got, want):
    """The names of `want`'s output files that are empty or whose bytes
    `got`'s differ from."""
    return [name for name, path in want["files"].items()
            if not path.stat().st_size
            or got["files"][name].read_bytes() != path.read_bytes()]


class MainPaths:
    """The main paths' corpora (chip_smoke.make_corpora) and each path's
    run through the CLI on the card (chip_smoke.main_path), once, with
    the card held, as a second run in one process finds it
    (device.card_ready)."""

    def __init__(self, work, device):
        self.work, self.device = work, device
        self.corpus = chip_smoke.make_corpora(work, MAIN_PATHS)
        self.runs = {}

    def card(self, name):
        if name not in self.runs:
            self.runs[name] = chip_smoke.main_path(name, self.corpus,
                                                   self.work, self.device)
        return self.runs[name]


@pytest.fixture(scope="module")
def main_paths(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from swarm_tpu_torch import _build, device

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    _build.load()
    assert device.card_ready()
    return MainPaths(tmp_path_factory.mktemp("main_paths"), dev)


@pytest.mark.parametrize("name", list(MAIN_PATHS))
def test_main_path_on_card_equals_native(main_paths, name):
    """Each of chip_smoke.MAIN_PATHS (its corpus, flags and variables)
    through the CLI on the card, as the script's main-path pass runs it:
    every kernel the path names launches, and every output file equals
    the port's native engine's (SWARM_TPU_D2_ENGINE=native at d >= 2; at
    d = 1 SWARM_TPU_D1_NATIVE_MAX above n, and under -f the host graft
    join) byte for byte; a -f path's files also with the graft on the
    host join and the d=1 network on the card."""
    flags, env, kernels, native_env = MAIN_PATHS[name][2:]
    card = main_paths.card(name)
    assert [k for k in kernels if card["launches"][k] < 1] == []
    fasta, work = main_paths.corpus[name], main_paths.work
    native = chip_smoke.run_path(flags, fasta, work / f"{name}_native",
                                 native_env, main_paths.device)
    assert _differ(card, native) == []
    if "-f" in flags:
        host_graft = chip_smoke.run_path(
            flags, fasta, work / f"{name}_host_graft",
            {**env, "SWARM_TPU_GRAFT_PROBE_MAX": str(1 << 40)},
            main_paths.device)
        assert host_graft["launches"]["d1_keygen"] > 0
        assert host_graft["launches"]["graft_keygen"] == 0
        assert _differ(host_graft, native) == []


@pytest.mark.parametrize("name", chip_smoke.SHARDED_PATHS)
def test_main_path_over_shards_equals_one_device(main_paths, name):
    """The same run over four in-process shards on the card
    (chip_smoke.sharded_path): the shards take the d=1 network, the graft
    or the d>=2 screen (their counters in the run's record), the path's
    kernels launch, and every output file equals the single-device
    run's byte for byte."""
    flags, _, kernels, _ = MAIN_PATHS[name][2:]
    want = main_paths.card(name)
    got = chip_smoke.sharded_path(name, main_paths.corpus, main_paths.work,
                                  main_paths.device)
    engines = ["d2"] if flags[1] == "2" else \
        ["d1", "graft"] if "-f" in flags else ["d1"]
    assert {k: v for k, v in got["counters"].items()
            if k.endswith("_shards.count")} == {
        f"{e}_shards.count": chip_smoke.SHARDS for e in engines}
    assert all(got["counters"][f"{e}_shards.exchanges"] > 0
               for e in engines if e != "d2")
    assert [k for k in kernels if got["launches"][k] < 1] == []
    assert _differ(got, want) == []


def test_d2_sharded_pairs_at_scale_equal_one_device(main_paths):
    """d2_100k's candidate pairs over four in-process shards on the card
    (chip_smoke.sharded_pairs) equal one device's, in order."""
    ran = chip_smoke.sharded_pairs(main_paths.corpus, main_paths.device)
    want, got = ran["one_device"], ran["sharded"]
    assert ran["screens"] >= chip_smoke.SHARDS
    assert got[2] == want[2] > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_one_rank_nccl_run_equals_in_process(main_paths):
    """d1_full_100k through bin/swarm-torch as a one-rank NCCL group
    (chip_smoke.nccl_path): the run takes the sharded d=1 engine (the
    [timing] line of its exchange), launches the path's kernels (its
    launches line) and writes the in-process run's files byte for
    byte."""
    name = chip_smoke.NCCL_PATH
    kernels = MAIN_PATHS[name][4]
    want = main_paths.card(name)
    got = chip_smoke.nccl_path(main_paths.corpus, main_paths.work)
    assert any(ln.startswith("[timing] d1 shards 1 (cuda) exchange")
               for ln in got["stderr"])
    assert [k for k in kernels if got["launches"].get(k, 0) < 1] == []
    assert _differ(got, want) == []


def test_forwarded_runs_on_card_equal_in_process(main_paths):
    """The resident server on the card (chip_smoke.forwarded_paths):
    each of SERVER_PATHS forwarded to it twice (the second from the
    server's DB cache) writes the in-process run's files byte for byte,
    with no [timing] line on the forwarded run's stderr; the server's
    stderr shows the card's engine for each run, and the server exits 0
    after --shutdown."""
    served = chip_smoke.forwarded_paths(main_paths.corpus, main_paths.work)
    assert served["exit"] == [0, 0]
    for name in chip_smoke.SERVER_PATHS:
        want = main_paths.card(name)
        for k, got in enumerate(served[name]["runs"]):
            assert not any(ln.startswith("[timing]")
                           for ln in got["stderr"]), (name, k)
            assert _differ(got, want) == [], (name, k)
        assert served[name]["marked"] >= 2, name


@pytest.mark.parametrize("state", ["warm", "cold"])
@pytest.mark.parametrize("rule", list(chip_smoke.DISPATCH_PATHS))
def test_network_engine_from_its_threshold_on_card(main_paths, rule, state):
    """The CLI's dispatch rules on the card (chip_smoke.dispatch_path),
    at the threshold - 1 and at it, on the first records of the rule's
    corpus: the d=1 network's NATIVE_MAX and NATIVE_MAX_COLD (under -f
    NATIVE_MAX_GRAFT), the d>=2 engine's NETWORK_MIN and
    NETWORK_MIN_COLD; warm in this process, which holds the card, cold in
    a new process (bin/swarm-torch) each, which does not. The host
    engine below the threshold, the card's (its kernel's launches) from
    it up, and the files equal to the native engine's byte for byte."""
    if state == "warm":
        from swarm_tpu_torch import device

        assert device.card_ready()
    _, flags, _, native_env = chip_smoke.DISPATCH_PATHS[rule]
    ran = chip_smoke.dispatch_path(rule, state, main_paths.corpus,
                                   main_paths.work, main_paths.device)
    at = ran["threshold"]
    assert at == chip_smoke.dispatch_thresholds(rule)[state == "cold"]
    for k in (at - 1, at):
        got = ran[k]
        assert got["fasta"].read_bytes().count(b">") == k
        assert got["card"] == (k >= at), (k, got["launches"])
        native = chip_smoke.run_path(
            flags, got["fasta"], got["fasta"].with_name(
                f"{got['fasta'].stem}_native"), native_env,
            main_paths.device)
        assert _differ(got, native) == []


@pytest.mark.parametrize("threads", ["one", "every_core"])
@pytest.mark.parametrize("state", ["warm", "cold"])
def test_device_diffs_from_their_threshold_on_card(main_paths, state,
                                                   threads):
    """D2NetworkEngine.build_adjacency under the auto rule on the card
    (chip_smoke.dispatch_diffs), at the threshold - 1 and at it of
    d2_100k's first records' candidate pairs filled to the count, at -t 1
    (DEVICE_DIFFS_MIN) and -t of every core (DEVICE_DIFFS_MIN_THREADED),
    warm in this process after the d2_diffs kernel has run (d2_long's
    main path launches it), cold (their _COLD forms) in a fresh process:
    the native diffs below the threshold, the kernel from it up, and the
    adjacency equal to the native diffs'."""
    main_paths.card("d2_long")
    t = chip_smoke.diffs_threads()[threads == "every_core"]
    source = main_paths.work / f"dispatch_diffs_{state}_{threads}.fasta"
    chip_smoke.first_records(main_paths.corpus["d2_100k"],
                             chip_smoke.DIFFS_RECORDS, source)
    ran = chip_smoke.dispatch_diffs(main_paths.device, source, state, t) \
        if state == "warm" else chip_smoke.dispatch_diffs_cold(source, t)
    at = ran["threshold"]
    assert sorted(ran["points"]) == [at - 1, at]
    for k, point in ran["points"].items():
        assert point["card"] == (k >= at), k
        assert point["auto"] == point["native"], k
