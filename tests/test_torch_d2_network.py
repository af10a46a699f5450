"""The port's d>=2 network engine (swarm_tpu_torch/ops/d2_network.py)
against swarm_tpu's JAX engine, on the CPU with a small tile so the
multi-tile scan runs."""

import numpy as np
import pytest
import torch

from swarm_tpu.ops.d2_diffs_jax import DeviceDiffEngine as JaxDiffEngine
from swarm_tpu.ops.d2_network import D2NetworkEngine as JaxNetworkEngine
from swarm_tpu_torch.corpora import (
    CSR_CASES,
    screen_order_pairs,
    screen_order_tasks,
)
from swarm_tpu_torch.models.general import choose_engine
from swarm_tpu_torch.ops.d2_diffs import DeviceDiffEngine
from swarm_tpu_torch.ops.d2_network import D2NetworkEngine

from test_d2_network import _db_from_seqs

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


@pytest.mark.parametrize("route,fault", [
    ("native", "range"), ("device", "range"), ("device", "low"),
    ("device", "order"), ("device", "equal")])
def test_out_of_range_pair_fails_loudly(monkeypatch, route, fault):
    """A pair index outside [0, n), or a pair out of order, from the
    extraction (a decode bug) fails where the pairs reach the host on
    the native route, and where d2_tasks lays them out on the device
    route, before any exact diff runs."""
    from swarm_tpu_torch import _native
    from swarm_tpu_torch.ops import d2_diffs, d2_network

    db = _clouds(81, 4, 10, 40, 2)
    eng = D2NetworkEngine(db, 2, CPU)
    a, b = {"range": (0, len(db)), "low": (-1, 3), "order": (5, 4),
            "equal": (4, 4)}[fault]
    ga = torch.tensor([1, a], dtype=torch.int32)
    gb = torch.tensor([2, b], dtype=torch.int32)
    monkeypatch.setattr(d2_network, "extract_pairs", lambda *args: (ga, gb))
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", route)

    def no_diffs(*args, **kwargs):
        raise RuntimeError("the exact diffs ran on flagged pairs")

    monkeypatch.setattr(d2_diffs, "d2_diffs", no_diffs)
    monkeypatch.setattr(_native, "d2_diffs_pairs", no_diffs)
    match = "out of order" if fault in ("order", "equal") else \
        "out-of-range pair index"
    with pytest.raises(AssertionError, match=match):
        eng.build_adjacency(4, 12, 4, False)


# ---- the diff tasks on the device (d2_tasks) ------------------------------

def _pairs_case(case):
    """(pa, pb, ab) int64 arrays for a task-layout case."""
    if case in ("ties", "dense", "forward_only", "reverse_only"):
        pa, pb, ab = screen_order_pairs(
            3000, 12, 21, T=128, dense=500 if case == "dense" else 0)
        if case == "forward_only":  # ab[a] > ab[b] wherever a < b
            ab = np.arange(len(ab), 0, -1, dtype=np.int64)
        elif case == "reverse_only":
            ab = np.arange(1, len(ab) + 1, dtype=np.int64)
        return pa, pb, ab
    ab = np.array([5, 3, 3, 9, 1, 2, 2, 8], dtype=np.int64)
    if case == "one_pair":
        return np.array([2], np.int64), np.array([6], np.int64), ab
    return np.zeros(0, np.int64), np.zeros(0, np.int64), ab


@pytest.mark.parametrize("no_break", [False, True])
@pytest.mark.parametrize("case", ["ties", "dense", "forward_only",
                                  "reverse_only", "one_pair", "no_pairs"])
def test_d2_tasks_reference_equals_host_layout(case, no_break):
    """d2_tasks on the CPU (tasks_reference) gives task_layout's tasks of
    the directions `directions` admits, element for element and in
    order: pairs in the screen's order with most abundances tied, a
    dense cloud, one direction only, one pair and none."""
    from swarm_tpu_torch.ops.d2_diffs import directions, task_layout
    from swarm_tpu_torch.ops.d2_network import d2_tasks

    pa, pb, ab = _pairs_case(case)
    want = task_layout(pa, pb, *directions(ab, pa, pb, no_break))
    tq, td, bad = d2_tasks(torch.from_numpy(pa.astype(np.int32)),
                           torch.from_numpy(pb.astype(np.int32)),
                           torch.from_numpy(ab), len(ab), no_break)
    assert bad is False
    for x, y in zip((tq, td), want):
        assert x.dtype == torch.int64
        np.testing.assert_array_equal(x.numpy(), y)
    if case == "forward_only" and not no_break:
        np.testing.assert_array_equal(tq.numpy(), pa)
    elif case == "reverse_only" and not no_break:
        np.testing.assert_array_equal(tq.numpy(), pb)


@pytest.mark.parametrize("pair", [(-1, 3), (3, 8), (4, 4), (5, 2)])
def test_d2_tasks_reference_flags_pairs_it_cannot_lay_out(pair):
    from swarm_tpu_torch.ops.d2_network import d2_tasks, pair_fault

    ga = torch.tensor([0, pair[0], 6], dtype=torch.int32)
    gb = torch.tensor([1, pair[1], 7], dtype=torch.int32)
    tq, td, bad = d2_tasks(ga, gb, torch.ones(8, dtype=torch.int64), 8,
                           False)
    assert bad is True and tq.numel() == td.numel() == 0
    fault = pair_fault(ga, gb, 8)
    assert isinstance(fault, AssertionError)
    if 0 <= min(pair) and max(pair) < 8:
        assert "out of order" in str(fault)
    else:
        assert str(fault).startswith("d2 screen produced out-of-range pair "
                                     "index") and "n=8)" in str(fault)


def test_d2_tasks_checks_inputs_and_never_falls_back():
    from swarm_tpu_torch.ops import d2_network

    ga = torch.tensor([0, 1], dtype=torch.int32)
    gb = torch.tensor([2, 3], dtype=torch.int32)
    ab = torch.ones(4, dtype=torch.int64)
    assert d2_network.d2_tasks(ga, gb, ab, 4, False)[0].tolist() == \
        [2, 3, 0, 1]
    for args in ((ga.long(), gb, ab, 4), (ga, gb[:1], ab, 4),
                 (ga, gb, ab.int(), 4), (ga, gb, ab, 5)):
        with pytest.raises(ValueError):
            d2_network.d2_tasks(*args, False)
    before = dict(d2_network.launches)
    with pytest.raises(ValueError, match="no d2_tasks kernel"):
        d2_network.d2_tasks(ga.to("meta"), gb.to("meta"), ab.to("meta"), 4,
                            False)
    assert d2_network.launches == before


def test_engine_choice(monkeypatch):
    from swarm_tpu_torch import device

    cuda = torch.device("cuda", 0)
    monkeypatch.delenv("SWARM_TPU_D2_ENGINE", raising=False)
    # measured on the card (scripts/dispatch_sweep.py, PERF.md §5): in a
    # fresh process, and in one that holds the card already
    for ready, at in ((False, 16384), (True, 4096)):
        monkeypatch.setattr(device, "card_ready", lambda: ready)
        assert choose_engine(at, 8, cuda) == "network"
        assert choose_engine(at - 1, 8, cuda) == "native"
        assert choose_engine(at, 16, cuda) == "native"
        assert choose_engine(100_000, 8, CPU) == "native"
    monkeypatch.setenv("SWARM_TPU_D2_ENGINE", "network")
    assert choose_engine(10, 8, CPU) == "network"
    assert choose_engine(10, 16, CPU) == "native"
    # the seed/subseed loop runs only when asked for, in either regime
    for engine in ("python", "device"):
        monkeypatch.setenv("SWARM_TPU_D2_ENGINE", engine)
        assert choose_engine(100_000, 8, cuda) == engine
        assert choose_engine(10, 16, CPU) == engine
    monkeypatch.setenv("SWARM_TPU_D2_ENGINE", "jax")
    with pytest.raises(ValueError):
        choose_engine(10, 8, CPU)


# ---- the CSR on the device (csr_partition) --------------------------------

def _lexsort_csr(tq, td, diffs, n):
    """The host's CSR of the kept tasks: np.lexsort by (source, target),
    as the JAX engine builds it."""
    keep = diffs >= 0
    ef, et, ed = tq[keep], td[keep], diffs[keep]
    order = np.lexsort((et, ef))
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(ef, minlength=n), out=starts[1:])
    return starts, et[order], ed[order]


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 65_536, 65_537, 500_000,
                               (1 << 31) - 1])
def test_csr_passes_cover_the_source_bits(n):
    from swarm_tpu_torch.ops.d2_network import CSR_DIGIT_BITS, csr_passes

    bits = max((n - 1).bit_length(), 1)
    passes = csr_passes(n)
    assert len(passes) == -(-bits // CSR_DIGIT_BITS)
    shift = 0
    for at, width in passes:
        assert at == shift and 1 <= width <= CSR_DIGIT_BITS
        shift += width
    assert shift == bits
    assert max(w for _, w in passes) - min(w for _, w in passes) <= 1


@pytest.mark.parametrize("n,cloud,dense", CSR_CASES)
def test_csr_partition_reference_equals_lexsort(n, cloud, dense):
    from swarm_tpu_torch.ops.d2_network import csr_partition

    tq, td, diffs = screen_order_tasks(n, cloud, 7, T=128, dense=dense)
    starts, adj_to, adj_diff, bad = csr_partition(
        torch.from_numpy(tq), torch.from_numpy(td), torch.from_numpy(diffs),
        n)
    want_starts, want_to, want_diff = _lexsort_csr(tq, td, diffs, n)
    assert int(bad) == 0
    assert starts.dtype == adj_to.dtype == torch.int32
    assert adj_diff.dtype == torch.uint8
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    np.testing.assert_array_equal(adj_to.numpy(), want_to)
    np.testing.assert_array_equal(adj_diff.numpy(), want_diff)


@pytest.mark.parametrize("fault", ["shuffled", "swapped", "repeated",
                                   "source_range", "target_range",
                                   "wide_diff", "none"])
def test_csr_partition_reference_flags_what_is_not_exact(fault):
    """`bad` is set where the tasks are out of the screen's order (the
    stable partition would not be the sorted CSR) or out of range, and
    not where only rejected tasks are."""
    from swarm_tpu_torch.ops.d2_network import csr_partition

    n = 300
    tq, td, diffs = screen_order_tasks(n, 12, 8, T=128)
    rng = np.random.default_rng(9)
    if fault == "shuffled":
        perm = rng.permutation(len(tq))
        tq, td, diffs = tq[perm], td[perm], diffs[perm]
    elif fault == "swapped":  # two forward targets of one source
        last = len(tq) - 1
        at = next(i for i in range(last, 0, -1) if tq[i] == tq[i - 1]
                  and diffs[i] >= 0 and diffs[i - 1] >= 0)
        td[[at - 1, at]] = td[[at, at - 1]]
    elif fault == "repeated":
        tq, td, diffs = (np.concatenate([x, x[-1:]]) for x in (tq, td, diffs))
        diffs[-2:] = 1
    elif fault == "source_range":
        tq[5], diffs[5] = n, 1
    elif fault == "target_range":
        td[5], diffs[5] = -1, 1
    elif fault == "wide_diff":
        diffs[5] = 256
    else:  # the rejected tasks may be anything
        tq[diffs < 0] = n + 7
        diffs[5] = -1
    *_, bad = csr_partition(torch.from_numpy(tq), torch.from_numpy(td),
                            torch.from_numpy(diffs), n)
    assert int(bad) == (fault != "none")


def test_csr_partition_reference_takes_no_tasks():
    from swarm_tpu_torch.ops.d2_network import csr_partition

    empty = torch.zeros(0, dtype=torch.int64)
    for diffs in (torch.zeros(0, dtype=torch.int32), None):
        src = empty if diffs is not None else torch.arange(4)
        df = diffs if diffs is not None else torch.full((4,), -1,
                                                        dtype=torch.int32)
        starts, adj_to, adj_diff, bad = csr_partition(src, src.clone(), df,
                                                      10)
        assert starts.tolist() == [0] * 11
        assert adj_to.numel() == adj_diff.numel() == int(bad) == 0


def _no_edge_clouds(seed):
    """Amplicons all far apart: the screen passes nothing."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, size=60).astype(np.uint8) for _ in range(150)]
    db = _db_from_seqs(seqs)
    db.abundances = rng.integers(1, 6, size=len(seqs)).astype(np.int64)
    return db


def _clouds_and_loners(seed):
    """Clouds and, between them, amplicons with no edge."""
    db = _clouds(seed, 12, 10, 56, 3)
    rng = np.random.default_rng(seed + 1)
    loners = [rng.integers(0, 4, size=70).astype(np.uint8)
              for _ in range(60)]
    seqs = [db.codes[db.offsets[i]:db.offsets[i] + db.lengths[i]]
            for i in range(len(db))] + loners
    out = _db_from_seqs(seqs)
    out.abundances = np.concatenate(
        [db.abundances, rng.integers(1, 6, size=len(loners))]).astype(
            np.int64)
    return out


@pytest.mark.parametrize(
    "case,tile,chunk,no_break,shards",
    [
        ("tile32", "32", "512", False, 0),    # 9 tiles, 45 steps
        ("chunk1", "64", "1", False, 0),
        ("chunk2", "64", "2", True, 0),
        ("chunk512", "128", "512", True, 0),
        ("shards", "64", "2", False, 3),      # in-process shards
        ("no_edges", "64", "512", False, 0),
        ("loners", "64", "2", False, 0),      # amplicons with no edge
    ],
)
def test_device_csr_equals_jax_lexsort(monkeypatch, case, tile, chunk,
                                       no_break, shards):
    """The CSR built from the device tasks (here the plain versions,
    SWARM_TPU_D2_DIFFS=device on the CPU) equals the JAX engine's,
    sorted on the host by np.lexsort, array for array."""
    from swarm_tpu_torch import metrics
    from swarm_tpu_torch.parallel.mesh import LocalShards

    db = {"no_edges": lambda: _no_edge_clouds(91),
          "loners": lambda: _clouds_and_loners(92)}.get(
              case, lambda: _clouds(93, 20, 12, 56, 3))()
    monkeypatch.setenv("SWARM_TPU_D2_TILE", tile)
    monkeypatch.setenv("SWARM_TPU_D2_CHUNK", chunk)
    eng = D2NetworkEngine(db, 2, CPU,
                          shards=LocalShards(shards, CPU) if shards else None)
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "device")
    metrics.reset()
    got = eng.build_adjacency(4, 12, 4, no_break)
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "native")
    want = JaxNetworkEngine(db, 2).build_adjacency(4, 12, 4, no_break)
    for x, y in zip(got, want):
        if isinstance(y, np.ndarray):
            assert x.dtype == np.int64
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
    edges = len(want[2])
    assert metrics.last_run["d2_network.csr_device_edges"] == edges
    assert (edges == 0) == (case == "no_edges")
    if case == "loners":
        assert (want[1] == 0).sum() >= 60


def test_out_of_step_order_pairs_fail_loudly(monkeypatch):
    """Pairs out of the screen's step order (each chunk's reversed) would
    make the partition a wrong CSR, on either diffs path: its check
    raises; in order, the same engine builds its edges."""
    from swarm_tpu_torch.ops import d2_network

    db = _clouds(82, 6, 10, 40, 2)
    eng = D2NetworkEngine(db, 2, CPU)
    extract = d2_network.extract_pairs
    flipped = lambda *args: tuple(x.flip(0) for x in extract(*args))  # noqa: E731
    for mode in ("device", "native"):
        monkeypatch.setenv("SWARM_TPU_D2_DIFFS", mode)
        monkeypatch.setattr(d2_network, "extract_pairs", extract)
        assert len(eng.build_adjacency(4, 12, 4, False)[2]) > 0
        monkeypatch.setattr(d2_network, "extract_pairs", flipped)
        with pytest.raises(AssertionError, match="CSR check failed"):
            eng.build_adjacency(4, 12, 4, False)
