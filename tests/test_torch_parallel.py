"""The port's sharded engines (swarm_tpu_torch/parallel) against
swarm_tpu's mesh engines on its virtual 8-device CPU mesh
(tests/conftest.py) and against the port's single-device engines:

- d=1: SortJoinShardedEngine over k = 1-4 in-process shards against
  JAX's SortJoinShardedEngine and the port's SortJoinNeighborEngine,
  with and without cluster breaking, on planted neighbours, a
  mixed-length corpus and fewer rows than shards;
- graft: ShardedGraftEngine over k = 1, 2, 4 against JAX's
  ShardedGraftEngine (meshes of 2 and 4) and the port's GraftEngine,
  swapped sides and an empty side included, and in strips;
- d>=2: the sharded candidate pairs at k = 2, 3, 8 (T = 128) against
  JAX's candidate_pairs_sharded in order, and the adjacency;
- the route: the shards' bucket ranges cover [0, 2^B) once, a bucket's
  keys land on its owner, and the key split is contiguous;
- two gloo ranks against one process (parallel/dryrun.py);
- the selection: what SWARM_TORCH_SHARDS and the rank variables choose,
  main.run's dispatch to the sharded engines, and a failure that raises.
"""

import os
import tempfile
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from genfasta import amplicon_cloud
from swarm_tpu_torch import metrics, parallel
from swarm_tpu_torch.corpora import make_db, rows_records
from swarm_tpu_torch.ops import fastidious_torch as ft
from swarm_tpu_torch.ops import neighbors_sortjoin as sj
from swarm_tpu_torch.ops.d2_network import D2NetworkEngine
from swarm_tpu_torch.parallel import dryrun, mesh
from swarm_tpu_torch.parallel.mesh import (
    LocalShards,
    ShardedGraftEngine,
    SortJoinShardedEngine,
)
from test_jax_neighbors import _random_db
from cli_parity import mixed_lengths_fasta

CPU = torch.device("cpu")
RANK_VARS = ("SWARM_TPU_COORDINATOR", "SWARM_TPU_NUM_PROCESSES",
             "SWARM_TPU_PROCESS_ID")


@pytest.fixture(autouse=True)
def _no_shards_asked(monkeypatch):
    for name in ("SWARM_TORCH_SHARDS", *RANK_VARS):
        monkeypatch.delenv(name, raising=False)


def _jax_mesh(n_dev):
    return Mesh(np.array(jax.devices()[:n_dev]), ("amps",))


# ---- d=1 -----------------------------------------------------------------

def _db_of(records):
    with tempfile.TemporaryDirectory() as tmp:
        return make_db(tmp, records)


@lru_cache(maxsize=None)
def d1_db(case):
    if case == "planted":
        return _random_db(n=240, min_len=20, max_len=60, seed=9100)
    if case == "mixed_lengths":
        return _db_of([mixed_lengths_fasta()])
    # fewer rows than shards: a row, its neighbour and an unrelated one
    return _db_of(rows_records([np.array([0, 1, 2, 3, 0, 1], np.uint8),
                                np.array([0, 1, 2, 2, 0, 1], np.uint8),
                                np.array([3, 3, 1], np.uint8)]))


@lru_cache(maxsize=None)
def jax_d1_edges(case, no_break):
    from swarm_tpu.parallel.mesh import SortJoinShardedEngine as JaxEngine

    db = d1_db(case)
    return JaxEngine(db).build_network(no_break, db.abundances)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["planted", "mixed_lengths", "three_rows"])
def test_d1_sharded_equals_jax_and_one_device(case, k):
    db = d1_db(case)
    for no_break in (False, True):
        want = jax_d1_edges(case, no_break)
        one = sj.SortJoinNeighborEngine(db, CPU).build_network(
            no_break, db.abundances)
        metrics.reset()
        got = SortJoinShardedEngine(db, LocalShards(k, CPU)).build_network(
            no_break, db.abundances)
        assert len(want[0]) > 0
        for g, o, w in zip(got, one, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(o, w)
    assert metrics.last_run["d1_shards.count"] == k


def test_d1_sharded_rows_stay_for_the_graft():
    db = d1_db("planted")
    eng = SortJoinShardedEngine(db, LocalShards(3, CPU))
    eng.build_network(False, db.abundances)
    (dev, rows), = eng.packed_rows.items()
    want = ft.GraftEngine(db, CPU).packed_rows()
    assert dev == CPU
    for a, b in zip(rows, want):
        assert torch.equal(a, b)


# ---- graft ---------------------------------------------------------------

@lru_cache(maxsize=None)
def graft_case():
    """The corpus of tests/test_sharded_graft.py, its sides by abundance
    rank, and JAX's padded table."""
    from swarm_tpu.ops.neighbors import pad_codes
    from swarm_tpu.ops.neighbors_jax import _round_up, make_zobrist_pair

    db = _db_of([amplicon_cloud(seed=77, n_centers=12, cloud_size=18,
                                length=90, max_edits=3)])
    n = len(db)
    order = np.argsort(-db.abundances, kind="stable")
    heavy = np.sort(order[: n // 3]).astype(np.int64)
    light = np.sort(order[n // 3:]).astype(np.int64)
    width = _round_up(max(int(db.longest), 1), 64)
    table = (pad_codes(db.codes, db.offsets, db.lengths, width),
             db.lengths.astype(np.int32), np.asarray(make_zobrist_pair(width)))
    return db, heavy, light, table


@lru_cache(maxsize=None)
def jax_graft(n_dev, swapped):
    from swarm_tpu.parallel.mesh import ShardedGraftEngine as JaxEngine

    _, heavy, light, table = graft_case()
    sides = (light, heavy) if swapped else (heavy, light)
    return JaxEngine(*table, mesh=_jax_mesh(n_dev)).graft_candidates(*sides)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_graft_sharded_equals_jax_and_one_device(k):
    db, heavy, light, _ = graft_case()
    for swapped in (False, True):
        sides = (light, heavy) if swapped else (heavy, light)
        want = ft.GraftEngine(db, CPU).graft_candidates(*sides)
        got = ShardedGraftEngine(db, LocalShards(k, CPU)).graft_candidates(
            *sides)
        assert want[0] > 0
        # JAX's engine on a mesh of 2, and of 4 with the sides swapped
        j_count, j_cand = jax_graft(4 if swapped else 2, swapped)
        assert want[0] == j_count and np.array_equal(want[1], j_cand)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


def test_graft_sharded_strips_equal_one_pass():
    db, heavy, light, _ = graft_case()
    want = ft.GraftEngine(db, CPU).graft_candidates(heavy, light)
    eng = ShardedGraftEngine(db, LocalShards(3, CPU))
    eng.MAX_STRIP_KEYS = 20_000
    metrics.reset()
    got = eng.graft_candidates(heavy, light)
    assert got[0] == want[0] > 0
    np.testing.assert_array_equal(got[1], want[1])
    # the small side, then the strips
    assert metrics.last_run["graft_shards.exchanges"] > 2


@pytest.mark.parametrize("k", [1, 4])
def test_graft_sharded_empty_side(k):
    db, heavy, light, _ = graft_case()
    for sides in ((heavy, light[:0]), (heavy[:0], light)):
        count, cand = ShardedGraftEngine(db, LocalShards(k, CPU)) \
            .graft_candidates(*sides)
        assert count == 0 and (cand == -1).all()


def test_graft_sides_smaller_than_the_shards():
    """One heavy and three light amplicons over 4 shards: shards that
    hold no key of a side still enter every exchange."""
    db, heavy, light, _ = graft_case()
    want = ft.GraftEngine(db, CPU).graft_candidates(heavy[:1], light[:3])
    got = ShardedGraftEngine(db, LocalShards(4, CPU)).graft_candidates(
        heavy[:1], light[:3])
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


# ---- d>=2 screen ---------------------------------------------------------

@lru_cache(maxsize=None)
def d2_engines(d):
    from swarm_tpu.ops.d2_network import D2NetworkEngine as JaxEngine
    from test_torch_d2_network import _clouds

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWARM_TPU_D2_TILE", "128")
        db = _clouds(90 + d, 30, 14, 64, d + 1)  # 420 amplicons: 4 tiles
        jeng = JaxEngine(db, d)
        jeng.mesh = _jax_mesh(8)
        return db, jeng, D2NetworkEngine(db, d, CPU)


@pytest.mark.parametrize("k", [2, 3, 8])
def test_d2_sharded_pairs_equal_jax_in_order(k):
    db, jeng, eng = d2_engines(2)
    ja, jb, jtot = jeng.candidate_pairs_sharded(jeng.mesh)
    metrics.reset()
    pa, pb, tot = eng.candidate_pairs_sharded(LocalShards(k, CPU))
    assert tot == jtot == len(pa) > 0
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pb, jb)
    assert metrics.last_run["d2_shards.count"] == k


def test_shard_count_holds_over_two_runs_in_one_record():
    """ENGINE_shards.count is the shards of the engine's last run: set,
    not summed, where an engine runs twice in one record."""
    _, _, eng = d2_engines(2)
    metrics.reset()
    for k in (3, 2):
        eng.candidate_pairs_sharded(LocalShards(k, CPU))
    assert metrics.last_run["d2_shards.count"] == 2


@pytest.mark.parametrize("k", [3])
def test_d2_sharded_adjacency_equals_jax(monkeypatch, k):
    db, jeng, _ = d2_engines(3)
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "128")
    monkeypatch.setenv("SWARM_TPU_D2_CHUNK", "2")
    eng = D2NetworkEngine(db, 3, CPU, shards=LocalShards(k, CPU))
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "device")
    got = eng.build_adjacency(4, 12, 4, False)
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "native")
    want = jeng.build_adjacency(4, 12, 4, False)
    assert len(got) == len(want) == 6 and len(want[2]) > 0
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


# ---- the route -----------------------------------------------------------

@pytest.mark.parametrize("k,bits", [(1, 0), (4, 0), (3, 2), (4, 2), (3, 9),
                                    (7, 17)])
def test_bucket_ranges_cover_every_bucket_once(k, bits):
    ranges = [mesh.bucket_range(j, k, bits) for j in range(k)]
    assert ranges[0][0] == 0 and ranges[-1][1] == 1 << bits
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi == lo
    assert all(lo <= hi for lo, hi in ranges)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_route_sends_each_bucket_to_its_owner(k):
    rng = np.random.default_rng(k)
    bits = 4
    shards = LocalShards(k, CPU)
    sends = []
    for j in range(k):
        keys = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=300 + j,
                                             dtype=np.int64))
        keys[:40] = 12345  # a repeated key: every copy on one shard
        owners = torch.arange(keys.numel(), dtype=torch.int32)
        keys, owners, ends = sj.partition(keys, owners, bits)
        sizes = mesh.route_sizes(ends, k, bits)
        assert sum(sizes) == keys.numel()
        sends.append(((keys, owners), sizes))
    received, got = shards.exchange(sends)
    n_keys = 0
    for j, ((keys, owners), sizes) in enumerate(zip(received, got)):
        lo, hi = mesh.bucket_range(j, k, bits)
        b = sj.bucket_of(keys, bits)
        assert bool(((b >= lo) & (b < hi)).all())
        assert sizes == [s[j] for _, s in sends]
        n_keys += keys.numel()
        if lo <= int(sj.bucket_of(torch.tensor([12345]), bits)) < hi:
            assert int((keys == 12345).sum()) == 40 * k
    assert n_keys == sum(t[0].numel() for t, _ in sends)


def test_receiver_joins_only_its_own_buckets():
    """A receiver's join: its keys, partitioned at B bits, leave every
    bucket outside its own range empty, and the join over all bucket
    ends gives exactly the pairs of the keys it owns."""
    rng = np.random.default_rng(5)
    bits, lo, hi = 4, 5, 11
    keys = torch.from_numpy(rng.integers(0, 60, size=2000, dtype=np.int64))
    owners = torch.from_numpy(rng.integers(0, 300, size=2000,
                                           dtype=np.int64)).to(torch.int32)
    b = sj.bucket_of(keys, bits)
    mine = (b >= lo) & (b < hi)
    want = torch.sort(sj.join_pairs_reference(keys[mine],
                                              owners[mine])).values
    keys, owners, ends = sj.partition(keys[mine].clone(),
                                      owners[mine].clone(), bits)
    assert not bool(ends[:lo].any())
    assert bool((ends[hi - 1:] == keys.numel()).all())
    got = sj.join_pairs(keys, owners, ends)
    assert got.numel() > 0 and torch.equal(torch.sort(got).values, want)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_key_split_is_contiguous_and_balanced(k):
    counts = torch.tensor([0, 5, 0, 7, 3, 9, 1, 0, 40, 2], dtype=torch.int64)
    ends = torch.cumsum(counts, 0)
    rows, keys = mesh.key_split(ends, k)
    assert rows[0] == 0 and rows[-1] == counts.numel()
    assert all(a <= b for a, b in zip(rows, rows[1:]))
    for j in range(k):
        assert keys[j] == int(counts[:rows[j]].sum())
    assert keys[-1] == int(counts.sum())
    # a share ends at the first row that reaches its target
    for j in range(1, k):
        assert keys[j] <= j * keys[-1] // k < keys[j] + max(
            int(counts[rows[j]]) if rows[j] < counts.numel() else 0, 1)
    assert mesh.key_split(torch.zeros(0, dtype=torch.int64), 3) == (
        [0, 0, 0, 0], [0, 0, 0, 0])


# ---- ranks ----------------------------------------------------------------

@pytest.mark.parametrize("ranks,rows", [(2, 240), (3, 2)])
def test_gloo_ranks_equal_one_process(ranks, rows):
    """Processes over a gloo group (free port, 120 s): each rank's d=1
    edges (DistributedJoin's), graft and d>=2 pairs equal the
    one-process engines'; with 2 rows over 3 ranks, ranks send and
    receive nothing and still enter every collective."""
    outs = dryrun.dryrun_multiprocess(ranks, timeout=120, rows=rows)
    assert [o["rank"] for o in outs] == list(range(ranks))
    assert len(outs[0]["edges"][0]) > 0 and outs[0]["graft"][0] > 0


def test_dryrun_multichip():
    dryrun.dryrun_multichip(3, "cpu")


# ---- the selection ---------------------------------------------------------

def test_shards_from_the_environment(monkeypatch):
    assert not parallel.requested() and parallel.shards_for(CPU) is None
    monkeypatch.setenv("SWARM_TORCH_SHARDS", "3")
    assert parallel.requested()
    shards = parallel.shards_for(CPU)
    assert shards.count == 3 and shards.devices == [CPU] * 3
    for bad in ("0", "-1", "two"):
        monkeypatch.setenv("SWARM_TORCH_SHARDS", bad)
        with pytest.raises(ValueError):
            parallel.shards_for(CPU)
    monkeypatch.setenv("SWARM_TORCH_SHARDS", "2")
    monkeypatch.setenv("SWARM_TPU_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="not both"):
        parallel.shards_for(CPU)
    monkeypatch.delenv("SWARM_TORCH_SHARDS")
    assert parallel.requested()
    with pytest.raises(RuntimeError, match="no process group"):
        parallel.shards_for(CPU)


def test_shards_lift_the_native_threshold(monkeypatch):
    from swarm_tpu_torch.models.d1 import _device_graft
    from swarm_tpu_torch.ops.neighbors import NeighborIndex

    db = d1_db("planted")
    index = NeighborIndex(db, device=CPU)
    assert index.uses_native() and not _device_graft(CPU, 10)
    monkeypatch.setenv("SWARM_TORCH_SHARDS", "2")
    assert not index.uses_native() and _device_graft(CPU, 10)
    assert isinstance(index._device_engine(), SortJoinShardedEngine)


def _run(tmp_path, argv, name):
    from swarm_tpu_torch.main import run

    work = tmp_path / name
    work.mkdir()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        assert run(argv + ["-l", "log.txt", str(tmp_path / "in.fasta")],
                   "swarm", device="cpu") == 0
    finally:
        os.chdir(cwd)
    return {p.name: p.read_bytes() for p in work.iterdir()}


@pytest.mark.parametrize("flags,env", [
    (["-d", "1", "-f"], {}),
    (["-d", "2"], {"SWARM_TPU_D2_ENGINE": "network",
                   "SWARM_TPU_D2_TILE": "128"})], ids=["d1f", "d2"])
def test_run_takes_the_sharded_engines(tmp_path, monkeypatch, flags, env):
    from cli_parity import graft_fasta

    (tmp_path / "in.fasta").write_text(graft_fasta())
    argv = flags + ["-o", "out.txt", "-s", "stats.txt", "-i", "struct.txt"]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    want = _run(tmp_path, argv, "one")
    monkeypatch.setenv("SWARM_TORCH_SHARDS", "2")
    got = _run(tmp_path, argv, "shards")
    assert got == want and len(want) == 4
    ran = {k: v for k, v in metrics.last_run.items()
           if k.endswith("_shards.count")}
    assert ran == ({"d1_shards.count": 2, "graft_shards.count": 2}
                   if "-f" in flags else {"d2_shards.count": 2})


def test_a_failing_shard_raises(tmp_path, monkeypatch):
    """No fallback: the sharded engine's failure ends the run."""
    from swarm_tpu_torch.main import run

    (tmp_path / "in.fasta").write_text(
        amplicon_cloud(seed=71, n_centers=3, cloud_size=8, length=50))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SWARM_TORCH_SHARDS", "2")

    def fail(self, sends):
        raise RuntimeError("exchange failed")

    monkeypatch.setattr(LocalShards, "exchange", fail)
    with pytest.raises(RuntimeError, match="exchange failed"):
        run(["-d", "1", "-o", "out.txt", "in.fasta"], "swarm", device="cpu")
