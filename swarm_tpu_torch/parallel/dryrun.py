"""Dry run of the sharded engines: in-process shards and gloo ranks.

Counterpart of swarm_tpu's dryrun_multichip and dryrun_multiprocess
(__graft_entry__.py), over the port's sort-join engine (swarm_tpu's
dry run drives its probe join, which the port does not have):

    python -m swarm_tpu_torch.parallel.dryrun [--shards K]
        [--device cuda|cpu] [--processes N]

- dryrun_multichip(k, device): on a planted corpus (rows of 20-60 nt,
  each followed by 1-edit neighbours), the d=1 network over k
  in-process shards equals the single-device engine's, the graft over
  them equals GraftEngine's, and the d>=2 pairs over them equal
  candidate_pairs' in order; on cuda:0 unless the CPU is asked for
  (default_device: it raises without CUDA);
- dryrun_multiprocess(n, rows=240): n gloo ranks on the CPU (this
  module run as `--worker RANK N PORT ROWS`; fewer rows than ranks
  leave ranks with nothing to send), each printing its d=1 edges (of
  DistributedJoin), graft and d>=2 pairs as one JSON line; every rank's
  equal the one-process engines'.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

#: the dry run's tile of the d>=2 screen (a multiple of 32)
TILE = 32


def planted_db(n: int = 240, seed: int = 9100):
    """A Db of about n distinct rows of 20-60 nt: random rows, each
    followed by 1-3 neighbours one edit (substitution, deletion or
    insertion) away, with seeded abundances."""
    from ..corpora import _edit, make_db, rows_records

    rng = np.random.default_rng(seed)
    rows, seen = [], set()
    while len(rows) < n:
        base = rng.integers(0, 4, size=int(rng.integers(20, 61)))
        for v in [base] + [_edit(rng, base, 20)
                           for _ in range(int(rng.integers(1, 4)))]:
            if v.tobytes() not in seen:
                seen.add(v.tobytes())
                rows.append(v.astype(np.uint8))
    with tempfile.TemporaryDirectory() as tmp:
        return make_db(tmp, rows_records(rows[:n], seed))


def _sides(n):
    """(heavy, light): the graft's sides, every other amplicon light."""
    return np.arange(0, n, 2, dtype=np.int64), np.arange(1, n, 2,
                                                          dtype=np.int64)


def run_engines(db, device, shards, join=None):
    """{"edges", "graft", "pairs"} of the sharded engines over `shards`
    (None: the single-device engines) on `device`; `join`: the d=1
    engine, if not the one that `shards` gives."""
    import torch

    from ..ops.d2_network import D2NetworkEngine
    from ..ops.fastidious_torch import GraftEngine
    from ..ops.neighbors_sortjoin import SortJoinNeighborEngine
    from .mesh import ShardedGraftEngine, SortJoinShardedEngine

    device = torch.device(device)
    if join is None:
        join = SortJoinNeighborEngine(db, device) if shards is None \
            else SortJoinShardedEngine(db, shards)
    edges = join.build_network(False, db.abundances)
    graft = GraftEngine(db, device) if shards is None \
        else ShardedGraftEngine(db, shards)
    count, cand = graft.graft_candidates(*_sides(len(db)))
    tile = os.environ.get("SWARM_TPU_D2_TILE")
    os.environ["SWARM_TPU_D2_TILE"] = str(TILE)
    try:
        eng = D2NetworkEngine(db, 2, device, shards=shards)
    finally:
        if tile is None:
            del os.environ["SWARM_TPU_D2_TILE"]
        else:
            os.environ["SWARM_TPU_D2_TILE"] = tile
    pa, pb, _ = eng.candidate_pairs() if shards is None else \
        eng.candidate_pairs_sharded(shards)
    return {"edges": [edges[0].tolist(), edges[1].tolist()],
            "graft": [int(count), cand.tolist()],
            "pairs": [pa.tolist(), pb.tolist()]}


def dryrun_multichip(k: int, device=None) -> None:
    """The three sharded engines over k in-process shards on `device`
    (None: default_device(), which raises without CUDA) against the
    single-device engines, on planted_db()."""
    from ..device import default_device
    from .mesh import LocalShards

    device = default_device() if device is None else device
    db = planted_db()
    want = run_engines(db, device, None)
    got = run_engines(db, device, LocalShards(k, device))
    assert len(want["edges"][0]) > 0, "planted neighbours not found"
    assert want["graft"][0] > 0 and len(want["pairs"][0]) > 0
    for name in want:
        assert got[name] == want[name], f"{name} over {k} shards differs"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multiprocess(n_processes: int = 2, timeout: int = 120,
                        rows: int = 240):
    """n gloo ranks on the CPU, each running the three sharded engines
    on planted_db(rows); returns their JSON results after checking that
    every rank's equal the one-process engines'."""
    port = free_port()
    repo = Path(__file__).resolve().parents[2]
    env = {**os.environ, "PYTHONPATH": str(repo)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "swarm_tpu_torch.parallel.dryrun", "--worker",
         str(rank), str(n_processes), str(port), str(rows)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(n_processes)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-2000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = run_engines(planted_db(rows), "cpu", None)
    for out in outs:
        for name in want:
            assert out[name] == want[name], \
                f"rank {out['rank']}: {name} differs from one process"
    return outs


def worker(rank: int, n_processes: int, port: int, rows: int) -> None:
    """One gloo rank of dryrun_multiprocess."""
    os.environ.update({"SWARM_TPU_COORDINATOR": f"127.0.0.1:{port}",
                       "SWARM_TPU_NUM_PROCESSES": str(n_processes),
                       "SWARM_TPU_PROCESS_ID": str(rank)})
    from . import distributed

    if distributed.maybe_initialize("cpu") != rank:
        raise RuntimeError(f"rank {rank} joined as another rank")
    try:
        db = planted_db(rows)
        out = run_engines(db, "cpu", distributed.RankShards("cpu"),
                          distributed.DistributedJoin(db, "cpu"))
    finally:
        distributed.finalize()
    print(json.dumps({"rank": rank, **out}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda:0 unless given (cpu: the CPU)")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--worker", nargs=4, type=int,
                    metavar=("RANK", "N", "PORT", "ROWS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(*args.worker)
        return 0
    from ..device import default_device

    device = default_device() if args.device is None else args.device
    dryrun_multichip(args.shards, device)
    print(f"dryrun_multichip({args.shards}, {device}) ok")
    if args.processes:
        dryrun_multiprocess(args.processes)
        print(f"dryrun_multiprocess({args.processes}) ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
