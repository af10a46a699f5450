"""Ranks: the sharded engines across processes (torch.distributed).

Counterpart of swarm_tpu/parallel/distributed.py. The environment is
swarm_tpu's contract: SWARM_TPU_COORDINATOR (host:port of rank 0),
SWARM_TPU_NUM_PROCESSES and SWARM_TPU_PROCESS_ID.

- env_config(): that triple, or None;
- maybe_initialize(device): joins the process group (NCCL for a CUDA
  device, gloo for the CPU; tcp://COORDINATOR, a timeout of TIMEOUT, so
  that a rank that fails ends the others' collectives instead of
  leaving them hung) and returns the rank, 0 without the variables;
- is_primary(): whether this process writes the outputs (rank 0);
- finalize(): destroys the group that maybe_initialize made;
- RankShards: one shard a rank, on cuda:(rank % device_count) or the
  CPU; the exchange is all_to_all_single, its split sizes exchanged
  first (one readback), results gather by all_gather and all_reduce;
- DistributedJoin(db): the d=1 sort-join engine over the group.

Every rank runs the same argv on the same input (the shared-filesystem
contract of swarm_tpu), so every rank reaches every collective on the
same code path and ends with the same network; only rank 0 writes
(main.run sends the other ranks' outputs and log to os.devnull).
"""

import datetime
import os

import numpy as np
import torch

from .mesh import Shards

#: how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=600)

_OWN_GROUP = False  # whether maybe_initialize made the group


def env_config():
    """(coordinator, num_processes, process_id) from the environment,
    or None when SWARM_TPU_COORDINATOR is unset."""
    coord = os.environ.get("SWARM_TPU_COORDINATOR")
    if not coord:
        return None
    return (coord, int(os.environ.get("SWARM_TPU_NUM_PROCESSES", "1")),
            int(os.environ.get("SWARM_TPU_PROCESS_ID", "0")))


def rank_device(device, rank: int) -> torch.device:
    """The device of `rank` for a run on `device`: cuda:(rank %
    device_count) for a CUDA device, else `device` itself."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def maybe_initialize(device=None) -> int:
    """Join the process group when the rank variables are set; returns
    this process' rank (0 without them). `device` (default cuda:0)
    picks the backend: NCCL for a CUDA device, gloo for the CPU."""
    global _OWN_GROUP
    cfg = env_config()
    if cfg is None:
        return 0
    import torch.distributed as dist

    coord, nproc, pid = cfg
    if not dist.is_initialized():
        device = torch.device("cuda", 0) if device is None \
            else torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(rank_device(device, pid))
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{coord}", world_size=nproc, rank=pid,
            timeout=TIMEOUT)
        _OWN_GROUP = True
    if dist.get_rank() != pid or dist.get_world_size() != nproc:
        raise RuntimeError("the process group is not the one the rank "
                           "variables describe")
    return pid


def is_primary() -> bool:
    """True on the process that owns the outputs (rank 0, or the only
    process)."""
    cfg = env_config()
    return cfg is None or cfg[2] == 0


def finalize() -> None:
    """Destroy the process group that maybe_initialize made."""
    global _OWN_GROUP
    if _OWN_GROUP:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        _OWN_GROUP = False


class RankShards(Shards):
    """This rank's one shard of a torch.distributed group (initialised
    by maybe_initialize), on rank_device(device, rank)."""

    def __init__(self, device):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("the rank variables are set but no process "
                               "group is initialised "
                               "(parallel.distributed.maybe_initialize)")
        self._dist = dist
        rank = dist.get_rank()
        self.count = dist.get_world_size()
        self.owned = [rank]
        self.devices = [rank_device(device, rank)]

    def exchange(self, sends):
        dist = self._dist
        (tensors, sizes), = sends
        dev = self.devices[0]
        send = torch.tensor(list(sizes), dtype=torch.int64, device=dev)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        got = recv.tolist()  # NCCL takes the split sizes as lists
        out = []
        for t in tensors:
            r = torch.empty(sum(got), dtype=t.dtype, device=dev)
            dist.all_to_all_single(r, t.contiguous(), got, list(sizes))
            out.append(r)
        return [tuple(out)], [got]

    def gather(self, tensors):
        dist = self._dist
        t, = tensors
        dev = self.devices[0]
        size = torch.tensor([t.numel()], dtype=torch.int64, device=dev)
        sizes = [torch.empty_like(size) for _ in range(self.count)]
        dist.all_gather(sizes, size)
        sizes = torch.cat(sizes).tolist()
        pad = torch.zeros(max(1, *sizes), dtype=t.dtype, device=dev)
        pad[:t.numel()] = t
        parts = [torch.empty_like(pad) for _ in range(self.count)]
        dist.all_gather(parts, pad)
        return torch.cat([p[:s] for p, s in zip(parts, sizes)])

    def reduce(self, tensors, op: str):
        dist = self._dist
        t, = tensors
        t = t.clone()
        dist.all_reduce(t, {"min": dist.ReduceOp.MIN,
                            "sum": dist.ReduceOp.SUM}[op])
        return t.cpu()


class DistributedJoin:
    """The d=1 sort-join engine across the ranks of the process group.
    Every rank calls build_network with the same database and gets the
    same edges."""

    def __init__(self, db, device=None):
        from .mesh import SortJoinShardedEngine

        device = torch.device("cuda", 0) if device is None \
            else torch.device(device)
        self._engine = SortJoinShardedEngine(db, RankShards(device))

    def build_network(self, no_break: bool, abundances: np.ndarray):
        return self._engine.build_network(no_break, abundances)
