"""Sharded engines: the d=1 network, -f's graft and the d>=2 screen
split over shards.

Counterpart of swarm_tpu/parallel (its jax.sharding mesh engines and
jax.distributed wiring). A shard is one device's share of an engine's
work; between phases an exchange moves tensors between shards. Two
forms, chosen from the environment at each run:

- in-process shards, SWARM_TORCH_SHARDS=k: k shards in one process,
  shard i on cuda:(i % device_count), or all on the CPU when the run
  asks for the CPU; the exchange copies slices between devices
  (mesh.LocalShards);
- ranks, SWARM_TPU_COORDINATOR / SWARM_TPU_NUM_PROCESSES /
  SWARM_TPU_PROCESS_ID (swarm_tpu's contract): one shard a process on
  cuda:(rank % device_count), over a torch.distributed group (NCCL on
  the card, gloo on the CPU) that main.run initialises
  (distributed.RankShards).

With neither set, requested() is False and the single-device engines
run as they always did. Submodules are imported when used.
"""

import os


def requested() -> bool:
    """Whether the run asks for shards (either form)."""
    from .distributed import env_config

    return bool(os.environ.get("SWARM_TORCH_SHARDS")) or \
        env_config() is not None


def shards_for(device):
    """The shards the environment asks for, the run's device being
    `device`; None when it asks for none. Raises when both forms are
    set, on a shard count below 1, and under the rank variables before
    distributed.maybe_initialize ran."""
    from . import distributed

    count = os.environ.get("SWARM_TORCH_SHARDS")
    cfg = distributed.env_config()
    if not count and cfg is None:
        return None
    if count and cfg is not None:
        raise ValueError("set SWARM_TORCH_SHARDS or the rank variables "
                         "(SWARM_TPU_COORDINATOR ...), not both")
    if cfg is not None:
        return distributed.RankShards(device)
    from .mesh import LocalShards

    if not count.isdigit() or int(count) < 1:
        raise ValueError(f"SWARM_TORCH_SHARDS={count!r}: a shard count "
                         "of 1 or more")
    return LocalShards(int(count), device)
