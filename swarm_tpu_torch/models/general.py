"""d>=2 engine choice and the network-engine run.

Counterpart of the engine choice of swarm_tpu/models/general.py
(algo_run). Two engines:

- "network": the torch D2NetworkEngine (qgram screen, exact diffs)
  feeding the native graph replay (swarm_native.c: algo_cluster_graph);
- "native": the all-host C seed/subseed loop (swarm_native.c:
  algo_cluster), as swarm_tpu runs it.

Both runs, and the output writers, are swarm_tpu's. SWARM_TPU_D2_ENGINE=
network|native forces an engine.
"""

import os
import sys
import time

import torch

from swarm_tpu import _native
from swarm_tpu.models import general
from swarm_tpu.ops.search import set_bit_mode
from swarm_tpu.progress import replay_range

ENGINES = ("auto", "network", "native")


def choose_engine(n: int, bit_mode: int, device: torch.device) -> str:
    """The engine for n amplicons: "network" in the 8-bit regime from
    16384 amplicons on a CUDA device, else "native"."""
    engine = os.environ.get("SWARM_TPU_D2_ENGINE", "auto")
    if engine not in ENGINES:
        raise ValueError(
            f"SWARM_TPU_D2_ENGINE={engine!r}: swarm_tpu_torch runs "
            f"{', '.join(ENGINES)}")
    if not _native.available():
        raise RuntimeError("swarm_tpu_torch needs the native host library")
    if engine == "auto":
        engine = "network" if (
            bit_mode == 8 and n >= 16384 and device.type == "cuda"
        ) else "native"
    if engine == "network" and bit_mode != 8:
        # the network formulation needs the pure-pair 8-bit semantics
        # (the 16-bit artifact's diffs depend on the channel schedule)
        engine = "native"
    return engine


def algo_run(p, db, progress, device: torch.device) -> None:
    n = len(db)
    d = p.opt_differences
    bit_mode = set_bit_mode(
        d, p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend)
    engine = choose_engine(n, bit_mode, device)

    progress.init("Find qgram vects: ", n)
    if engine == "network":
        from ..ops.d2_network import D2NetworkEngine

        eng = D2NetworkEngine(db, d, device, threads=p.opt_threads)
    else:
        profiles = _native.qgram_profiles_arena(
            db.codes, db.offsets, db.lengths
        )
    replay_range(progress, n)
    progress.done()
    if engine == "network":
        _algo_run_network(p, db, progress, eng, n, d)
    else:
        general._algo_run_native(
            p, db, progress, None, profiles, bit_mode, n, d)


def _algo_run_network(p, db, progress, eng, n, d):
    """swarm_tpu's network run (device screen and diffs from `eng`,
    native graph replay, shared writers). With SWARM_TPU_TIMING set,
    prints the engine's phases and the host time after them
    (algo_cluster_graph and the writers)."""
    t0 = time.perf_counter()
    general._algo_run_network(p, db, progress, eng, n, d)
    total = time.perf_counter() - t0
    if os.environ.get("SWARM_TPU_TIMING"):
        phases = dict(eng.timings)
        phases["cluster_graph+writers"] = total - sum(eng.timings.values())
        for name, sec in phases.items():
            sys.__stderr__.write(
                f"[timing] d2 network ({eng.device.type}) {name:<22} "
                f"{sec:8.3f}s\n")
