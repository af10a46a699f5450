#!/usr/bin/env python3
"""One timed kernel phase of one checkout's own chip_smoke.py, so that
two checkouts' kernels can be compared in one call:

    python3 scripts/phase_ab.py --phase graft|screen|csr --work DIR
        [--tree CHECKOUT] [--edges] [--paths]

imports the chip_smoke.py and swarm_tpu_torch of CHECKOUT (default: this
one), makes the phase's corpora in DIR/corpora once (later runs, of any
checkout, reuse them) and runs that script's timed phase on them: every
time is chip_smoke.py's own, read by the checkout's own code.

- graft: phase_graft_kernels without the edge cases on the two
  fastidious corpora, then graft_join_skewed; with --edges first
  graft_edges (the edge sides checked, the verify timed alone on each).
- screen: phase_d2_screen without the edge cases (with --edges, with
  them) on the d2_100k, d2_long and d1_1m corpora; with --paths also
  the d2_100k and d2_long main paths (warm-up, timed and native-engine
  runs) and the d2_100k graph replay alone: its candidates built once
  by the checkout's network engine (their digest printed, so that two
  checkouts' inputs can be seen to agree), then algo_cluster_graph
  timed REPLAYS times on them.
- csr: phase_d2_csr (the network engine's CSR partition at the
  benchmark cells' edge counts; with --edges first on CSR_CASES); no
  corpora. Then readbacks: the CSR at d2_150nt_500k's edge count read
  back into int64 host arrays three ways, each from an empty pinned
  cache: the engine's (d2_network.csr_to_host: pageable, 5 bytes an
  edge, widened on the host), the same through pinned buffers from
  torch's cache, and widened on the card into pinned int64 buffers that
  the arrays stay views of; the first call's time (what a fresh process
  pays), the median of three more, and the pinned bytes torch's cache
  holds while the arrays live and after they are dropped.

Prints the phase's lines and one JSON line {"ab": {card, tree, phase,
kernels, ...}}. Run two checkouts in turns inside one call (A, B, B,
A): a `git archive` of the other commit unpacked into a git-ignored
directory, such as _dev/.
"""

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CELLS = {"graft": ("d1_fastidious_200k", "d1_fastidious_asym_200k"),
         "screen": ("d2_100k", "d2_long", "d1_1m"), "csr": ()}
PATHS = ("d2_100k", "d2_long")
REPLAYS = 2


def shared_corpora(cs, shared, names):
    """name -> FASTA file in `shared`, made by chip_smoke's MAIN_PATHS
    maker where it is not there yet."""
    from swarm_tpu_torch import corpora

    shared.mkdir(parents=True, exist_ok=True)
    out = {}
    for name in names:
        out[name] = shared / f"{name}.fasta"
        if not out[name].exists():
            maker, kwargs = cs.MAIN_PATHS[name][:2]
            tmp = out[name].with_suffix(".tmp")
            getattr(corpora, maker)(tmp, **kwargs)
            tmp.rename(out[name])
    return out


def graft(cs, dev, corpus, work, edges):
    edge_sides = cs.graft_edges(dev)[1] if edges else {}
    rows = cs.phase_graft_kernels(dev, corpus, work, edges=False)
    rows["graft_join"]["skewed_buckets"] = cs.graft_join_skewed(dev)
    cells = CELLS["graft"]
    verify = {cell: {k: row[k] for k in ("ms", "wrapper_ms",
                                         "launch_floor_ms", "pairs")}
              for cell, row in ((cells[0], rows["graft_verify"]),
                                (cells[1], rows["graft_verify"][cells[1]]))}
    verify["edge_sides_ms"] = edge_sides
    return {"kernels": rows, "verify": verify}


def graph_replay(dev, fasta):
    """algo_cluster_graph alone on the d2_100k candidates of this
    checkout's network engine: their digest and REPLAYS host-clock
    seconds."""
    from swarm_tpu_torch import _native
    from swarm_tpu_torch.corpora import read_db
    from swarm_tpu_torch.ops.d2_network import D2NetworkEngine
    from swarm_tpu_torch.params import Parameters

    db = read_db(fasta)
    p = Parameters()
    adj = D2NetworkEngine(db, 2, dev).build_adjacency(
        p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend, False)
    h = hashlib.blake2b(digest_size=16)
    for a in adj[:4]:
        h.update(a.tobytes())
    seconds = []
    for _ in range(REPLAYS):
        t0 = time.perf_counter()
        _native.algo_cluster_graph(*adj[:4], db.abundances, True)
        seconds.append(time.perf_counter() - t0)
    print(f"graph replay d2_100k: candidates {h.hexdigest()} "
          f"algo_cluster_graph_s={seconds}", flush=True)
    return {"candidates_digest": h.hexdigest(), "seconds": seconds}


def readbacks(cs, dev, reps=3):
    """The CSR readback comparison of the csr phase (module docstring)."""
    import numpy as np
    import torch

    from swarm_tpu_torch.corpora import screen_order_tasks
    from swarm_tpu_torch.ops import d2_network as d2n

    empty_host = getattr(getattr(torch, "accelerator", None),
                         "empty_host_cache", None) or \
        getattr(torch._C, "_host_emptyCache", None)

    def pinned_bytes():
        stats = torch.cuda.host_memory_stats() if hasattr(
            torch.cuda, "host_memory_stats") else {}
        return stats.get("allocated_bytes.current")

    def engine(arrays):
        return d2n.csr_to_host(*arrays)

    def pinned_narrow(arrays):
        out = []
        for t in arrays:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            out.append(buf.to(torch.int64).numpy())
        return out

    def pinned_wide(arrays):
        out = []
        for t in arrays:
            buf = torch.empty(t.shape, dtype=torch.int64, pin_memory=True)
            buf.copy_(t.long())
            out.append(buf.numpy())
        return out

    n, cloud = cs.CSR_TIMED["d2_150nt_500k"]
    tasks = screen_order_tasks(n, cloud, 22)
    got = d2n.csr_partition(*(torch.from_numpy(x).to(dev) for x in tasks),
                            n)
    arrays = got[:3]
    out = {"edges": got[1].numel(), "host_cache_emptied": bool(empty_host)}
    for fn in (engine, pinned_narrow, pinned_wide):
        if empty_host:
            empty_host()
        times, held = [], None
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kept = fn(arrays)
            times.append((time.perf_counter() - t0) * 1e3)
            held = pinned_bytes()
            del kept
        out[fn.__name__] = {"first_ms": times[0],
                            "median_ms": float(np.median(times[1:])),
                            "pinned_bytes_live": held,
                            "pinned_bytes_after": pinned_bytes()}
        print(f"readback {fn.__name__}: {json.dumps(out[fn.__name__])}",
              flush=True)
    return out


def screen(cs, dev, corpus, work, edges, paths):
    out = {"kernels": cs.phase_d2_screen(dev, corpus, work, edges=edges)}
    if paths:
        out["main_paths"] = {name: cs.run_main_path(name, corpus, work)
                             for name in PATHS}
        out["graph_replay"] = graph_replay(dev, corpus["d2_100k"])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=sorted(CELLS), required=True)
    ap.add_argument("--work", type=Path, required=True)
    ap.add_argument("--tree", type=Path, default=REPO)
    ap.add_argument("--edges", action="store_true",
                    help="also the phase's edge cases")
    ap.add_argument("--paths", action="store_true",
                    help="screen: also the d2_100k and d2_long main paths "
                         "and the graph replay alone")
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("FAIL no CUDA device", flush=True)
        return 1
    import chip_smoke as cs
    from swarm_tpu_torch import _build

    if Path(cs.__file__).resolve().parent != tree or \
            not Path(_build.__file__).resolve().is_relative_to(tree):
        print(f"FAIL chip_smoke.py or swarm_tpu_torch is not {tree}'s",
              flush=True)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log = _build.build(verbose=True)
    if hasattr(cs, "BUILD_LOG"):  # its ptxas report of the kernels
        cs.BUILD_LOG = log
    _build.load()
    dev = torch.device("cuda", 0)
    corpus = shared_corpora(cs, args.work.resolve() / "corpora",
                            CELLS[args.phase])
    work = Path(tempfile.mkdtemp(prefix=f"{tree.name}_",
                                 dir=args.work.resolve()))
    if args.phase == "graft":
        result = graft(cs, dev, corpus, work, args.edges)
    elif args.phase == "csr":
        result = {"kernels": cs.phase_d2_csr(dev, args.edges),
                  "readbacks": readbacks(cs, dev)}
    else:
        result = screen(cs, dev, corpus, work, args.edges, args.paths)
    print(json.dumps({"ab": {"card": card, "tree": str(tree),
                             "phase": args.phase, **result}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
