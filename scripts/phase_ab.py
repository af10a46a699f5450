#!/usr/bin/env python3
"""One timed kernel phase of one checkout's own chip_smoke.py, so that
two checkouts' kernels can be compared in one call:

    python3 scripts/phase_ab.py --phase graft|screen|csr --work DIR
        [--tree CHECKOUT]

imports the chip_smoke.py and swarm_tpu_torch of CHECKOUT (default: this
one), makes the phase's corpora in DIR/corpora once (later runs, of any
checkout, reuse them) and runs that script's timed phase on them: every
time is chip_smoke.py's own, read by the checkout's own code.

- graft: phase_graft_kernels on the two fastidious corpora, skewed
  buckets and random sides.
- screen: phase_d2_screen on the d2_100k, d2_long and d1_1m corpora.
- csr: phase_d2_csr (the network engine's CSR partition at the
  benchmark cells' edge counts); no corpora. Then readbacks: the CSR at
  d2_150nt_500k's edge count read back into int64 host arrays three
  ways, each from an empty pinned cache: the engine's
  (d2_network.csr_to_host: pageable, 5 bytes an edge, widened on the
  host), the same through pinned buffers from torch's cache, and
  widened on the card into pinned int64 buffers that the arrays stay
  views of; the first call's time (what a fresh process pays), the
  median of three more, and the pinned bytes torch's cache holds while
  the arrays live and after they are dropped.

Prints the phase's lines and one JSON line {"ab": {card, tree, phase,
kernels, ...}}. Run two checkouts in turns inside one call (A, B, B,
A): a `git archive` of the other commit unpacked into a git-ignored
directory, such as _dev/. It runs checkouts whose chip_smoke.py
phases take no `edges` argument.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CELLS = {"graft": ("d1_fastidious_200k", "d1_fastidious_asym_200k"),
         "screen": ("d2_100k", "d2_long", "d1_1m"), "csr": ()}


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


def graft(cs, dev, corpus, work):
    rows = cs.phase_graft_kernels(dev, corpus, work)
    cells = CELLS["graft"]
    verify = {cell: {k: row[k] for k in ("ms", "wrapper_ms",
                                         "launch_floor_ms", "pairs")}
              for cell, row in ((cells[0], rows["graft_verify"]),
                                (cells[1], rows["graft_verify"][cells[1]]))}
    return {"kernels": rows, "verify": verify}


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=sorted(CELLS), required=True)
    ap.add_argument("--work", type=Path, required=True)
    ap.add_argument("--tree", type=Path, default=REPO)
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
        result = graft(cs, dev, corpus, work)
    elif args.phase == "csr":
        result = {"kernels": cs.phase_d2_csr(dev),
                  "readbacks": readbacks(cs, dev)}
    else:
        result = {"kernels": cs.phase_d2_screen(dev, corpus)}
    print(json.dumps({"ab": {"card": card, "tree": str(tree),
                             "phase": args.phase, **result}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
