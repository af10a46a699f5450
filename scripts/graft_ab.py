#!/usr/bin/env python3
"""The graft phase of one checkout's own chip_smoke.py, so that two
checkouts' graft kernels can be compared in one call:

    python3 scripts/graft_ab.py --work DIR [--tree CHECKOUT] [--edges]

imports the chip_smoke.py and swarm_tpu_torch of CHECKOUT (default: this
one), makes the two fastidious corpora in DIR, and runs that script's
timed graft phase on them (phase_graft_kernels without the edge cases,
then graft_join_skewed; with --edges first graft_edges, the edge sides
checked and the verify timed alone on each): every time is
chip_smoke.py's own, read by the checkout's own code. Prints the
phase's lines and one JSON line {"ab": {card, tree, verify, kernels}},
`verify` holding graft_verify's times a cell: alone (behind the busy
kernel), as the wrapper's call reads without it, and the launch floor.
Run two checkouts in turns inside one call (A, B, B, A): a `git
archive` of the other commit unpacked into a git-ignored directory,
such as _dev/.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CELLS = ("d1_fastidious_200k", "d1_fastidious_asym_200k")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", type=Path, required=True)
    ap.add_argument("--tree", type=Path, default=REPO)
    ap.add_argument("--edges", action="store_true",
                    help="also chip_smoke.py's graft_edges")
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
    _build.load()
    dev = torch.device("cuda", 0)
    work = args.work.resolve() / tree.name
    work.mkdir(parents=True, exist_ok=True)
    edge_sides = cs.graft_edges(dev)[1] if args.edges else {}
    rows = cs.phase_graft_kernels(dev, cs.make_corpora(work, CELLS), work,
                                  edges=False)
    rows["graft_join"]["skewed_buckets"] = cs.graft_join_skewed(dev)
    verify = {cell: {k: row[k] for k in ("ms", "wrapper_ms",
                                         "launch_floor_ms", "pairs")}
              for cell, row in ((CELLS[0], rows["graft_verify"]),
                                (CELLS[1], rows["graft_verify"][CELLS[1]]))}
    verify["edge_sides_ms"] = edge_sides
    print(json.dumps({"ab": {"card": card, "tree": str(tree),
                             "verify": verify, "kernels": rows}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
