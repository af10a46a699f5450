#!/usr/bin/env python3
"""Benchmark of swarm_tpu_torch: one run of one cell.

    python3 swarmbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout, on a machine with the CUDA card(s) the
cell asks for. Prints one JSON object as the last line of standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`
(and with --trace 1 `breakdown`), and last `check`: each number compared
with its limit, which also end standard error. Without a CUDA card, with
fewer cards than the cell asks for, without the program
(swarm_tpu_torch), or with JAX or the JAX package loaded once the window
has closed, it exits non-zero and prints no result.

The program's dispatch is its default: the run clears every
SWARM_TPU_* and SWARM_TORCH_* variable of its environment; the traced
run sets SWARM_TPU_TRACE alone. The kernel and native libraries build
inside the checkout (swarm_tpu_torch/_cuda_build, _native_build), on the
first run of a checkout.
"""

import argparse
import json
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from swarmbench import harness

    harness.clear_program_env()

    _, cell, _, _ = harness.find_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("swarmbench: no CUDA card\n")
        return 2
    chips = int(cell.get("chips", 1))
    if torch.cuda.device_count() < chips:
        sys.stderr.write(f"swarmbench: the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} present\n")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              args.trace, "cuda", root)
    for name, row in result["check"].items():
        sys.stderr.write(f"check {name}: {row['value']} (limit "
                         f"{row['limit']})\n")
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
