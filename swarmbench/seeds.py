#!/usr/bin/env python3
"""Readings of the comparison over many seeds, in one process.

    python3 swarmbench/seeds.py --workload CELL --seeds S1 S2 ... \
        [--program] [--control]

For each seed: the cell's corpus; with --program one run of the program
on it through the harness's timed path (main.run, the edge wrapper), no
window, then the reference and the comparison; with --control the
control (the cell's reference with ``control=True``: for d >= 2 the unit
edit distance in place of swarm's scored alignment) compared in the program's place.
Prints one JSON line a seed with the numbers of each. The benchmark's
own runs never run this: it gives the lower readings (the program) and
the upper ones (the control) from which check.py's limits were set.
"""

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch

    from swarmbench import check, harness

    harness.clear_program_env()
    for seed in args.seeds:
        cell = harness.Cell(args.workload, seed, 0, False, "cuda", root)
        workdir = tempfile.mkdtemp(prefix="swarmbench-seeds-")
        line = {"seed": seed}
        try:
            cell.prepare(workdir)
            if args.program:
                run = cell.one_run(1)
                line["run_s"] = run.seconds
                gc.collect()
                torch.cuda.empty_cache()
                correct, table = cell.check()
                line["program"] = {k: v["value"] for k, v in table.items()}
                line["program_correct"] = correct
                line["reference_s"] = cell.reference_s
            if args.control:
                t0 = time.perf_counter()
                ref = cell.reference.cluster(cell.corpus, cell.config,
                                             "cuda")
                ctl = cell.reference.cluster(cell.corpus, cell.config,
                                             "cuda", control=True)
                fake = harness.Run(edges=ctl.edges, streams={
                    k: bytes(v.cpu().numpy()) for k, v in ctl.streams.items()})
                numbers = check.compare(ref, [fake], cell.corpus.n)
                line["control"] = numbers
                line["control_correct"] = check.verdict(numbers)[0]
                line["control_s"] = time.perf_counter() - t0
        finally:
            if hasattr(cell, "capture"):
                cell.capture.uninstall()
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
