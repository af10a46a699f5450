#!/usr/bin/env python3
"""Where the sharded d=1 engine deduplicates its gathered pairs: the
host (numpy) against the card (torch), on d1_1m's shape.

    python3 scripts/dedup_probe.py [--pairs 484017] [--shards 4] [--reps 3]

The verified pairs of each shard are sorted and unique within the shard;
the gather concatenates them and a pair found through two keys lies on
two shards, so they are deduplicated once more. Builds that input from a
seed (random 50-bit pairs, each shard's part sorted) on cuda:0 and times,
on the host clock, each shard's copy to the host, numpy's concatenation,
np.unique, and torch.unique of the concatenation on the card with one
copy back. Prints one JSON line with the card's name, numpy's and
torch's versions and the seconds of each repetition. Needs a CUDA device.
"""

import argparse
import json
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=484_017)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dedup_probe: needs a CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261017)
    share = args.pairs // args.shards
    parts = [torch.from_numpy(np.sort(rng.integers(0, 1 << 50, share)))
             .to(dev) for _ in range(args.shards)]
    torch.cuda.synchronize()
    reps = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        host = [p.cpu().numpy() for p in parts]
        t1 = time.perf_counter()
        x = np.concatenate(host)
        t2 = time.perf_counter()
        want = np.unique(x)
        t3 = time.perf_counter()
        got = torch.unique(torch.cat(parts)).cpu().numpy()
        t4 = time.perf_counter()
        if not np.array_equal(got, want):
            raise SystemExit("dedup_probe: the card's unique differs")
        reps.append({"copies_s": t1 - t0, "concatenate_s": t2 - t1,
                     "np_unique_s": t3 - t2, "torch_unique_and_copy_s": t4 - t3})
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "numpy": np.__version__, "torch": torch.__version__,
                      "pairs": share * args.shards, "reps": reps}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
