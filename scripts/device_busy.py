#!/usr/bin/env python3
"""Device busy share of one warm swarm_tpu_torch run.

    python3 scripts/device_busy.py TRACEDIR [swarm options] FASTAFILE

Runs the port twice in this process: a warm-up run, then a run traced
by torch.profiler (SWARM_TPU_PROFILE_DIR=TRACEDIR, which writes
TRACEDIR/trace.json). Output files land in the working directory, as
with bin/swarm-torch. Prints one JSON line: the trace span, the union of
the device's kernel, memcpy and memset intervals, their share of the
span, and the kernels that took the most device time.
"""

import json
import os
import sys
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_share(trace, top=8):
    """Span, device-busy union and top kernels of a chrome trace."""
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    busy = 0.0
    cur = None  # [start, end] of the interval being merged
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in DEVICE_CATS):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    kernels = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]][0] += e["dur"]
            kernels[e["name"]][1] += 1
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {  # trace times are in microseconds
        "span_s": span / 1e6,
        "device_busy_s": busy / 1e6,
        "busy_share": busy / span if span else 0.0,
        "top_kernels": [{"name": name[:80], "ms": us / 1e3, "launches": k}
                        for name, (us, k) in ranked],
    }


def main(argv):
    if len(argv) < 2:
        sys.stderr.write(__doc__)
        return 2
    trace_dir = Path(argv[0]).resolve()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from swarm_tpu_torch.main import run

    os.environ.pop("SWARM_TPU_PROFILE_DIR", None)
    if run(argv[1:], "swarm"):
        return 1
    os.environ["SWARM_TPU_PROFILE_DIR"] = str(trace_dir)
    if run(argv[1:], "swarm"):
        return 1
    with open(trace_dir / "trace.json") as fh:
        print(json.dumps(busy_share(json.load(fh))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
