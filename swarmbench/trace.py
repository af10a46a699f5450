"""Reduction of a torch.profiler chrome trace of the measured window.

The traced window is the union of the program's runs in it, each marked
by the harness's annotation ``swarmbench.run`` (what the harness does
between two runs, writing the next input, is no part of it). The device
is busy where a kernel, a copy or a memset runs: the union of those
intervals inside the runs (the arithmetic of the port's
scripts/device_busy.py, copied here). An idle gap is a stretch of a run
outside that union; each piece of it takes the name of the innermost
host span around it: a phase span of the program, or a span of the
harness.
"""

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUN = "swarmbench.run"


def load(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def runs_of(events):
    """[(start, end)] in trace microseconds of the harness's runs."""
    spans = sorted((s, t) for name, s, t in annotations(events)
                   if name == RUN)
    if not spans:
        raise ValueError(f"the trace holds no {RUN} annotation")
    return spans


def annotations(events):
    """[(name, start, end)] of the harness's record_function spans."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("swarmbench.")]


def device_intervals(events, spans):
    """[(name, start, end)] of device operations, clipped to the spans."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        for lo, hi in spans:
            a, b = max(s, lo), min(t, hi)
            if b > a:
                out.append((e["name"], a, b))
    return out


def span_seconds(spans):
    return sum(hi - lo for lo, hi in spans) / 1e6


def union(intervals):
    """Merged [(start, end)] of (name, start, end) intervals."""
    merged = []
    for _, s, t in sorted(intervals, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def busy_seconds(merged):
    return sum(t - s for s, t in merged) / 1e6


def by_name(intervals):
    """{name: seconds} summed over intervals."""
    total = defaultdict(float)
    for name, s, t in intervals:
        total[name] += (t - s) / 1e6
    return dict(total)


def gaps(merged, spans):
    """[(start, end)] of the spans outside the merged busy intervals."""
    out = []
    for lo, hi in spans:
        at = lo
        for s, t in merged:
            if t <= lo or s >= hi:
                continue
            if s > at:
                out.append((at, s))
            at = max(at, t)
        if hi > at:
            out.append((at, hi))
    return out


def name_gaps(gap_list, spans, outside="run, no span"):
    """{name: seconds} of the gaps, each stretch of a gap given to the
    shortest host span (name, start, end) around it."""
    total = defaultdict(float)
    spans = sorted(spans, key=lambda x: x[1])
    starts = [a for _, a, _ in spans]
    for s, t in gap_list:
        around = [x for x in spans[:bisect.bisect_right(starts, t)]
                  if x[2] > s]
        cuts = sorted({s, t} | {a for _, a, _ in around if s < a < t}
                      | {b for _, _, b in around if s < b < t})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            best = min((x for x in around if x[1] <= mid <= x[2]),
                       key=lambda x: x[2] - x[1], default=None)
            total[best[0] if best else outside] += (b - a) / 1e6
    return dict(total)


def top(table, k=10):
    """The k largest entries of {name: seconds}, as [[name, seconds]]."""
    return [[name, sec] for name, sec in
            sorted(table.items(), key=lambda kv: -kv[1])[:k]]
