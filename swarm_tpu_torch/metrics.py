"""Run metrics: pairwise-comparison counters (the BASELINE.md
north-star denominators), filled in by the engines on each run.

A "comparison" is one candidate pair examined:
 - d=1: candidate pairs produced by the sort-join (key matches checked
   by the windowed dist-1 verifier) plus graft-join candidates;
 - d>=2: qgram screen evaluations (gen-1 pool scan + subseed scans)
   plus exact alignments.
"""

last_run = {}


def reset() -> None:
    last_run.clear()


def record(**kv) -> None:
    for k, v in kv.items():
        last_run[k] = last_run.get(k, 0) + int(v)


def total_comparisons() -> int:
    return sum(v for k, v in last_run.items() if k.endswith("_comparisons"))
