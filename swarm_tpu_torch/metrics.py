"""The run's record: its spans and its counters.

main._run starts a new record (reset) when a run starts, so the record
holds the last run of the process (a resident server's or a benchmark's
runs included), and nothing of a run before it, one that raised too.

Spans are (name, start, end, parent, run) on time.perf_counter, kept
in memory on every run; all spans of one run share its `run_id`. Each
progress phase (progress.Progress) is one, superseded phases ending at
the next phase's start; the engines and writers add theirs with
``span(name)``.
While a torch.profiler is active, each span is also a
torch.profiler.record_function range of the same name, so that the
profiler's trace holds the program's spans on its own clock beside the
kernels and copies they launch.

Counters, summed over the run:
 - comparisons (the BASELINE.md north-star denominators), one candidate
   pair examined:
   - d=1: candidate pairs produced by the sort-join (key matches checked
     by the windowed dist-1 verifier) plus graft-join candidates;
   - d>=2: qgram screen evaluations (gen-1 pool scan + subseed scans)
     plus exact alignments;
 - the d>=2 network engine's ``d2_network.alignments`` (directed exact
   alignments run), ``d2_network.device_tasks`` (those laid out on the
   engine's device, d2_network.d2_tasks; 0 where the native host diffs
   ran), ``d2_network.edges`` (directed edges accepted) and
   ``d2_network.csr_device_edges`` (those partitioned into the CSR on
   the engine's device; 0 where the native host diffs ran);
 - the sharded engines' (parallel/mesh.py) ``ENGINE_shards.exchanges``
   and ``.exchange_bytes`` (what this process received), ENGINE one of
   d1, graft, d2; and ``ENGINE_shards.count``, the shards of the
   engine's last run, which is set, not summed.

dump() writes the record to the file $SWARM_TPU_TRACE names (read when
it writes), in the chrome trace-event format (chrome://tracing,
Perfetto): one "X" event a span, its run id and parent in "args", and
the counters under a top-level "counters" key.
"""

import contextlib
import json
import os
import sys
import time

#: the run's counters
last_run = {}
#: the run's spans, in the order they began
spans = []
#: shared by the spans of one run; reset() moves it on
run_id = 0
_open = []


class Span:
    __slots__ = ("name", "start", "end", "parent", "run", "range")

    def __init__(self, name, parent):
        self.name = name
        self.parent = parent
        self.run = run_id
        self.end = None
        self.range = None
        self.start = time.perf_counter()


def reset() -> None:
    global run_id
    last_run.clear()
    spans.clear()
    _open.clear()
    run_id += 1


def record(**kv) -> None:
    for k, v in kv.items():
        last_run[k] = last_run.get(k, 0) + int(v)


def total_comparisons() -> int:
    return sum(v for k, v in last_run.items() if k.endswith("_comparisons"))


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd.profiler._is_profiler_enabled


def begin(name: str) -> Span:
    """Open a span named `name`, its parent the innermost open span."""
    s = Span(name, _open[-1].name if _open else None)
    if _profiling():
        import torch

        s.range = torch.profiler.record_function(name)
        s.range.__enter__()
    spans.append(s)
    _open.append(s)
    return s


def end(s: Span) -> None:
    """Close span `s` (a span of an earlier run is left as it is)."""
    if s.range is not None:
        s.range.__exit__(None, None, None)
        s.range = None
    if s in _open:
        s.end = time.perf_counter()
        _open.remove(s)


@contextlib.contextmanager
def span(name: str):
    s = begin(name)
    try:
        yield s
    finally:
        end(s)


def seconds(*names: str) -> float:
    """Seconds of the run's closed spans named one of `names`."""
    return sum(s.end - s.start for s in spans
               if s.name in names and s.end is not None)


def step_seconds(prefix: str, steps) -> dict:
    """{step: seconds of the run's closed spans PREFIX.STEP} for each of
    `steps` that has one."""
    closed = {s.name for s in spans if s.end is not None}
    return {step: seconds(f"{prefix}.{step}") for step in steps
            if f"{prefix}.{step}" in closed}


def timing(label: str, phases: dict) -> None:
    """With SWARM_TPU_TIMING set, a `[timing] LABEL NAME SECONDS` line for
    each of `phases` ({name: seconds})."""
    if os.environ.get("SWARM_TPU_TIMING"):
        for name, sec in phases.items():
            sys.__stderr__.write(
                f"[timing] {label} {name:<22} {sec:8.3f}s\n")


def dump() -> None:
    """Write the run's record to $SWARM_TPU_TRACE, where it is set."""
    path = os.environ.get("SWARM_TPU_TRACE")
    if not path:
        return
    pid = os.getpid()
    events = [
        {
            "name": s.name,
            "ph": "X",
            "ts": int(s.start * 1e6),
            "dur": int((s.end - s.start) * 1e6),
            "pid": pid,
            "tid": 0,
            "cat": "phase",
            "args": {"run": s.run, "parent": s.parent},
        }
        for s in spans if s.end is not None
    ]
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "counters": dict(last_run)}, fh)
