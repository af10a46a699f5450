"""One run of one cell of the benchmark of swarm_tpu_torch.

A cell pairs a configuration (configs/<name>.json: the CLI flags, d and
swarm's scoring, its source, the name of its plain reference) with a
traffic mix (traffic/<name>.json: the generator's name and parameters).
The harness finds both by the names in BENCHMARK.json (or, for a cell
kept out of it, in cells/<name>.json), and by the names they give the
generator (generators/<name>.py), the reference (references/<name>.py)
and each metric (metrics/<name>.py).

Set-up: the corpus drawn from the seed on the device, its FASTA layout
built once, then one whole warm-up run of the program (the process'
first, cold run). The window: whole CLI runs of
``swarm_tpu_torch.main.run`` back to back (a closed loop, one client),
each on a FASTA file written before it, outside its timed interval, with
every label behind a tag of the run, so that each run reads an input
new to the process. Before each run, also outside its timed interval,
the garbage of the runs before it is collected, as a fresh process has
none. A run is timed from the call to the return, which comes after
every output file is closed. Runs start until ``seconds`` have passed.
After the window: the device's peak memory, then the reference and the
comparison (check.py).

A reference names the program's engine whose answers it also judges
(``ENGINE``: module, class, method); the harness sets a wrapper around
that method from its own files: it times the call and keeps what the
engine hands on, which the reference's ``program_edges`` reads.
"""

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "swarm_tpu")


def clear_program_env():
    """Drop every SWARM_TPU_* and SWARM_TORCH_* variable: the program
    runs with its default dispatch."""
    for key in list(os.environ):
        if key.startswith(("SWARM_TPU_", "SWARM_TORCH_")):
            del os.environ[key]


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def find_cell(name, root=ROOT):
    """(benchmark, cell, config, traffic) of a cell by name."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        path = root / "swarmbench" / "cells" / f"{name}.json"
        if not path.exists():
            raise KeyError(f"no cell {name!r} in BENCHMARK.json or "
                           f"swarmbench/cells")
        cell = load_json(path)
    config = load_json(root / "swarmbench" / "configs" /
                       f"{cell['config']}.json")
    traffic = load_json(root / "swarmbench" / "traffic" /
                        f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def load_part(kind, name, root=ROOT):
    """The module swarmbench/<kind>/<name>.py (a generator, a reference
    or a metric reader), found by its name."""
    path = root / "swarmbench" / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"swarmbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name, root=ROOT):
    """The read(ctx) function of metrics/<name>.py."""
    return load_part("metrics", name, root).read


@dataclass
class Run:
    """One CLI run of the window."""

    seconds: float = 0.0
    failed: bool = False
    error: str = ""
    start: float = 0.0          # perf_counter at the call
    end: float = 0.0            # perf_counter at the return
    engine: tuple = None        # perf_counter span of the wrapped engine
    edges: tuple = None         # (src, dst, diff) the engine handed on
    edges_same_as_first: bool = True
    streams: dict = field(default_factory=dict)  # tag-free bytes
    same_as_first: set = field(default_factory=set)
    phases: list = field(default_factory=list)   # program spans


class EngineCapture:
    """The wrapper around the engine method a reference names."""

    def __init__(self, target, traced):
        self.target = target    # (module, class, method) or None
        self.traced = traced
        self.calls = []
        self._original = None

    @property
    def label(self):
        return f"swarmbench.{self.target[2]}" if self.target else None

    def _owner(self):
        module, cls, method = self.target
        return getattr(importlib.import_module(module), cls), method

    def install(self):
        if self.target is None:
            return
        import torch

        owner, method = self._owner()
        original = getattr(owner, method)
        self._original = original
        capture = self

        def wrapped(engine, *args, **kwargs):
            ctx = torch.profiler.record_function(capture.label) if \
                capture.traced else contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx:
                out = original(engine, *args, **kwargs)
            capture.calls.append((t0, time.perf_counter(), out))
            return out

        setattr(owner, method, wrapped)

    def uninstall(self):
        if self._original is not None:
            owner, method = self._owner()
            setattr(owner, method, self._original)
            self._original = None


def _same_edges(a, b):
    import numpy as np

    return all(np.array_equal(x, y) for x, y in zip(a, b))


def process_start_wall():
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def card_info():
    """(name, power limit) of the card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


class Cell:
    """Set-up, window and check of one run of a cell."""

    def __init__(self, name, seed, seconds, traced, device, root=ROOT):
        self.name = name
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = bool(traced)
        self.device = device
        self.root = root
        self.bench, self.cell, self.config, self.traffic = find_cell(
            name, root)
        self.d = int(self.config["d"])
        self.outputs = list(self.config["outputs"])
        ref = self.config.get("reference")
        self.reference = load_part("references", ref, root) if ref else None
        self.runs = []
        self.setup_s = None

    def say(self, msg):
        sys.stderr.write(f"[swarmbench] {msg}\n")
        sys.stderr.flush()

    # -- set-up -------------------------------------------------------

    def prepare(self, workdir):
        import torch

        self.workdir = Path(workdir)
        if self.traced:
            self.trace_file = self.workdir / "phases.json"
            os.environ["SWARM_TPU_TRACE"] = str(self.trace_file)
        if torch.device(self.device).type == "cuda":
            t0 = time.perf_counter()
            torch.zeros(1, device=self.device)
            self.say(f"CUDA context: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        generator = load_part("generators", self.traffic["generator"],
                              self.root)
        self.corpus = generator.make_corpus(self.traffic, self.seed,
                                            self.device)
        self.corpus.build_fasta(self.device)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.say(f"corpus of {self.corpus.n} amplicons, "
                 f"{int(self.corpus.lengths.sum())} nt, "
                 f"{len(self.corpus.fasta)} bytes of FASTA: "
                 f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        from swarm_tpu_torch import main as program

        self.program = program
        self.say(f"import swarm_tpu_torch: {time.perf_counter() - t0:.3f} s")
        self.capture = EngineCapture(
            getattr(self.reference, "ENGINE", None), self.traced)
        self.capture.install()

    def argv(self, k):
        inp = self.workdir / f"in{k}.fasta"
        argv = list(self.config["args"])
        for flag in self.outputs:
            argv += [flag, str(self.workdir / f"out{k}{flag}")]
        argv += ["-l", str(self.workdir / f"out{k}.log"), str(inp)]
        return inp, argv

    def one_run(self, k, keep=True):
        """The k-th run: write its input, run, read back its streams."""
        import torch

        inp, argv = self.argv(k)
        tag = self.corpus.write(inp, k)
        self.capture.calls.clear()
        run = Run()
        device = None if torch.device(self.device).type == "cuda" else \
            self.device
        rf = torch.profiler.record_function("swarmbench.run") if \
            self.traced else contextlib.nullcontext()
        gc.collect()
        with rf:
            run.start = time.perf_counter()
            try:
                rc = self.program.run(argv, "swarm", device=device)
                run.failed = rc != 0
                run.error = f"exit code {rc}" if rc else ""
            except Exception as exc:  # a run that raises is a failed run
                run.failed = True
                run.error = f"{type(exc).__name__}: {exc}"
            run.end = time.perf_counter()
        run.seconds = run.end - run.start
        if self.capture.calls:
            t0, t1, out = self.capture.calls[-1]
            run.engine = (t0, t1)
            run.edges = self.reference.program_edges(out)
        self.capture.calls.clear()
        for flag in self.outputs:
            path = self.workdir / f"out{k}{flag}"
            if path.exists():
                run.streams[flag] = path.read_bytes().replace(tag, b"")
                path.unlink()
            elif not run.failed:
                run.failed, run.error = True, f"no {flag} file"
        for extra in (inp, self.workdir / f"out{k}.log"):
            extra.unlink(missing_ok=True)
        if self.traced and self.trace_file.exists():
            events = load_json(self.trace_file)["traceEvents"]
            run.phases = [(e["name"], e["ts"] / 1e6,
                           (e["ts"] + e["dur"]) / 1e6) for e in events]
            self.trace_file.unlink()
        self.say(f"run {k}: {run.seconds:.6f} s"
                 + (f", failed: {run.error}" if run.error else ""))
        if keep:
            self._against_first(run)
            self.runs.append(run)
        return run

    def _against_first(self, run):
        """Keep only what differs from the window's first good run."""
        first = next((r for r in self.runs if not r.failed), None)
        if first is None or run.failed:
            return
        if run.edges is not None and first.edges is not None:
            run.edges_same_as_first = _same_edges(run.edges, first.edges)
        else:
            run.edges_same_as_first = run.edges is None and \
                first.edges is None
        run.edges = None if run.edges_same_as_first else run.edges
        for flag in list(run.streams):
            if run.streams[flag] == first.streams.get(flag):
                run.same_as_first.add(flag)
                del run.streams[flag]

    # -- the window ---------------------------------------------------

    def window(self):
        import torch

        prof = None
        if self.traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        k = 1
        start = time.perf_counter()
        while True:
            self.one_run(k)
            k += 1
            if time.perf_counter() - start >= self.seconds:
                break
        self.trace_path = None
        if prof is not None:
            if torch.device(self.device).type == "cuda":
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            self.trace_path = self.workdir / "trace.json"
            prof.export_chrome_trace(str(self.trace_path))

    def _entries(self, section):
        """BENCHMARK.json's metrics of `section` that this cell reports
        (all of them for a cell kept out of BENCHMARK.json)."""
        listed = any(w["name"] == self.name for w in self.bench["workloads"])
        return [m for m in self.bench.get(section, [])
                if not listed or "workloads" not in m
                or self.name in m["workloads"]]

    def metrics(self, ctx):
        """The end-to-end metrics, or with a trace the per-layer ones,
        each read by its own file in metrics/."""
        out = {}
        section = "per_layer" if self.traced else "end_to_end"
        for m in self._entries(section):
            value = metric_reader(m["name"], self.root)(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    # -- after the window ---------------------------------------------

    def forbidden_modules(self):
        return sorted({m.split(".")[0] for m in list(sys.modules)}
                      & set(FORBIDDEN))

    def check(self):
        from . import check

        t0 = time.perf_counter()
        ref = self.reference.cluster(self.corpus, self.config, self.device)
        self.reference_s = time.perf_counter() - t0
        self.say(f"reference: {self.reference_s:.3f} s, {ref.counts}")
        numbers = check.compare(ref, self.runs, self.corpus.n)
        return check.verdict(numbers)

    def context(self):
        """What the metric readers read."""
        from . import trace

        ctx = {"runs": [r for r in self.runs if not r.failed],
               "attempted": list(self.runs), "setup_s": self.setup_s,
               "corpus": self.corpus, "d": self.d, "config": self.config,
               "engine": self.capture.target[2] if self.capture.target
               else None,
               "peaks": load_json(BENCH / "peaks.json"), "events": None,
               "window": None, "offset_us": None}
        if self.trace_path is not None:
            events = trace.load(self.trace_path)
            ctx["events"] = events
            ctx["window"] = trace.runs_of(events)
            if self.runs:
                # the program's spans run on perf_counter: align them on
                # the first run's annotation
                ctx["offset_us"] = ctx["window"][0][0] - \
                    self.runs[0].start * 1e6
            self.trace_path.unlink()
        return ctx


def host_spans(ctx):
    """[(name, start, end)] in trace microseconds: the harness's
    annotations, the program's phase spans, and each run's stretch after
    the wrapped engine (the graph replay and the writers)."""
    from . import trace

    spans = trace.annotations(ctx["events"])
    off = ctx["offset_us"]
    if off is None:
        return spans
    for r in ctx["runs"]:
        for name, s, t in r.phases:
            spans.append((name, s * 1e6 + off, t * 1e6 + off))
        if r.engine:
            spans.append((f"after {ctx['engine']}: replay, writers",
                          r.engine[1] * 1e6 + off, r.end * 1e6 + off))
    return spans


def device_summary(ctx):
    """(busy_s, window_s, breakdown) of the traced window."""
    from . import trace

    runs = ctx["window"]
    ops = trace.device_intervals(ctx["events"], runs)
    merged = trace.union(ops)
    busy = trace.busy_seconds(merged)
    named = trace.name_gaps(trace.gaps(merged, runs), host_spans(ctx))
    breakdown = {"device_ops": trace.top(trace.by_name(ops)),
                 "idle_gaps": trace.top(named)}
    return busy, trace.span_seconds(runs), breakdown


def run_cell(name, seed, seconds, traced, device, root=ROOT):
    """Set-up, window and check; returns the result dict (the JSON line).
    Raises where a run must print no result."""
    import torch

    t_start = process_start_wall()
    cell = Cell(name, seed, seconds, traced, device, root)
    cell.say(f"process start to set-up (interpreter, imports): "
             f"{time.time() - t_start:.3f} s")
    workdir = tempfile.mkdtemp(prefix="swarmbench-")
    try:
        cell.prepare(workdir)
        warm = cell.one_run(0, keep=False)
        if warm.failed:
            raise RuntimeError(f"the warm-up run failed: {warm.error}")
        cell.setup_s = time.time() - t_start
        cell.say(f"warm-up run (cold): {warm.seconds:.6f} s; set-up "
                 f"{cell.setup_s:.6f} s")
        cell.window()
        cell.capture.uninstall()
        found = cell.forbidden_modules()
        if found:
            raise RuntimeError(f"modules loaded in this process: {found}")
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            peak = max(torch.cuda.max_memory_allocated(i)
                       for i in range(torch.cuda.device_count()))
        else:
            peak = 0
        ctx = cell.context()
        metrics = cell.metrics(ctx)
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": int(cell.cell.get("chips", 1)),
               "memory_peak_bytes": int(peak)}
        result = {"correct": None, "attempted": len(cell.runs),
                  "failed": sum(1 for r in cell.runs if r.failed),
                  "metrics": metrics, "device": dev}
        if traced and ctx["events"] is not None:
            busy, window_s, breakdown = device_summary(ctx)
            dev["busy_s"] = busy
            dev["window_s"] = window_s
            result["breakdown"] = breakdown
        ctx = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        if cell.reference is not None:
            correct, table = cell.check()
        else:
            correct, table = False, {
                "reference": {"value": "none for this configuration",
                              "limit": "a reference"}}
        result["correct"] = correct
        result["card"] = card_info() if cuda else "cpu"
        result["reference_s"] = getattr(cell, "reference_s", None)
        result["check"] = table
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
