"""The run's record (swarm_tpu_torch/metrics.py) on the CPU, with the
d>=2 network engine forced (a 128-profile tile): the spans of the engine,
the graph replay and the writers, nested under their parents inside the
run; the progress phases, "Collecting seeds:" included; the counters;
the SWARM_TPU_TRACE file; the ranges in a torch.profiler trace; and the
benchmark's readers of them (swarmbench/metrics) on hand-built
contexts."""

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from genfasta import amplicon_cloud
from swarm_tpu_torch import metrics
from swarm_tpu_torch.main import run
from swarmbench.harness import metric_reader

#: the spans of every network run, each with its parent
ENGINE = {"d2_network.build": None,
          "d2_network.screen": "d2_network.build",
          "d2_network.to_host": "d2_network.build",
          "d2_network.diffs": "d2_network.build",
          "d2_network.csr": "d2_network.build",
          "general.cluster_graph": None}
#: each writer's option and span
WRITERS = {"-i": "general.write_structure", "-u": "general.write_uclust",
           "-s": "general.write_stats", "-o": "general.write_swarms",
           "-w": "general.write_seeds"}
SEED_PHASES = ("Collecting seeds:", "Sorting seeds:", "Writing seeds:")
ALL_OUTPUTS = ["-o", "-s", "-i", "-u", "-w"]


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    for key in list(os.environ):
        if key.startswith(("SWARM_TPU_", "SWARM_TORCH_")):
            monkeypatch.delenv(key)
    monkeypatch.setenv("SWARM_TPU_D2_ENGINE", "network")
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "128")
    (tmp_path / "in.fasta").write_text(
        amplicon_cloud(seed=41, n_centers=6, cloud_size=15, length=70))
    return tmp_path


def cluster(root, outputs=("-o",)):
    """One in-process -d 2 run; (start, end) on perf_counter around it."""
    argv = ["-d", "2", "-l", str(root / "log.txt")]
    for flag in outputs:
        argv += [flag, str(root / f"out{flag}")]
    argv.append(str(root / "in.fasta"))
    t0 = time.perf_counter()
    assert run(argv, "swarm", device="cpu") == 0
    return t0, time.perf_counter()


def by_name():
    return {s.name: s for s in metrics.spans}


@pytest.mark.parametrize("outputs", [["-o"], ALL_OUTPUTS],
                         ids=["o", "all"])
def test_spans_once_a_run_nested_inside_the_run(corpus, outputs):
    t0, t1 = cluster(corpus, outputs)
    names = [s.name for s in metrics.spans]
    want = {**ENGINE, **{WRITERS[f]: None for f in outputs}}
    for name, parent in want.items():
        assert names.count(name) == 1, name
    for flag, name in WRITERS.items():
        assert (name in names) == (flag in outputs), name
    spans = by_name()
    for s in metrics.spans:
        assert t0 <= s.start <= s.end <= t1, s.name
        assert s.run == metrics.run_id
        if s.name in want:
            assert s.parent == want[s.name], s.name
        if s.parent is not None:
            up = spans[s.parent]
            assert up.start <= s.start <= s.end <= up.end, s.name


def test_engine_steps_lie_within_the_build_in_order(corpus):
    cluster(corpus)
    spans = by_name()
    build = spans["d2_network.build"]
    steps = [spans[f"d2_network.{step}"]
             for step in ("screen", "to_host", "diffs", "csr")]
    at = build.start
    for s in steps:
        assert at <= s.start <= s.end
        at = s.end
    assert at <= build.end <= spans["general.cluster_graph"].start


def test_collecting_seeds_ends_where_sorting_starts(corpus):
    cluster(corpus, ["-o", "-w"])
    spans = by_name()
    for name in SEED_PHASES:
        assert spans[name].parent == "general.write_seeds"
    collecting, sorting = spans["Collecting seeds:"], spans["Sorting seeds:"]
    assert collecting.end is not None
    assert collecting.end <= sorting.start
    # the log holds swarm's own lines: no "100%" after collecting
    log = (corpus / "log.txt").read_text()
    assert "Collecting seeds:    Sorting seeds:" in log


def test_counters_repeat_and_a_raising_run_leaves_nothing(corpus,
                                                          monkeypatch):
    from swarm_tpu_torch.models import general

    cluster(corpus)
    first = dict(metrics.last_run)
    names = [s.name for s in metrics.spans]
    assert 0 < first["d2_network.edges"] <= first["d2_network.alignments"]
    cluster(corpus)
    assert metrics.last_run == first
    assert [s.name for s in metrics.spans] == names

    def raising(*args):
        raise RuntimeError("a writer failed")

    writer = general._write_d2_results
    monkeypatch.setattr(general, "_write_d2_results", raising)
    with pytest.raises(RuntimeError, match="a writer failed"):
        cluster(corpus)
    assert "d2_network.build" in by_name()
    monkeypatch.setattr(general, "_write_d2_results", writer)
    failed = metrics.run_id
    cluster(corpus)
    assert metrics.run_id == failed + 1
    assert metrics.last_run == first
    assert [s.name for s in metrics.spans] == names
    assert {s.run for s in metrics.spans} == {metrics.run_id}


def test_alignments_count_alike_on_both_diffs_paths(corpus, monkeypatch):
    """Every counter alike but the tasks laid out and the edges
    partitioned on the engine's device: the tasks are laid out, and the
    CSR made, where the diffs ran."""
    counts = []
    for mode in ("native", "device"):
        monkeypatch.setenv("SWARM_TPU_D2_DIFFS", mode)
        cluster(corpus)
        counts.append(dict(metrics.last_run))
    native, device = counts
    assert native.pop("d2_network.csr_device_edges") == 0
    assert device.pop("d2_network.csr_device_edges") == \
        device["d2_network.edges"]
    assert native.pop("d2_network.device_tasks") == 0
    assert device.pop("d2_network.device_tasks") == \
        device["d2_network.alignments"]
    assert native == device
    assert native["d2_network.alignments"] > 0


@pytest.mark.parametrize("mode,on_device",
                         [("auto", False), ("native", False),
                          ("device", True)])
def test_csr_device_edges_recorded_on_either_path(corpus, monkeypatch, mode,
                                                  on_device):
    """d2_network.csr_device_edges and d2_network.device_tasks are
    recorded on every network run: 0 where the host laid the tasks out
    and partitioned the edges (the native diffs: on the CPU unless asked
    for the device's), every edge and every alignment where the engine's
    device did."""
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", mode)
    cluster(corpus)
    edges = metrics.last_run["d2_network.edges"]
    alignments = metrics.last_run["d2_network.alignments"]
    assert alignments >= edges > 0
    assert metrics.last_run["d2_network.csr_device_edges"] == (
        edges if on_device else 0)
    assert metrics.last_run["d2_network.device_tasks"] == (
        alignments if on_device else 0)


def test_trace_file_holds_the_record(corpus, monkeypatch):
    path = corpus / "trace.json"
    # set after the program was imported: read when the file is written
    monkeypatch.setenv("SWARM_TPU_TRACE", str(path))
    cluster(corpus, ALL_OUTPUTS)
    data = json.loads(path.read_text())
    events = data["traceEvents"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 and isinstance(e["ts"], int)
               for e in events)
    assert [e["name"] for e in events] == [s.name for s in metrics.spans]
    assert {e["args"]["run"] for e in events} == {metrics.run_id}
    assert [e["args"]["parent"] for e in events] == [
        s.parent for s in metrics.spans]
    assert data["counters"] == metrics.last_run
    assert data["counters"]["d2_network.edges"] > 0


def test_profiler_trace_holds_the_spans_as_ranges(corpus, tmp_path,
                                                  monkeypatch):
    # no profiler: no range is entered
    entered = []
    record_function = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", entered.append)
    cluster(corpus)
    assert entered == []
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        cluster(corpus, ["-o", "-w"])
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    ranges = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {s.name for s in metrics.spans} <= ranges
    assert set(ENGINE) | {"general.write_seeds", *SEED_PHASES} <= ranges


# ---- the benchmark's readers of the record ------------------------------

SPAN_READERS = {"d2_network.screen_s": ("d2_network.screen",),
                "d2_network.to_host_s": ("d2_network.to_host",),
                "d2_network.diffs_s": ("d2_network.diffs",),
                "d2_network.csr_s": ("d2_network.csr",),
                "general.cluster_graph_s": ("general.cluster_graph",),
                "general.writers_s": tuple(WRITERS.values())}


def _ctx(runs):
    return {"runs": [r for r in runs if not r.failed], "attempted": runs}


def _run_of(phases, failed=False):
    return SimpleNamespace(phases=phases, failed=failed)


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_span_readers_on_a_hand_built_context(metric):
    read = metric_reader(metric)
    names = SPAN_READERS[metric]
    # two runs: each of the metric's spans lasts 0.5 s in the first and
    # 1.5 s in the second, beside spans the metric does not read
    runs = [_run_of([(n, 10.0 + k, 10.0 + k + w) for k, n in enumerate(names)]
                    + [("Reading sequences:", 1.0, 9.0)])
            for w in (0.5, 1.5)]
    assert read(_ctx(runs)) == pytest.approx(len(names) * 1.0)
    assert read(_ctx([_run_of([]), _run_of([])])) is None
    assert read(_ctx([_run_of([("Reading sequences:", 1.0, 9.0)])])) is None


def test_accept_pct_reads_the_last_runs_counters(monkeypatch):
    read = metric_reader("d2_network.accept_pct")
    monkeypatch.setattr(metrics, "last_run", {
        "d2_network.alignments": 400, "d2_network.edges": 300,
        "alignment_comparisons": 250})
    ok = [_run_of([]), _run_of([])]
    assert read(_ctx(ok)) == pytest.approx(75.0)
    assert read(_ctx(ok + [_run_of([], failed=True)])) is None
    monkeypatch.setattr(metrics, "last_run", {"alignment_comparisons": 9})
    assert read(_ctx(ok)) is None


def test_readers_on_the_programs_own_file(corpus, monkeypatch):
    """Two runs' files read as the harness reads them: every reader
    finds its spans, and the engine's four steps fit in its build."""
    path = corpus / "trace.json"
    monkeypatch.setenv("SWARM_TPU_TRACE", str(path))
    runs = []
    for _ in range(2):
        cluster(corpus, ALL_OUTPUTS)
        events = json.loads(path.read_text())["traceEvents"]
        runs.append(_run_of([(e["name"], e["ts"] / 1e6,
                              (e["ts"] + e["dur"]) / 1e6) for e in events]))
    ctx = _ctx(runs)
    values = {m: metric_reader(m)(ctx) for m in
              [*SPAN_READERS, "d2_network.accept_pct"]}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert 0 < values["d2_network.accept_pct"] <= 100
    build = sum(t - s for r in runs for n, s, t in r.phases
                if n == "d2_network.build") / len(runs)
    steps = sum(values[f"d2_network.{step}_s"]
                for step in ("screen", "to_host", "diffs", "csr"))
    assert steps <= build + 4e-6


# ---- the d=1 network and -f's graft -------------------------------------

#: the spans of a -d 1 -f run on the sort-join engine and the device
#: graft, each with its parent
D1F = {"d1_network.build": "Building network:",
       **{f"d1_network.{step}": "d1_network.build" for step in (
           "keys", "partition", "join", "verify", "to_host", "finish")},
       "fastidious.graft":
           "Checking heavy swarm amplicons against Bloom filter",
       **{f"fastidious.{step}": "fastidious.graft" for step in (
           "keys", "partition", "join", "verify", "to_host")}}
#: the sort-join network and the device graft at any n, on the CPU
D1F_ENGINES = {"SWARM_TPU_D1_NATIVE_MAX": "0",
               "SWARM_TPU_GRAFT_PROBE_MAX": "0"}
D1F_READERS = ("d1_network.build_s", "d1_network.finish_s",
               "d1.dup_check_s", "d1.cluster_s", "fastidious.attach_s",
               "d1.writers_s", "fastidious.graft_s")


def _d1f_env(mp):
    for key in list(os.environ):
        if key.startswith(("SWARM_TPU_", "SWARM_TORCH_")):
            mp.delenv(key)
    for key, value in D1F_ENGINES.items():
        mp.setenv(key, value)


def cluster_d1f(root):
    argv = ["-d", "1", "-f", "-l", str(root / "log.txt")]
    for flag in ("-o", "-s", "-i", "-w"):
        argv += [flag, str(root / f"out{flag}")]
    argv.append(str(root / "in.fasta"))
    t0 = time.perf_counter()
    assert run(argv, "swarm", device="cpu") == 0
    return t0, time.perf_counter()


@pytest.fixture(scope="module")
def d1f_run(tmp_path_factory):
    """One -d 1 -f run, timed and traced, of 2,000 reads of 150 nt at 1%
    errors a base (hundreds of light swarms to graft) on the sort-join
    network and the device graft: what it left in the record, the log,
    the [timing] lines and the trace file, for the tests below."""
    import io
    import sys

    from swarmbench.generators import reads

    root = tmp_path_factory.mktemp("d1f")
    with open(os.path.join(os.path.dirname(__file__), "..", "swarmbench",
                           "traffic", "reads-150nt-1m.json")) as fh:
        params = json.load(fh)
    params.update(amplicons=2000, community=dict(
        params["community"], sequences=220), errors=dict(
        params["errors"], per_base=0.01))
    reads.make_corpus(params, 2 ** 32 + 9).write(root / "in.fasta", 1)
    err = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        _d1f_env(mp)
        mp.setenv("SWARM_TPU_TIMING", "1")
        mp.setenv("SWARM_TPU_TRACE", str(root / "trace.json"))
        mp.setattr(sys, "__stderr__", err)
        t0, t1 = cluster_d1f(root)
    events = json.loads((root / "trace.json").read_text())["traceEvents"]
    return SimpleNamespace(
        root=root, t0=t0, t1=t1, spans=list(metrics.spans),
        counters=dict(metrics.last_run), log=(root / "log.txt").read_text(),
        stderr=err.getvalue(),
        phases=[(e["name"], e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6)
                for e in events])


def test_d1f_spans_nested_and_once(d1f_run):
    names = [s.name for s in d1f_run.spans]
    spans = {s.name: s for s in d1f_run.spans}
    for name, parent in D1F.items():
        want = 1 if name.startswith("d1_network.") or name in (
            "fastidious.graft", "fastidious.to_host") else None
        assert name in names, name
        if want:
            assert names.count(name) == want, name
        assert all(s.parent == parent for s in d1f_run.spans
                   if s.name == name), name
    assert names.count("d1_network.start") == 1
    # started before the duplicate check, which overlaps the card's work
    assert spans["d1_network.start"].end <= \
        spans["Hashing sequences:"].start
    for s in d1f_run.spans:
        assert d1f_run.t0 <= s.start <= s.end <= d1f_run.t1, s.name
        if s.parent is not None:
            up = spans[s.parent]
            assert up.start <= s.start <= s.end <= up.end, s.name
    at = spans["d1_network.build"].start
    for step in ("keys", "partition", "join", "verify", "to_host",
                 "finish"):
        s = spans[f"d1_network.{step}"]
        assert at <= s.start
        at = s.end


def test_d1f_counters_equal_the_log(d1f_run, monkeypatch):
    c = d1f_run.counters

    def logged(pattern):
        import re

        return int(re.search(pattern, d1f_run.log).group(1))

    assert c["graft_join_comparisons"] == logged(
        r"Got (\d+) graft candidates") > 0
    assert c["fastidious.grafts"] == logged(r"Made (\d+) grafts") > 0
    assert c["fastidious.light_amplicons"] == logged(
        r"Light swarms: \d+, with (\d+) amplicons")
    assert c["fastidious.heavy_amplicons"] == logged(
        r"Heavy swarms: \d+, with (\d+) amplicons")
    assert c["fastidious.light_amplicons"] + \
        c["fastidious.heavy_amplicons"] == 2000
    assert 0 < c["d1_network.pairs"] <= c["d1_join_comparisons"]
    assert c["d1_network.pairs"] <= c["d1_network.edges"] <= \
        2 * c["d1_network.pairs"]
    # the native builder hands on the same edges, and keeps no join
    _d1f_env(monkeypatch)
    monkeypatch.setenv("SWARM_TPU_D1_NATIVE_MAX", str(1 << 30))
    cluster_d1f(d1f_run.root)
    native = metrics.last_run
    assert native["d1_network.edges"] == c["d1_network.edges"]
    assert "d1_network.pairs" not in native
    assert "d1_network.build" in by_name() and \
        "d1_network.keys" not in by_name()


def test_d1f_timing_lines_print_the_spans(d1f_run):
    lines = [ln.split() for ln in d1f_run.stderr.splitlines()
             if ln.startswith(("[timing] d1 join", "[timing] graft"))]
    got = {(ln[1], ln[-2]): float(ln[-1].rstrip("s")) for ln in lines}
    d1 = ("start", "keys", "partition", "join", "verify", "to_host",
          "finish")
    graft = ("keys", "partition", "join", "verify", "to_host")
    assert [ln[-2] for ln in lines if ln[1] == "d1"] == list(d1)
    assert [ln[-2] for ln in lines if ln[1] == "graft"] == list(graft)
    assert {ln[-3] for ln in lines} == {"(cpu)"}
    for kind, prefix, steps in (("d1", "d1_network", d1),
                                ("graft", "fastidious", graft)):
        for step in steps:
            assert got[kind, step] == pytest.approx(sum(
                s.end - s.start for s in d1f_run.spans
                if s.name == f"{prefix}.{step}"), abs=1e-3)


def test_d1f_readers_on_the_programs_own_file(d1f_run, monkeypatch):
    monkeypatch.setattr(metrics, "last_run", d1f_run.counters)
    ctx = _ctx([_run_of(d1f_run.phases)])
    values = {m: metric_reader(m)(ctx) for m in D1F_READERS}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["d1_network.finish_s"] <= values["d1_network.build_s"]
    pct = metric_reader("d1_network.verified_pct")(ctx)
    assert 0 < pct <= 100
    assert pct == pytest.approx(100 * d1f_run.counters["d1_network.pairs"]
                                / d1f_run.counters["d1_join_comparisons"])
    # a program without these spans (the parent's): nothing, no raise
    bare = _ctx([_run_of([("Reading sequences:", 1.0, 9.0)])])
    for name in ("d1_network.build_s", "d1_network.finish_s",
                 "fastidious.graft_s"):
        assert metric_reader(name)(bare) is None


def _kernel_trace():
    """A synthetic device trace of one run: the program's spans as
    record_function ranges, launches tied to kernels by correlation."""
    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    return [
        x("user_annotation", "swarmbench.run", 0, 1000),
        x("user_annotation", "d1_network.start", 10, 40),
        x("user_annotation", "d1_network.build", 100, 200),
        x("user_annotation", "fastidious.graft", 400, 100),
        # launched inside the spans, run later on the card
        x("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=1),
        x("kernel", "d1_keygen_kernel", 60, 30, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 150, 2, corr=2),
        x("kernel", "d1_partition_scatter_kernel", 155, 10, corr=2),
        x("cuda_driver", "cuLaunchKernel", 420, 2, corr=3),
        x("kernel", "d1_partition_scatter_kernel", 430, 7, corr=3),
        x("cuda_runtime", "cudaLaunchKernel", 450, 2, corr=4),
        x("kernel", "graft_join_count_kernel", 460, 5, corr=4),
        # outside every span: counted by neither
        x("cuda_runtime", "cudaLaunchKernel", 600, 2, corr=5),
        x("kernel", "d2_screen_kernel", 610, 50, corr=5),
        x("gpu_memcpy", "Memcpy HtoD", 30, 5, corr=6),
        x("cuda_runtime", "cudaMemcpyAsync", 25, 2, corr=6),
    ]


def test_kernel_readers_attribute_by_correlation():
    from swarmbench import trace

    events = _kernel_trace()
    ctx = {"events": events, "window": trace.runs_of(events),
           "runs": [object()]}
    assert metric_reader("d1_network.kernel_ms")(ctx) == pytest.approx(
        (30 + 10) / 1e3)
    assert metric_reader("fastidious.kernel_ms")(ctx) == pytest.approx(
        (7 + 5) / 1e3)
    ctx["runs"] = [object(), object()]
    assert metric_reader("fastidious.kernel_ms")(ctx) == pytest.approx(
        6 / 1e3)
    # no program span (the parent's trace), or no trace: nothing
    bare = [e for e in events if not e["name"].startswith(
        ("d1_network.", "fastidious."))]
    for name in ("d1_network.kernel_ms", "fastidious.kernel_ms"):
        assert metric_reader(name)(dict(ctx, events=bare)) is None
        assert metric_reader(name)(dict(ctx, events=None)) is None
