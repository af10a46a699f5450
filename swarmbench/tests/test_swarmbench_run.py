"""Whole runs of the harness on the CPU at a tiny size: the result line,
correct runs of both configurations, and the faults the comparison has
to catch. The card's run of the same is marked `cuda`."""

import json
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO
from swarmbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, cell="tiny_d2", seconds=0.5, traced=0, device="cpu"):
    return harness.run_cell(cell, 2 ** 31 + 17, seconds, traced, device,
                            root)


@pytest.mark.parametrize("cell", ["tiny_d2", "tiny_d3"])
def test_correct_and_the_result_line(tiny_root, cell):
    result = run(tiny_root, cell)
    assert list(result)[:5] == KEYS
    assert list(result)[-1] == "check"
    assert set(result) <= set(KEYS) | {"breakdown", "card", "reference_s",
                                       "check"}
    assert result["correct"] is True, result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"amplicons_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"}
               for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert all(set(row) == {"value", "limit"}
               for row in result["check"].values())
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics(tiny_root, monkeypatch,
                                              tmp_path):
    from swarm_tpu_torch import progress

    # the program reads SWARM_TPU_TRACE when it is imported: a fresh
    # process (run.py) sets it first, this test process sets the module
    monkeypatch.setattr(progress, "_TRACE", str(tmp_path / "phases.json"))
    real_prepare = harness.Cell.prepare

    def prepare(self, workdir):
        real_prepare(self, workdir)
        self.trace_file = tmp_path / "phases.json"

    monkeypatch.setattr(harness.Cell, "prepare", prepare)
    result = run(tiny_root, traced=1)
    assert result["correct"] is True
    # on the CPU no device operation runs: the readers of the card's
    # trace find nothing and report nothing
    assert set(result["metrics"]) == {
        "db.read_s", "general.profiles_s", "general.replay_writers_s",
        "d2_network.build_s"}
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _wrap_build(monkeypatch, change):
    from swarm_tpu_torch.ops import d2_network

    original = d2_network.D2NetworkEngine.build_adjacency

    def build(engine, *args, **kwargs):
        return change(engine, original(engine, *args, **kwargs))

    monkeypatch.setattr(d2_network.D2NetworkEngine, "build_adjacency", build)


def test_fault_state_unchanged(tiny_root, monkeypatch):
    """A run that returns at once, its outputs never written."""
    from swarm_tpu_torch import main

    real = main.run
    calls = []

    def lazy(argv, progname, device=None):
        calls.append(1)
        return real(argv, progname, device) if len(calls) == 1 else 0

    monkeypatch.setattr(main, "run", lazy)
    result = run(tiny_root)
    assert result["correct"] is False
    assert result["check"]["runs_failed"]["value"] >= 1


def test_fault_half_the_batch_left_out(tiny_root, monkeypatch):
    """The network engine drops the edges of the second half of the
    amplicons."""
    def half(engine, out):
        adj_start, adj_count, adj_to, adj_diff = out[:4]
        n = len(adj_count)
        cut = int(adj_start[n // 2]) if n else 0
        count = adj_count.copy()
        count[n // 2:] = 0
        return (adj_start, count, adj_to[:cut], adj_diff[:cut]) + out[4:]

    _wrap_build(monkeypatch, half)
    result = run(tiny_root)
    assert result["correct"] is False
    assert result["check"]["edges_missing"]["value"] > 0


def test_fault_an_answer_altered(tiny_root, monkeypatch):
    """One edge's difference count altered where the engine makes it."""
    def alter(engine, out):
        diff = np.array(out[3], copy=True)
        diff[len(diff) // 2] ^= 1
        return out[:3] + (diff,) + out[4:]

    _wrap_build(monkeypatch, alter)
    result = run(tiny_root)
    assert result["correct"] is False
    assert result["check"]["edge_diffs_differ"]["value"] == 1


def _add_cell(root, name, config, traffic):
    with open(root / "swarmbench" / "cells" / f"{name}.json", "w") as fh:
        json.dump({"name": name, "config": config, "traffic": traffic,
                   "chips": 1, "why": "test"}, fh)


def test_a_cell_of_data_files_alone(tiny_root):
    """A new traffic shape (reads cut to one length) and a configuration
    with no reference are files and entries, not code."""
    bench = tiny_root / "swarmbench"
    params = json.loads((bench / "traffic" / "tiny_d2.json").read_text())
    params["truncate"] = 140
    (bench / "traffic" / "tiny_cut.json").write_text(json.dumps(params))
    _add_cell(tiny_root, "tiny_cut", "swarm-d2-150nt", "tiny_cut")
    result = run(tiny_root, "tiny_cut")
    assert result["correct"] is True, result["check"]
    config = json.loads((bench / "configs" / "swarm-d2-150nt.json")
                        .read_text())
    config["reference"] = None
    (bench / "configs" / "tiny-noref.json").write_text(json.dumps(config))
    _add_cell(tiny_root, "tiny_noref", "tiny-noref", "tiny_d2")
    result = run(tiny_root, "tiny_noref")
    assert result["correct"] is False
    assert list(result["check"]) == ["reference"]


def test_generator_found_by_name(tiny_root):
    bench = tiny_root / "swarmbench"
    (bench / "generators" / "refuse.py").write_text(
        "def make_corpus(params, seed, device='cpu'):\n"
        "    raise LookupError('generator refuse was asked')\n")
    params = json.loads((bench / "traffic" / "tiny_d2.json").read_text())
    params["generator"] = "refuse"
    (bench / "traffic" / "tiny_refuse.json").write_text(json.dumps(params))
    _add_cell(tiny_root, "tiny_refuse", "swarm-d2-150nt", "tiny_refuse")
    with pytest.raises(LookupError, match="refuse was asked"):
        run(tiny_root, "tiny_refuse")


def test_no_result_with_jax_loaded(tiny_root, monkeypatch):
    """A module of JAX or the JAX package in sys.modules once the window
    has closed: the run raises, so run.py prints no result."""
    import types

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    with pytest.raises(RuntimeError, match="jaxlib"):
        run(tiny_root)


def test_run_py_refuses_without_a_card(tmp_path):
    """Without CUDA, run.py exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(REPO / "swarmbench" / "run.py"), "--workload",
         "d2_150nt_500k", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_card_run_is_correct(tiny_root, cuda_device, monkeypatch):
    monkeypatch.delenv("SWARM_TPU_D2_TILE")  # the card's own tile
    result = run(tiny_root, device=cuda_device)
    assert result["correct"] is True, result["check"]
