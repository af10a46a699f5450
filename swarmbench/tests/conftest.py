"""Fixtures of the benchmark's own tests (CPU; `cuda` tests skip here).

    python -m pytest swarmbench/tests -q

A test cell is a copy of a real cell's files at a few thousand
amplicons, in a temporary root beside a copy of BENCHMARK.json. On the
CPU the program's d>=2 dispatch takes its native engine, so the tests
ask for the network engine (and small tiles), which the benchmark's own
runs never do.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SCORING = {"match_reward": 5, "mismatch_penalty": 4,
           "gap_opening_penalty": 12, "gap_extension_penalty": 4}


def small_traffic(name, amplicons):
    """A real traffic file's parameters at `amplicons` amplicons: its
    community cut in proportion, with twice the room and at least 100
    sequences (a few large clouds sway a small community's count of
    distinct amplicons)."""
    with open(REPO / "swarmbench" / "traffic" / f"{name}.json") as fh:
        params = json.load(fh)
    comm = params["community"]
    comm["sequences"] = max(
        100, 2 * comm["sequences"] * amplicons // params["amplicons"])
    params["amplicons"] = amplicons
    return params


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A root with BENCHMARK.json, swarmbench's data and readers, and the
    cells tiny_d2 and tiny_d3 (2,000 amplicons)."""
    root = tmp_path / "root"
    (root / "swarmbench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "cells", "metrics", "generators",
                "references"):
        shutil.copytree(REPO / "swarmbench" / sub, root / "swarmbench" / sub)
    shutil.copy(REPO / "swarmbench" / "peaks.json",
                root / "swarmbench" / "peaks.json")
    for cell, config, traffic in (
            ("tiny_d2", "swarm-d2-150nt", "reads-150nt-500k"),
            ("tiny_d3", "swarm-d3-253nt", "reads-253nt-300k")):
        with open(root / "swarmbench" / "traffic" / f"{cell}.json",
                  "w") as fh:
            json.dump(small_traffic(traffic, 2000), fh)
        with open(root / "swarmbench" / "cells" / f"{cell}.json", "w") as fh:
            json.dump({"name": cell, "config": config, "traffic": cell,
                       "chips": 1, "why": "test"}, fh)
    monkeypatch.setenv("SWARM_TPU_D2_ENGINE", "network")
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "128")
    return root


@pytest.fixture
def cuda_device():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
