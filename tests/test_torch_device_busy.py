"""scripts/device_busy.py: the device-busy union of a torch.profiler
chrome trace, on synthetic traces and on a traced CPU run of the port."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

from device_busy import busy_share  # noqa: E402


def _ev(cat, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


@pytest.mark.parametrize(
    "device_events,busy_us",
    [
        ([], 0),
        ([_ev("kernel", 100, 50)], 50),
        # overlapping kernel and copy merge; a gap between them does not
        ([_ev("kernel", 100, 50), _ev("gpu_memcpy", 120, 60),
          _ev("gpu_memset", 300, 10)], 90),
        # an interval inside another adds nothing
        ([_ev("kernel", 100, 400), _ev("kernel", 200, 10)], 400),
    ],
)
def test_busy_share_is_the_union_of_device_intervals(device_events, busy_us):
    trace = {"traceEvents": [_ev("cpu_op", 0, 1000, "run")] + device_events
             + [{"ph": "i", "ts": 5000, "name": "marker"}]}
    got = busy_share(trace)
    assert got["span_s"] == pytest.approx(1000 / 1e6)
    assert got["device_busy_s"] == pytest.approx(busy_us / 1e6)
    assert got["busy_share"] == pytest.approx(busy_us / 1000)


def test_top_kernels_ranked_by_device_time():
    trace = {"traceEvents": [
        _ev("kernel", 0, 5, "a"), _ev("kernel", 10, 5, "a"),
        _ev("kernel", 20, 30, "b"), _ev("cpu_op", 0, 100, "run"),
    ]}
    top = busy_share(trace)["top_kernels"]
    assert [(k["name"], k["launches"]) for k in top] == [("b", 1), ("a", 2)]
    assert top[1]["ms"] == pytest.approx(0.010)


def test_traced_run_on_cpu(tmp_path):
    fasta = tmp_path / "in.fasta"
    fasta.write_text(">a_3\nACGTACGTAA\n>b_2\nACGTACGTAC\n>c_1\nTTTTGGGGCC\n")
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "device_busy.py"),
         str(tmp_path / "trace"), "-d", "2", "-o", "out.txt", str(fasta)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["span_s"] > 0
    assert got["device_busy_s"] == 0  # no device on the CPU
    assert (tmp_path / "out.txt").read_text().count("\n") == 2
