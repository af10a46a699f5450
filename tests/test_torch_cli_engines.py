"""The seed/subseed loop, the native engine, other scores and the options
of bin/swarm-torch against bin/swarm, byte for byte
(tests/cli_parity.py): the loop under SWARM_TPU_D2_ENGINE=device and
python (the aligner's batch threshold lowered on both sides), the
16-bit regime and SWARM_TPU_D2_ENGINE=native, an option error's exit
code, the port's imports, and its profiler trace."""

import os
import subprocess
import sys

import pytest

from cli_parity import D2_OUTPUTS, ENV, REPO_ROOT, compare, run_side
from genfasta import amplicon_cloud


def test_custom_scores(tmp_path):
    fasta = amplicon_cloud(
        seed=47, n_centers=4, cloud_size=10, length=50, max_edits=3)
    compare(tmp_path, ["-d", "2", "-m", "2", "-p", "3", "-g", "6", "-e", "2"]
            + D2_OUTPUTS, fasta)


def test_16bit_falls_back_to_native(tmp_path):
    fasta = amplicon_cloud(
        seed=48, n_centers=2, cloud_size=10, length=50, max_edits=8)
    compare(tmp_path, ["-d", "30"] + D2_OUTPUTS, fasta)


#: (flags, corpus) of the seed/subseed-loop cases: d = 2 (band 4),
#: d = 3 (band 7) and a 16-bit case (d = 30: band 84, so the aligner
#: takes its full-row scores)
LOOP_CASES = {
    "d2": (["-d", "2"], dict(seed=54, n_centers=5, cloud_size=14, length=70,
                              max_edits=3)),
    "d3": (["-d", "3"], dict(seed=55, n_centers=4, cloud_size=12, length=60,
                              max_edits=4)),
    "16bit": (["-d", "30"], dict(seed=56, n_centers=2, cloud_size=10,
                                 length=50, max_edits=8)),
}


@pytest.mark.parametrize("engine", ["device", "python"])
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_seed_loop_engines(tmp_path, case, engine):
    flags, corpus = LOOP_CASES[case]
    got = compare(tmp_path, flags + D2_OUTPUTS, amplicon_cloud(**corpus),
                  engine)
    assert got.returncode == 0, got.stderr
    assert (tmp_path / "torch" / "out.txt").stat().st_size > 0


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_device_engine_runs_the_aligner(tmp_path, monkeypatch, case):
    """With the threshold lowered as in that launcher, the port's device
    engine hands target lists to DeviceAligner on these corpora."""
    from swarm_tpu_torch import metrics
    from swarm_tpu_torch.main import run
    from swarm_tpu_torch.ops.search_torch import DeviceAligner

    flags, corpus = LOOP_CASES[case]
    (tmp_path / "in.fasta").write_text(amplicon_cloud(**corpus))
    monkeypatch.setattr(DeviceAligner, "MIN_DEVICE_BATCH", 4)
    monkeypatch.setenv("SWARM_TPU_D2_ENGINE", "device")
    monkeypatch.chdir(tmp_path)
    metrics.reset()
    assert run(flags + ["-o", "out.txt", "-l", "log.txt", "in.fasta"],
               "swarm", device="cpu") == 0
    assert metrics.last_run["d2_device_batches"] > 0


@pytest.mark.parametrize("flags", [["-d", "2"], ["-d", "3", "-n"]],
                         ids=["d2", "d3n"])
def test_native_engine(tmp_path, flags):
    fasta = amplicon_cloud(
        seed=59, n_centers=6, cloud_size=15, length=70, max_edits=3)
    compare(tmp_path, flags + D2_OUTPUTS, fasta, engine="native")


def test_option_error_exit_code(tmp_path):
    # -j is a d=1 output: both sides refuse it at d=2 with one message
    got = compare(tmp_path, ["-d", "2", "-j", "network.txt"],
                  amplicon_cloud(seed=51, n_centers=2, cloud_size=3))
    assert got.returncode != 0


@pytest.mark.parametrize("d", ["0", "1", "2"])
def test_port_imports_no_jax(tmp_path, d):
    fasta = amplicon_cloud(seed=52, n_centers=4, cloud_size=10, length=60)
    (tmp_path / "in.fasta").write_text(fasta)
    code = (
        "import sys\n"
        "from swarm_tpu_torch.main import run\n"
        f"assert run(['-d', '{d}', '-o', 'out.txt', '-l', 'log.txt', "
        "'in.fasta'], 'swarm', device='cpu') == 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if 'jax' in m)[:5]\n"
        "assert 'swarm_tpu' not in sys.modules\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        timeout=300,
        env={**os.environ, **ENV, "PYTHONPATH": str(REPO_ROOT)},
    )
    assert r.returncode == 0, r.stderr.decode()
    assert (tmp_path / "out.txt").stat().st_size > 0


def test_profile_dir_writes_torch_trace(tmp_path):
    fasta = amplicon_cloud(seed=53, n_centers=3, cloud_size=8, length=50)
    prof = tmp_path / "prof"
    r = run_side("swarm-torch", tmp_path / "run",
             ["-d", "2", "-o", "out.txt", "-l", "log.txt"], fasta)
    assert r.returncode == 0
    env_run = subprocess.run(
        [sys.executable, "swarm", "-d", "2", "-o", "out2.txt", "-l",
         "log2.txt", "input.fasta"],
        cwd=tmp_path / "run", capture_output=True, timeout=300,
        env={**os.environ, **ENV, "PYTHONPATH": str(REPO_ROOT),
             "SWARM_TPU_PROFILE_DIR": str(prof)},
    )
    assert env_run.returncode == 0, env_run.stderr.decode()
    assert (prof / "trace.json").stat().st_size > 0
    assert (tmp_path / "run" / "out.txt").read_bytes() == \
        (tmp_path / "run" / "out2.txt").read_bytes()
