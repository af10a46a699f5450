"""The port's resident server (swarm_tpu_torch/server.py) and the
forwarding in bin/swarm-torch, on the CPU: the counterpart of
tests/test_server.py.

One server serves the module, started under SWARM_TORCH_DEVICE=cpu with
the device engines forced on (network screen at a 128-profile tile,
d=1 sort-join engine, device graft) and SWARM_TPU_TIMING=1, its stderr
in a file. A forwarded run must equal a direct bin/swarm-torch run
started with the server's variables (less SWARM_TPU_TIMING): stdout,
stderr, exit code and every output file, byte for byte.
"""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from genfasta import amplicon_cloud

REPO_ROOT = Path(__file__).resolve().parent.parent
BIN = REPO_ROOT / "bin" / "swarm-torch"

#: the server's variables, which every request runs under
SERVER_ENV = {
    "SWARM_TORCH_DEVICE": "cpu",
    "SWARM_TPU_D2_ENGINE": "network",
    "SWARM_TPU_D2_TILE": "128",
    "SWARM_TPU_D1_NATIVE_MAX": "0",
    "SWARM_TPU_GRAFT_PROBE_MAX": "0",
}


def base_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SWARM_TPU_", "SWARM_TORCH_"))}
    env["PYTHONPATH"] = str(REPO_ROOT)
    return env


def start_server(sock, env, stderr):
    proc = subprocess.Popen(
        [sys.executable, "-m", "swarm_tpu_torch.server", str(sock)],
        env=env, stderr=stderr, stdout=subprocess.DEVNULL)
    deadline = time.time() + 120
    while not os.path.exists(sock):
        if proc.poll() is not None or time.time() > deadline:
            proc.kill()
            raise RuntimeError("server did not start")
        time.sleep(0.05)
    return proc


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_srv")
    sock = root / "swarm.sock"
    log = root / "server_stderr.txt"
    with open(log, "wb") as err:
        proc = start_server(
            sock, {**base_env(), **SERVER_ENV, "SWARM_TPU_TIMING": "1"}, err)
        yield sock, log
        subprocess.run(
            [sys.executable, "-m", "swarm_tpu_torch.server", str(sock),
             "--shutdown"], env=base_env(), timeout=60, check=True)
        assert proc.wait(timeout=60) == 0
    assert not sock.exists()


def run_cli(args, cwd, env, stdin_bytes=b""):
    return subprocess.run([sys.executable, str(BIN), *args], cwd=cwd,
                          env=env, input=stdin_bytes, capture_output=True,
                          timeout=300)


def direct_env():
    return {**base_env(), **SERVER_ENV}


def forward_env(sock):
    return {**base_env(), "SWARM_TORCH_SERVER": str(sock)}


def write_corpus(path, seed):
    path.write_text(amplicon_cloud(seed=seed, n_centers=6, cloud_size=10,
                                   length=64))


OUTPUTS = {"-o": "o.txt", "-s": "s.txt", "-i": "i.txt", "-u": "u.txt",
           "-w": "w.fa", "-l": "l.txt"}


@pytest.mark.parametrize("flags", [
    ["-d", "0"], ["-d", "1"], ["-d", "1", "-f"], ["-d", "2"]],
    ids=lambda f: "".join(f))
def test_forwarded_run_matches_direct(server, tmp_path, flags):
    sock, log = server
    write_corpus(tmp_path / "in.fasta", 11)
    args = flags + [a for kv in OUTPUTS.items() for a in kv] + ["../in.fasta"]
    if flags == ["-d", "1"]:
        args = ["-j", "j.txt"] + args
    results = {}
    for side, env in (("direct", direct_env()), ("fwd", forward_env(sock))):
        (tmp_path / side).mkdir()
        results[side] = run_cli(args, tmp_path / side, env)
    direct, fwd = results["direct"], results["fwd"]
    assert direct.returncode == fwd.returncode == 0, direct.stderr.decode()
    assert direct.stdout == fwd.stdout
    assert direct.stderr == fwd.stderr
    names = list(OUTPUTS.values()) + (["j.txt"] if "-j" in args else [])
    for name in names:
        a = (tmp_path / "direct" / name).read_bytes()
        assert a == (tmp_path / "fwd" / name).read_bytes(), name
    assert (tmp_path / "direct" / "o.txt").stat().st_size > 0


def test_forwarded_stdin_and_stdout(server, tmp_path):
    """Input from stdin, clusters to '-' (stdout). Several outputs sent
    to '-' at once are interleaved otherwise by the server (see
    swarm_tpu_torch/server.py), as by swarm_tpu's."""
    sock, _ = server
    fasta = amplicon_cloud(seed=12, n_centers=5, cloud_size=8,
                           length=60).encode()
    args = ["-d", "1", "-o", "-", "-s", "s.txt"]
    direct = run_cli(args, tmp_path, direct_env(), stdin_bytes=fasta)
    fwd = run_cli(args, tmp_path, forward_env(sock), stdin_bytes=fasta)
    assert direct.returncode == fwd.returncode == 0
    assert direct.stdout == fwd.stdout and len(direct.stdout) > 0
    assert direct.stderr == fwd.stderr


@pytest.mark.parametrize("args,rc", [
    (["-d", "1", "missing_file.fasta"], 1),
    (["--bogus"], 1),
    (["-d", "2", "-m", "0", "in.fasta"], 1),
    (["--version"], 0),
], ids=["missing-file", "bad-option", "bad-value", "version"])
def test_forwarded_error_and_exit_paths(server, tmp_path, args, rc):
    """Fatal errors and an early exit give the direct run's rc and
    stderr, and the server goes on serving."""
    sock, _ = server
    write_corpus(tmp_path / "in.fasta", 13)
    direct = run_cli(args, tmp_path, direct_env())
    fwd = run_cli(args, tmp_path, forward_env(sock))
    assert direct.returncode == fwd.returncode == rc
    assert direct.stderr == fwd.stderr and direct.stderr
    assert direct.stdout == fwd.stdout
    ping = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    ping.connect(str(sock))
    ping.sendall(b'{"op": "ping"}\n')
    assert ping.makefile("rb").readline() == b'{"rc": 0}\n'
    ping.close()


def test_server_stays_warm_across_requests(server, tmp_path):
    """A second request of an unchanged file takes the server's DB cache:
    rewritten in place to the same size and mtime (the cache's key), the
    file is not read again, and the second run gives the first run's
    bytes, which a fresh process does not."""
    sock, _ = server
    fasta = tmp_path / "in.fasta"
    write_corpus(fasta, 14)
    args = ["-d", "1", "-o", "o.txt", "-s", "s.txt", "in.fasta"]
    first = run_cli(args, tmp_path, forward_env(sock))
    assert first.returncode == 0
    want = {f: (tmp_path / f).read_bytes() for f in ("o.txt", "s.txt")}
    st = fasta.stat()
    text = fasta.read_bytes()
    changed = text.swapcase()  # the same sequences, other headers
    assert len(changed) == len(text) and changed != text
    fasta.write_bytes(changed)
    os.utime(fasta, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert fasta.stat().st_ino == st.st_ino
    second = run_cli(args, tmp_path, forward_env(sock))
    assert second.returncode == 0
    assert second.stderr == first.stderr
    for f, data in want.items():
        assert (tmp_path / f).read_bytes() == data, f
    fresh = run_cli(["-d", "1", "-o", "fresh.txt", "in.fasta"], tmp_path,
                    direct_env())
    assert fresh.returncode == 0
    assert (tmp_path / "fresh.txt").read_bytes() != want["o.txt"]


def test_request_runs_in_the_server_environment(server, tmp_path):
    """The client's variables do not reach the run: under the client's
    SWARM_TPU_D2_ENGINE=native the server's network engine still runs
    (its [timing] lines go to the server's stderr, not the client's)."""
    sock, log = server
    write_corpus(tmp_path / "in.fasta", 15)
    before = log.read_bytes().count(b"[timing] d2 network (cpu)")
    env = {**forward_env(sock), "SWARM_TPU_D2_ENGINE": "native",
           "SWARM_TPU_TIMING": "1"}
    r = run_cli(["-d", "2", "-o", "o.txt", "in.fasta"], tmp_path, env)
    assert r.returncode == 0
    assert b"[timing]" not in r.stderr
    after = log.read_bytes().count(b"[timing] d2 network (cpu)")
    assert after > before


def test_dead_socket_runs_in_process(tmp_path):
    write_corpus(tmp_path / "in.fasta", 16)
    env = {**direct_env(),
           "SWARM_TORCH_SERVER": str(tmp_path / "nonexistent.sock")}
    r = run_cli(["-d", "0", "-o", "o.txt", "in.fasta"], tmp_path, env)
    assert r.returncode == 0, r.stderr.decode()
    assert (tmp_path / "o.txt").stat().st_size > 0


def test_jax_server_variable_is_ignored(tmp_path):
    """SWARM_TPU_SERVER names a listening socket; bin/swarm-torch never
    connects to it and runs in-process."""
    sock = tmp_path / "jax.sock"
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(str(sock))
    listener.listen(1)
    listener.settimeout(0.2)
    seen = []
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            try:
                conn, _ = listener.accept()
            except OSError:
                continue
            seen.append(conn)

    thread = threading.Thread(target=watch)
    thread.start()
    try:
        write_corpus(tmp_path / "in.fasta", 17)
        env = {**direct_env(), "SWARM_TPU_SERVER": str(sock)}
        r = run_cli(["-d", "0", "-o", "o.txt", "in.fasta"], tmp_path, env)
    finally:
        stop.set()
        thread.join()
        listener.close()
    assert r.returncode == 0, r.stderr.decode()
    assert (tmp_path / "o.txt").stat().st_size > 0
    assert not seen


def test_server_without_cuda_refuses_to_start(tmp_path):
    """No SWARM_TORCH_DEVICE and no CUDA device: the server raises
    before it listens (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sock = tmp_path / "s.sock"
    r = subprocess.run(
        [sys.executable, "-m", "swarm_tpu_torch.server", str(sock)],
        env=base_env(), capture_output=True, timeout=120)
    assert r.returncode != 0
    assert b"found no CUDA device" in r.stderr
    assert not sock.exists()
