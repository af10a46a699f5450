"""swarm_tpu_torch stands on its own, and its copied host layers have
not drifted from swarm_tpu's.

(a) statically: no module of the port, nor chip_smoke.py, nor the
    launcher, nor scripts/device_busy.py and scripts/dispatch_sweep.py
    imports swarm_tpu, jax, bench or a tests/ module;
(b) in a running process: bin/swarm-torch for d = 0, 1, 2 on the CPU
    ends with neither jax nor swarm_tpu in sys.modules, d = 1 also with
    its sort-join engine forced (SWARM_TPU_D1_NATIVE_MAX=0), on a
    uniform and on a mixed-length corpus, -f with its device graft
    forced (SWARM_TPU_GRAFT_PROBE_MAX=0), and -d 1 -f and -d 2 over 3
    in-process shards (SWARM_TORCH_SHARDS=3);
(c) the copies against the originals on seeded corpora: db_read and the
    native wrappers give the same arrays, the corpus generators the same
    records (the CLI cases of tests/test_torch_cli*.py hold the outputs
    byte for byte);
(b') the resident server (swarm_tpu_torch/server.py) serves d = 1, 2
    and -f on the CPU and ends with neither jax nor swarm_tpu in
    sys.modules; a forwarding client, and the server module alone,
    import neither torch nor numpy;
(d) run() with no device asked raises on a machine without CUDA, and
    runs when the CPU is asked for.
"""

import ast
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genfasta import amplicon_cloud

REPO_ROOT = Path(__file__).resolve().parent.parent

PORT_FILES = sorted(
    [*(REPO_ROOT / "swarm_tpu_torch").rglob("*.py"),
     REPO_ROOT / "chip_smoke.py",
     REPO_ROOT / "bin" / "swarm-torch",
     REPO_ROOT / "scripts" / "device_busy.py",
     REPO_ROOT / "scripts" / "dispatch_sweep.py"])

#: top-level module names the port must not import: the JAX package and
#: JAX itself, the benchmark script, and every module under tests/
FORBIDDEN = {"swarm_tpu", "jax", "jaxlib", "bench", "bench_kernels"} | {
    p.stem for p in (REPO_ROOT / "tests").glob("*.py")}


def _imported_modules(path):
    """(line, top-level module) of every import in the file, wherever it
    stands (module level or inside a function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO_ROOT)))
def test_port_file_imports_nothing_of_the_jax_side(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO_ROOT)} imports {bad}"


def test_port_file_list_is_complete():
    names = {str(p.relative_to(REPO_ROOT)) for p in PORT_FILES}
    for must in ("swarm_tpu_torch/main.py", "swarm_tpu_torch/_native/__init__.py",
                 "swarm_tpu_torch/models/general.py",
                 "swarm_tpu_torch/ops/search_torch.py",
                 "swarm_tpu_torch/ops/neighbors_sortjoin.py", "chip_smoke.py",
                 "swarm_tpu_torch/server.py", "bin/swarm-torch",
                 "swarm_tpu_torch/parallel/mesh.py",
                 "swarm_tpu_torch/parallel/distributed.py",
                 "scripts/device_busy.py", "scripts/dispatch_sweep.py"):
        assert must in names
    assert "_host_d1_backend" not in (
        REPO_ROOT / "swarm_tpu_torch" / "main.py").read_text()


#: runs the launcher in this interpreter, then looks at what it imported
LAUNCHER_PROBE = """import runpy, sys
try:
    runpy.run_path({launcher!r}, run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "swarm_tpu", "bench"))
assert not bad, bad[:5]
"""


@pytest.mark.parametrize("flags", [
    ["-d", "0"], ["-d", "1"], ["-d", "1", "-f"], ["-d", "2"]],
    ids=lambda f: "".join(f))
def test_launcher_process_holds_no_jax(tmp_path, flags):
    (tmp_path / "in.fasta").write_text(
        amplicon_cloud(seed=71, n_centers=4, cloud_size=10, length=60))
    probe = LAUNCHER_PROBE.format(
        launcher=str(REPO_ROOT / "bin" / "swarm-torch"))
    r = subprocess.run(
        [sys.executable, "-c", probe, *flags, "-o", "out.txt", "-l",
         "log.txt", "in.fasta"],
        cwd=tmp_path, capture_output=True, timeout=300,
        env={**os.environ, "SWARM_TORCH_DEVICE": "cpu",
             "PYTHONPATH": str(REPO_ROOT)})
    assert r.returncode == 0, r.stderr.decode()
    assert (tmp_path / "out.txt").stat().st_size > 0


def test_launcher_d1_sortjoin_engine_holds_no_jax(tmp_path):
    """-d 1 with the torch sort-join engine forced: the engine runs (its
    [timing] lines show it) and imports nothing of the JAX side."""
    (tmp_path / "in.fasta").write_text(
        amplicon_cloud(seed=75, n_centers=4, cloud_size=10, length=60))
    probe = LAUNCHER_PROBE.format(
        launcher=str(REPO_ROOT / "bin" / "swarm-torch"))
    r = subprocess.run(
        [sys.executable, "-c", probe, "-d", "1", "-o", "out.txt", "-l",
         "log.txt", "in.fasta"],
        cwd=tmp_path, capture_output=True, timeout=300,
        env={**os.environ, "SWARM_TORCH_DEVICE": "cpu",
             "SWARM_TPU_D1_NATIVE_MAX": "0", "SWARM_TPU_TIMING": "1",
             "PYTHONPATH": str(REPO_ROOT)})
    assert r.returncode == 0, r.stderr.decode()
    assert b"[timing] d1 join (cpu) verify" in r.stderr
    assert (tmp_path / "out.txt").stat().st_size > 0


def test_launcher_d1_engine_on_mixed_lengths_holds_no_jax(tmp_path):
    """-d 1 -o -s -u -i -w on a mixed-length corpus with the torch engine
    forced: the engine packs its ragged rows (its [timing] lines show
    its start: the arena's copy and the count and pack pass) and imports
    nothing of the JAX side."""
    from cli_parity import mixed_lengths_fasta

    (tmp_path / "in.fasta").write_text(mixed_lengths_fasta())
    probe = LAUNCHER_PROBE.format(
        launcher=str(REPO_ROOT / "bin" / "swarm-torch"))
    r = subprocess.run(
        [sys.executable, "-c", probe, "-d", "1", "-o", "out.txt", "-s",
         "stats.txt", "-u", "uclust.txt", "-i", "structure.txt", "-w",
         "seeds.fasta", "-l", "log.txt", "in.fasta"],
        cwd=tmp_path, capture_output=True, timeout=300,
        env={**os.environ, "SWARM_TORCH_DEVICE": "cpu",
             "SWARM_TPU_D1_NATIVE_MAX": "0", "SWARM_TPU_TIMING": "1",
             "PYTHONPATH": str(REPO_ROOT)})
    assert r.returncode == 0, r.stderr.decode()
    assert b"[timing] d1 join (cpu) start" in r.stderr
    for name in ("out.txt", "stats.txt", "uclust.txt", "structure.txt",
                 "seeds.fasta"):
        assert (tmp_path / name).stat().st_size > 0


def test_launcher_fastidious_device_graft_holds_no_jax(tmp_path):
    """-d 1 -f with the device graft forced (SWARM_TPU_GRAFT_PROBE_MAX=0):
    the graft engine runs (its [timing] lines show it) and imports
    nothing of the JAX side."""
    from cli_parity import graft_fasta

    (tmp_path / "in.fasta").write_text(graft_fasta())
    probe = LAUNCHER_PROBE.format(
        launcher=str(REPO_ROOT / "bin" / "swarm-torch"))
    r = subprocess.run(
        [sys.executable, "-c", probe, "-d", "1", "-f", "-o", "out.txt", "-l",
         "log.txt", "in.fasta"],
        cwd=tmp_path, capture_output=True, timeout=300,
        env={**os.environ, "SWARM_TORCH_DEVICE": "cpu",
             "SWARM_TPU_D1_NATIVE_MAX": "0", "SWARM_TPU_GRAFT_PROBE_MAX": "0",
             "SWARM_TPU_TIMING": "1", "PYTHONPATH": str(REPO_ROOT)})
    assert r.returncode == 0, r.stderr.decode()
    assert b"[timing] graft (cpu) verify" in r.stderr
    assert b"Made 0 grafts" not in (tmp_path / "log.txt").read_bytes()


@pytest.mark.parametrize("flags,engines", [
    (["-d", "1", "-f"], (b"d1 shards 3 (cpu)", b"graft shards 3 (cpu)")),
    (["-d", "2"], (b"d2 shards 3 (cpu)",))], ids=["d1f", "d2"])
def test_launcher_sharded_engines_hold_no_jax(tmp_path, flags, engines):
    """-d 1 -f and -d 2 (network engine) over 3 in-process shards: the
    sharded engines run (the [timing] lines of their spans show them,
    their gather among them) and import nothing of the JAX side; the
    run's last [timing] line counts every kernel's launches, none on the
    CPU."""
    from cli_parity import graft_fasta

    (tmp_path / "in.fasta").write_text(graft_fasta())
    probe = LAUNCHER_PROBE.format(
        launcher=str(REPO_ROOT / "bin" / "swarm-torch"))
    r = subprocess.run(
        [sys.executable, "-c", probe, *flags, "-o", "out.txt", "-l",
         "log.txt", "in.fasta"],
        cwd=tmp_path, capture_output=True, timeout=300,
        env={**os.environ, "SWARM_TORCH_DEVICE": "cpu",
             "SWARM_TORCH_SHARDS": "3", "SWARM_TPU_D2_ENGINE": "network",
             "SWARM_TPU_D2_TILE": "128", "SWARM_TPU_TIMING": "1",
             "PYTHONPATH": str(REPO_ROOT)})
    assert r.returncode == 0, r.stderr.decode()
    for engine in engines:
        assert b"[timing] " + engine + b" gather" in r.stderr
    launches = [ln for ln in r.stderr.decode().splitlines()
                if ln.startswith("[timing] launches ")]
    assert len(launches) == 1
    counts = json.loads(launches[0][len("[timing] launches "):])
    assert len(counts) == 14 and set(counts.values()) == {0}
    assert (tmp_path / "out.txt").stat().st_size > 0


#: runs the resident server in this interpreter until it is shut down,
#: then looks at what it imported
SERVER_PROBE = """import sys
from swarm_tpu_torch.server import serve
serve({sock!r})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "swarm_tpu", "bench"))
assert not bad, bad[:5]
assert "torch" in sys.modules
"""

#: a forwarded run of the launcher: the client imports neither torch
#: nor numpy
CLIENT_PROBE = """import runpy, sys
try:
    runpy.run_path({launcher!r}, run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("torch", "numpy", "jax", "swarm_tpu"))
assert not bad, bad[:5]
"""


def test_server_process_holds_no_jax_and_its_client_no_torch(tmp_path):
    """The server serves -d 2 (network engine), -d 1 (sort-join engine)
    and -d 1 -f (device graft) on the CPU, and ends with neither jax nor
    swarm_tpu in sys.modules; each forwarding client imports no torch."""
    import time

    (tmp_path / "in.fasta").write_text(
        amplicon_cloud(seed=72, n_centers=4, cloud_size=10, length=60))
    sock = tmp_path / "s.sock"
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT)}
    server = subprocess.Popen(
        [sys.executable, "-c", SERVER_PROBE.format(sock=str(sock))],
        stderr=subprocess.PIPE, env={
            **env, "SWARM_TORCH_DEVICE": "cpu",
            "SWARM_TPU_D2_ENGINE": "network", "SWARM_TPU_D2_TILE": "128",
            "SWARM_TPU_D1_NATIVE_MAX": "0", "SWARM_TPU_GRAFT_PROBE_MAX": "0"})
    try:
        deadline = time.time() + 120
        while not sock.exists():
            assert server.poll() is None and time.time() < deadline, \
                server.stderr.read().decode()
            time.sleep(0.05)
        probe = CLIENT_PROBE.format(
            launcher=str(REPO_ROOT / "bin" / "swarm-torch"))
        for flags in (["-d", "2"], ["-d", "1"], ["-d", "1", "-f"]):
            r = subprocess.run(
                [sys.executable, "-c", probe, *flags, "-o", "out.txt",
                 "in.fasta"], cwd=tmp_path, capture_output=True,
                timeout=300, env={**env, "SWARM_TORCH_SERVER": str(sock)})
            assert r.returncode == 0, r.stderr.decode()
            assert (tmp_path / "out.txt").stat().st_size > 0
        subprocess.run([sys.executable, "-m", "swarm_tpu_torch.server",
                        str(sock), "--shutdown"], env=env, timeout=60,
                       check=True)
        assert server.wait(timeout=60) == 0, server.stderr.read().decode()
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()


def test_server_module_imports_only_the_standard_library():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, swarm_tpu_torch.server\n"
         "bad = [m for m in ('torch', 'numpy', 'jax', 'swarm_tpu')\n"
         "       if m in sys.modules]\n"
         "assert not bad, bad"],
        capture_output=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO_ROOT)})
    assert r.returncode == 0, r.stderr.decode()


# ---- (c) the copies against the originals -------------------------------

def _read_db(package, path):
    db_mod = __import__(f"{package}.db", fromlist=["db_read"])
    params = __import__(f"{package}.params", fromlist=["Parameters"])
    progress = __import__(f"{package}.progress", fromlist=["Progress"])
    p = params.Parameters()
    p.input_filename = str(path)
    p.logfile = io.StringIO()
    return db_mod.db_read(p, progress.Progress(io.StringIO(), True))


@pytest.fixture(scope="module")
def both_dbs(tmp_path_factory):
    path = tmp_path_factory.mktemp("selfcontained") / "in.fasta"
    path.write_text(amplicon_cloud(
        seed=72, n_centers=8, cloud_size=20, length=80, max_edits=3))
    return _read_db("swarm_tpu", path), _read_db("swarm_tpu_torch", path)


def test_db_read_gives_the_same_arrays(both_dbs):
    want, got = both_dbs
    assert len(got) == len(want) > 100
    assert got.longest == want.longest
    for name in ("codes", "offsets", "lengths", "abundances"):
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert list(got.headers) == list(want.headers)


def _native_results(native, db):
    """A dict of arrays from the native wrappers the d=1 and d>=2 host
    paths call, on one database."""
    n = len(db)
    ab = np.ascontiguousarray(db.abundances, dtype=np.int64)
    lengths = np.ascontiguousarray(db.lengths, dtype=np.int64)
    out = {}
    out["pad_rows"] = native.pad_rows(
        db.codes, db.offsets, db.lengths, int(db.longest))
    profiles = native.qgram_profiles_arena(db.codes, db.offsets, db.lengths)
    out["qgram_profiles_arena"] = profiles
    out["qgram_profiles_native"] = native.qgram_profiles_native(
        out["pad_rows"], db.lengths)
    for no_break in (False, True):
        ef, et = native.d1_network(
            db.codes, db.offsets, db.lengths, ab, no_break, nthreads=1)
        out[f"d1_network_from_{no_break}"] = ef
        out[f"d1_network_to_{no_break}"] = et
    pa, pb = np.triu_indices(min(n, 60), k=1)
    diffs = native.d2_diffs_pairs(
        db.codes, db.offsets, db.lengths, db.abundances,
        pa.astype(np.int64), pb.astype(np.int64), 2, 18, 24, 13, False,
        nthreads=1)
    for i, arr in enumerate(diffs):
        out[f"d2_diffs_pairs_{i}"] = arr
    res = native.algo_cluster(
        profiles, db.codes, db.offsets, lengths, db.abundances, 2,
        18, 24, 13, 8, False, True)
    for key in ("order", "swarmid", "swarm_bound", "swarm_seed", "swarm_size",
                "struct_parent", "struct_child", "struct_diff", "struct_gen"):
        out[f"algo_cluster_{key}"] = np.asarray(res[key])
    order = np.arange(n, dtype=np.int64)
    diffest = np.zeros(n, dtype=np.int64)
    t_pos, t_ids, _ = native.d2_gen1_screen(
        profiles, order, ab, diffest, 1, 0, int(ab[0]), False, 2)
    out["d2_gen1_screen_pos"], out["d2_gen1_screen_ids"] = t_pos, t_ids
    out["d2_gen1_screen_diffest"] = diffest
    heavy = np.arange(0, n // 2, dtype=np.int64)
    light = np.arange(n // 2, n, dtype=np.int64)
    joined = native.graft_join(
        db.codes, db.offsets, db.lengths, n, heavy, light)
    out["graft_join_count"] = np.asarray(joined[0])
    out["graft_join_cand"] = np.asarray(joined[1])
    return out


def test_native_wrappers_give_the_same_arrays(both_dbs):
    from swarm_tpu import _native as jax_side
    from swarm_tpu_torch import _native as port_side

    assert jax_side.available() and port_side.available()
    want_db, got_db = both_dbs
    want = _native_results(jax_side, want_db)
    got = _native_results(port_side, got_db)
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    assert len(want["d1_network_from_False"]) > 0
    assert (want["d2_diffs_pairs_0"] >= 0).any() or len(
        want["d2_diffs_pairs_0"]) > 0


def test_native_library_is_the_ports_own():
    from swarm_tpu_torch import _native

    src = REPO_ROOT / "swarm_tpu_torch" / "_native" / "swarm_native.c"
    assert src.read_bytes() == (
        REPO_ROOT / "swarm_tpu" / "_native" / "swarm_native.c").read_bytes()
    so = _native.library_path()
    assert so.exists()
    assert so.parent == REPO_ROOT / "swarm_tpu_torch" / "_native_build"
    ignored = (REPO_ROOT / ".gitignore").read_text().splitlines()
    assert "swarm_tpu_torch/_native_build/" in ignored


@pytest.mark.parametrize("name", [
    "fatal", "params", "messages", "getopt_gnu", "progress", "metrics",
    "stdcxx_sort", "db", "ops/nw_scalar", "ops/qgram", "ops/search",
    "models/derep"])
def test_unchanged_host_layers_equal_their_originals(name):
    """These layers needed no change beyond their place in the package:
    the copy is the original, byte for byte. The two that also hold the
    run's record (metrics: its spans and counters; progress: each phase
    a span) write and count what the original does."""
    if name in RECORD_LAYERS:
        RECORD_LAYERS[name]()
        return
    assert (REPO_ROOT / "swarm_tpu_torch" / f"{name}.py").read_bytes() == (
        REPO_ROOT / "swarm_tpu" / f"{name}.py").read_bytes()


def _progress_writes(package, log_to_file):
    """What one package's Progress writes for a fixed sequence of
    phases: updates, both replays, a phase superseded without done()."""
    progress = __import__(f"{package}.progress", fromlist=["Progress"])
    out = io.StringIO()
    pr = progress.Progress(out, log_to_file)
    pr.init("Reading sequences: ", 1_000)
    for k in range(0, 1_000, 7):
        pr.update(k)
    pr.done()
    pr.init("Find qgram vects: ", 450)
    progress.replay_range(pr, 450)
    pr.done()
    pr.init("Collecting seeds:    ", 300)
    progress.replay_values(pr, np.arange(0, 300, 3))
    pr.init("Sorting seeds:    ", 5)
    pr.done()
    return out.getvalue()


def _progress_writes_the_originals():
    for log_to_file in (False, True):
        assert _progress_writes("swarm_tpu_torch", log_to_file) == \
            _progress_writes("swarm_tpu", log_to_file)


def _metrics_count_the_originals():
    counts = []
    for package in ("swarm_tpu", "swarm_tpu_torch"):
        metrics = __import__(f"{package}.metrics", fromlist=["record"])
        metrics.reset()
        metrics.record(d1_join_comparisons=5, graft_join_comparisons=2)
        metrics.record(d1_join_comparisons=np.int64(3), d2_host_batches=1)
        counts.append((dict(metrics.last_run), metrics.total_comparisons()))
        metrics.reset()
        assert metrics.last_run == {}
    assert counts[0] == counts[1] == (
        {"d1_join_comparisons": 8, "graft_join_comparisons": 2,
         "d2_host_batches": 1}, 10)


RECORD_LAYERS = {"progress": _progress_writes_the_originals,
                 "metrics": _metrics_count_the_originals}


def test_corpus_generators_equal_their_originals(tmp_path):
    import bench
    from swarm_tpu_torch import corpora
    from test_d2_diffs_jax import _chain_corpus

    for n, length in ((300, 60), (500, 150)):
        a, b = tmp_path / f"a{n}.fasta", tmp_path / f"b{n}.fasta"
        assert corpora.gen_corpus(a, n=n, length=length) == \
            bench.gen_corpus(b, n=n, length=length)
        assert a.read_bytes() == b.read_bytes()
    for seed, edits in ((1, 3), (7, 17)):
        assert corpora.chain_corpus(seed, 50, 48, edits) == \
            _chain_corpus(seed, 50, 48, edits)


def test_dense_cloud_corpus_feeds_the_aligner(tmp_path):
    """Every family's centre sees its whole cloud within 2 differences,
    and the hub its own: the lists the device engine hands over."""
    from swarm_tpu_torch import corpora
    from swarm_tpu_torch.ops.search import search_diffs

    path = tmp_path / "dense.fasta"
    n = corpora.dense_cloud_corpus(path, n_centers=2, cloud=40, length=60)
    assert n == 2 * (2 * 40 + 2)
    db = _read_db("swarm_tpu_torch", path)
    assert len(db) == n  # all records distinct
    # sorted by abundance: the two centres first, then the two hubs
    seqs = [db.sequence_codes(i) for i in range(n)]
    width = max(len(s) for s in seqs)
    rows = np.zeros((n, width), dtype=np.uint8)
    for i, s in enumerate(seqs):
        rows[i, : len(s)] = s
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    for centre in (0, 1):
        _, diffs, _ = search_diffs(
            seqs[centre], rows, lens, 18, 24, 13, 8)
        assert int((diffs <= 2).sum()) >= 40 + 2  # itself, hub, cloud


# ---- (d) the device choice ----------------------------------------------

def test_run_without_a_device_request_needs_cuda(tmp_path, monkeypatch):
    from swarm_tpu_torch.device import default_device
    from swarm_tpu_torch.main import run

    if torch.cuda.is_available():
        assert default_device() == torch.device("cuda", 0)
        return
    (tmp_path / "in.fasta").write_text(
        amplicon_cloud(seed=73, n_centers=2, cloud_size=5, length=40))
    monkeypatch.chdir(tmp_path)
    argv = ["-d", "2", "-o", "out.txt", "-l", "log.txt", "in.fasta"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(argv, "swarm")
    assert not (tmp_path / "out.txt").exists()
    assert run(argv, "swarm", device="cpu") == 0
    assert (tmp_path / "out.txt").stat().st_size > 0
    assert run(argv, "swarm", device=torch.device("cpu")) == 0


def test_launcher_without_a_device_request_fails_loudly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the launcher takes the card here")
    (tmp_path / "in.fasta").write_text(
        amplicon_cloud(seed=74, n_centers=2, cloud_size=5, length=40))
    env = {k: v for k, v in os.environ.items() if k != "SWARM_TORCH_DEVICE"}
    r = subprocess.run(
        [sys.executable, str(REPO_ROOT / "bin" / "swarm-torch"), "-d", "2",
         "-o", "out.txt", "-l", "log.txt", "in.fasta"],
        cwd=tmp_path, capture_output=True, timeout=300, env=env)
    assert r.returncode != 0
    assert b"no CUDA device" in r.stderr
    assert not (tmp_path / "out.txt").exists()
