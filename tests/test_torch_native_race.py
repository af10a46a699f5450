"""swarm_tpu's native library, loaded in every test worker.

swarm_tpu/_native compiles libswarm_native.so in place when its tag
(source hash, machine and host name) does not match, and writes the tag
after. Under several xdist workers on a fresh machine each worker may
compile at once, and a worker whose ctypes.CDLL meets a library another
worker is still writing keeps `lib = None` for the rest of its life:
swarm_tpu's callers that need the library then fail (AttributeError on
None) and those that test `_native.available()` quietly take their
Python paths. swarm_tpu stays as it is, so the repair is here: every
worker collects every test file, and collecting this one runs
ensure_jax_native(), which, when `lib` is None (and SWARM_TPU_NATIVE is
not 0), waits under a file lock until no build is in flight (the tag
matches and is not older than the library) and reloads the module,
retrying for a bounded time. The wrappers read the module global `lib`
and the callers call `_native.available()` when they run, so the reload
repairs every caller in that worker. If the library still cannot be
loaded, the tests that need it fail as before: nothing is skipped.
"""

import fcntl
import importlib
import os
import threading
import time
import types
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
#: shared by the workers of a run; in a git-ignored build directory
LOCK = REPO_ROOT / "swarm_tpu_torch" / "_native_build" / "jax_native.lock"


def _build_settled(native) -> bool:
    """The library exists, its tag matches this source and host, and no
    build started after the tag was written."""
    try:
        return (native._TAG.read_text() == native._build_tag()
                and native._TAG.stat().st_mtime_ns
                >= native._SO.stat().st_mtime_ns)
    except OSError:
        return False


def ensure_jax_native(native=None, reload=importlib.reload, timeout=180.0,
                      poll=0.1, lock=LOCK):
    """swarm_tpu._native with its library loaded where it can be: returns
    the module (reloaded when its `lib` was None)."""
    if os.environ.get("SWARM_TPU_NATIVE", "1") == "0":
        return native
    if native is None:
        import swarm_tpu._native as native
    if native.lib is not None:
        return native
    lock.parent.mkdir(parents=True, exist_ok=True)
    deadline = time.monotonic() + timeout
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            while native.lib is None and time.monotonic() < deadline:
                if _build_settled(native):
                    try:
                        native = reload(native)
                    except OSError:  # a library being written: retry
                        pass
                if native.lib is None:
                    time.sleep(poll)
            if native.lib is None:  # last try: builds if it must
                try:
                    native = reload(native)
                except OSError:
                    pass
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return native


ensure_jax_native()


def fake_native(tmp_path, tag="src:x86_64:host"):
    """A stand-in for swarm_tpu._native: its library, tag and build tag
    in tmp_path, no library loaded."""
    return types.SimpleNamespace(
        lib=None, _SO=tmp_path / "lib.so", _TAG=tmp_path / "lib.tag",
        _build_tag=lambda: tag)


class Loader:
    """A reload that loads when the build has settled, and fails its
    first `fail` calls as a library being written does."""

    def __init__(self, fail=0, raises=False):
        self.calls = []
        self.fail = fail
        self.raises = raises

    def __call__(self, native):
        self.calls.append(time.monotonic())
        if len(self.calls) <= self.fail:
            if self.raises:
                raise OSError("file too short")
            return native
        if _build_settled(native):
            native.lib = "loaded"
        return native


def test_jax_native_library_is_loaded_in_this_worker():
    import swarm_tpu._native as native

    if os.environ.get("SWARM_TPU_NATIVE", "1") == "0":
        pytest.skip("SWARM_TPU_NATIVE=0 asks for no library")
    assert native.lib is not None
    assert native.available()
    assert _build_settled(native)


def test_guard_leaves_a_loaded_library_alone(tmp_path):
    native = fake_native(tmp_path)
    native.lib = "loaded"
    loader = Loader()
    assert ensure_jax_native(native, loader, lock=tmp_path / "l") is native
    assert loader.calls == []


def test_guard_waits_for_the_build_in_flight(tmp_path):
    """No reload before the tag of the build in flight is written; then
    one reload loads the library."""
    native = fake_native(tmp_path)
    native._SO.write_bytes(b"half")
    written = []

    def build():
        time.sleep(0.4)
        native._SO.write_bytes(b"whole library")
        written.append(time.monotonic())
        native._TAG.write_text(native._build_tag())

    thread = threading.Thread(target=build)
    thread.start()
    loader = Loader()
    got = ensure_jax_native(native, loader, timeout=30, poll=0.02,
                            lock=tmp_path / "l")
    thread.join()
    assert got.lib == "loaded"
    assert len(loader.calls) == 1 and loader.calls[0] >= written[0]


@pytest.mark.parametrize("raises", [False, True],
                         ids=["lib-left-none", "oserror"])
def test_guard_retries_a_library_being_written(tmp_path, raises):
    native = fake_native(tmp_path)
    native._SO.write_bytes(b"lib")
    native._TAG.write_text(native._build_tag())
    loader = Loader(fail=2, raises=raises)
    got = ensure_jax_native(native, loader, timeout=30, poll=0.01,
                            lock=tmp_path / "l")
    assert got.lib == "loaded" and len(loader.calls) == 3


def test_guard_does_not_load_a_library_older_than_a_build(tmp_path):
    """A tag older than the library means a build started after it was
    written: wait for it."""
    native = fake_native(tmp_path)
    native._TAG.write_text(native._build_tag())
    native._SO.write_bytes(b"being written")
    old = native._SO.stat().st_mtime_ns - 10**9
    os.utime(native._TAG, ns=(old, old))
    assert not _build_settled(native)
    loader = Loader()
    got = ensure_jax_native(native, loader, timeout=0.3, poll=0.01,
                            lock=tmp_path / "l")
    assert got.lib is None and len(loader.calls) == 1  # the last try only


def test_guard_gives_up_after_its_deadline(tmp_path):
    """No library ever: one last reload (which would build), then `lib`
    stays None and the tests that need it fail as before."""
    native = fake_native(tmp_path)
    loader = Loader()
    t0 = time.monotonic()
    got = ensure_jax_native(native, loader, timeout=0.3, poll=0.01,
                            lock=tmp_path / "l")
    assert got.lib is None and len(loader.calls) == 1
    assert time.monotonic() - t0 >= 0.3


def test_guard_reads_swarm_tpu_native(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_TPU_NATIVE", "0")
    native = fake_native(tmp_path)
    loader = Loader()
    assert ensure_jax_native(native, loader, lock=tmp_path / "l") is native
    assert native.lib is None and loader.calls == []


def test_guard_serialises_the_workers(tmp_path):
    """Two guards at once reload one after the other, under the lock."""
    natives = [fake_native(tmp_path) for _ in range(2)]
    natives[0]._SO.write_bytes(b"lib")
    natives[0]._TAG.write_text(natives[0]._build_tag())
    spans = []

    def slow_reload(native):
        t0 = time.monotonic()
        time.sleep(0.2)
        native.lib = "loaded"
        spans.append((t0, time.monotonic()))
        return native

    threads = [threading.Thread(target=ensure_jax_native, args=(
        native, slow_reload), kwargs={"lock": tmp_path / "l"})
        for native in natives]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(n.lib == "loaded" for n in natives)
    (a0, a1), (b0, b1) = sorted(spans)
    assert b0 >= a1
