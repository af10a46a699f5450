"""Resident server: a warm swarm_tpu_torch process serving CLI requests.

Counterpart of swarm_tpu/server.py, with the same protocol. A cold run
of the port pays the interpreter, the `torch` import, the CUDA context
and the loading of the kernel and native libraries before its engines
start; the server pays them once, and each forwarded request then costs
only the run itself. What stays warm across requests: the imports, the
CUDA context, the kernel library (swarm_tpu_torch/_build.py), the native
library, and the database cache (db.py, _DB_CACHE: an unchanged input
file is not parsed again).

Protocol (one request per connection, newline-framed JSON over a unix
socket):

  client -> server   {"argv": [...], "cwd": "...", "progname": "...",
                      "stdin_b64": "..."}   or {"op": "ping"|"shutdown"}
  server -> client   {"s": 1, "d": "<b64>"}   stdout chunk
                     {"s": 2, "d": "<b64>"}   stderr chunk
                     {"rc": N}                done

server:  python -m swarm_tpu_torch.server SOCK        (serve)
         python -m swarm_tpu_torch.server SOCK --shutdown
client:  SWARM_TORCH_SERVER=SOCK bin/swarm-torch [OPTIONS] [FASTAFILE]
         (bin/swarm-torch forwards when the variable names a socket that
         accepts a connection, and runs in-process otherwise; it never
         reads SWARM_TPU_SERVER, which names a swarm_tpu server)

The device is chosen once, when the server starts: SWARM_TORCH_DEVICE
if set (the CPU tests set "cpu"), else the first CUDA device, and the
server refuses to start without one. On the card it creates the CUDA
context and loads the kernel and native libraries before it listens.

A request runs in the server's environment, not the client's: variables
such as SWARM_TPU_D2_ENGINE, SWARM_TPU_D1_NATIVE_MAX, SWARM_TPU_TIMING,
SWARM_TPU_DB_CACHE or SWARM_TORCH_SHARDS (in-process shards) take the
values the server was started with. A rank run (SWARM_TPU_COORDINATOR
set) does not go through a server: the server refuses to start under
the rank variables, and bin/swarm-torch does not forward under them.
Output files named in argv are written by the server (paths resolved
against the client's cwd); only stdout and stderr travel over the
socket, byte for byte. Outputs sent to '-' share one stream in the
server (cli.open_files: there is no file descriptor to duplicate), so
where several are sent there at once their interleaving on stdout may
differ from a direct run's, as with swarm_tpu's server. `[timing]`
lines go to the server's own stderr.
A failed request is reported as swarm_tpu's server reports it (the
traceback on the request's stderr, rc 70) and the server goes on.

This module imports only the standard library when it is imported, so
the client's forwarding path stays free of torch; the server side
imports torch and the package inside serve() and _handle().
"""

import base64
import io
import json
import os
import socket
import sys

__all__ = ["serve", "forward", "shutdown", "main"]


class _FrameRaw(io.RawIOBase):
    """Binary stream that frames every write as a JSON line."""

    def __init__(self, wfile, stream_id):
        self._wfile = wfile
        self._sid = stream_id

    def writable(self):
        return True

    def write(self, b):
        b = bytes(b)
        if b:
            self._wfile.write(
                (json.dumps({"s": self._sid,
                             "d": base64.b64encode(b).decode()})
                 + "\n").encode())
            self._wfile.flush()
        return len(b)


class _TextShim:
    """Text-stream stand-in for sys.stdout/sys.stderr whose .buffer is a
    framed socket stream; cli.make_stdout/make_stderr wrap .buffer in
    their own latin-1 TextIOWrapper, so every byte the CLI writes
    reaches the client as it is."""

    def __init__(self, buffer):
        self.buffer = buffer
        self.encoding = "latin-1"
        self.closed = False

    def write(self, s):
        self.buffer.write(s.encode("latin-1", "replace"))
        return len(s)

    def flush(self):
        pass

    def isatty(self):
        return False

    def fileno(self):
        raise io.UnsupportedOperation("fileno")


class _StdinShim:
    def __init__(self, payload: bytes):
        self.buffer = io.BytesIO(payload)
        self.encoding = "latin-1"

    def read(self, *a):
        return self.buffer.read(*a).decode("latin-1")


def _exit_code(exc: SystemExit) -> int:
    """The rc of a run that raised SystemExit (FatalError is one, rc 1;
    --help and --version raise SystemExit(0))."""
    if exc.code is None:
        return 0
    return exc.code if isinstance(exc.code, int) else 1


def _handle(conn, device) -> bool:
    """Serve one connection; True when it asked the server to stop."""
    from .main import run

    rfile = conn.makefile("rb")
    wfile = conn.makefile("wb")
    line = rfile.readline()
    if not line:
        return False
    req = json.loads(line)
    if req.get("op") in ("shutdown", "ping"):
        wfile.write(b'{"rc": 0}\n')
        wfile.flush()
        return req["op"] == "shutdown"

    payload = base64.b64decode(req.get("stdin_b64", ""))
    out_shim = _TextShim(_FrameRaw(wfile, 1))
    err_shim = _TextShim(_FrameRaw(wfile, 2))
    old = (sys.stdout, sys.stderr, sys.stdin, os.getcwd())
    rc = 0
    try:
        sys.stdout, sys.stderr = out_shim, err_shim
        sys.stdin = _StdinShim(payload)
        if req.get("cwd"):
            os.chdir(req["cwd"])
        try:
            rc = run(req["argv"], req.get("progname", "swarm"),
                     device=device)
        except SystemExit as exc:
            rc = _exit_code(exc)
    except BrokenPipeError:
        return False
    except Exception:  # report, keep serving
        import traceback

        try:
            err_shim.write(traceback.format_exc())
        except Exception:
            pass
        rc = 70
    finally:
        sys.stdout, sys.stderr, sys.stdin = old[:3]
        try:
            os.chdir(old[3])
        except OSError:
            pass
    try:
        wfile.write(json.dumps({"rc": rc}).encode() + b"\n")
        wfile.flush()
    except BrokenPipeError:
        pass
    return False


def server_device():
    """The device every request runs on: SWARM_TORCH_DEVICE if set,
    else the first CUDA device (device.default_device raises without
    one). The package's modules and the native library (built or loaded
    when _native is imported) are loaded here and, on the card, the CUDA
    context and the kernel library, before the first request."""
    import torch

    from . import _native  # noqa: F401  (loads the native library)
    from . import main  # noqa: F401
    from .device import default_device
    from .models import d1, derep, general  # noqa: F401

    if os.environ.get("SWARM_TPU_COORDINATOR"):
        raise RuntimeError("a rank run does not go through the server: "
                           "unset SWARM_TPU_COORDINATOR")
    name = os.environ.get("SWARM_TORCH_DEVICE")
    device = torch.device(name) if name else default_device()
    if device.type == "cuda":
        from . import _build

        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        _build.load()
    return device


def serve(sock_path: str) -> None:
    """Warm up, then accept requests until a shutdown request arrives.
    The socket exists only once the server is ready."""
    device = server_device()
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    os.chmod(sock_path, 0o700)
    srv.listen(8)
    try:
        while True:
            conn, _ = srv.accept()
            try:
                if _handle(conn, device):
                    break
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
    finally:
        srv.close()
        try:
            os.unlink(sock_path)
        except OSError:
            pass


def forward(sock_path: str, argv, progname: str = "swarm",
            conn=None) -> int:
    """Run argv on the resident server; returns the exit code.
    Raises OSError when no server is listening (a caller that wants to
    run in-process then connects first and passes `conn`)."""
    if conn is None:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.connect(sock_path)
    stdin_b64 = ""
    # stdin is read when the input is '-' or absent (a wrong guess only
    # forwards unused bytes or reads an empty pipe)
    reads_stdin = "-" in argv or not _has_input_file(argv)
    if reads_stdin and not sys.stdin.isatty():
        stdin_b64 = base64.b64encode(sys.stdin.buffer.read()).decode()
    req = {"argv": list(argv), "cwd": os.getcwd(), "progname": progname,
           "stdin_b64": stdin_b64}
    wfile = conn.makefile("wb")
    rfile = conn.makefile("rb")
    wfile.write(json.dumps(req).encode() + b"\n")
    wfile.flush()
    out = getattr(sys.stdout, "buffer", sys.stdout)
    err = getattr(sys.stderr, "buffer", sys.stderr)
    rc = 70
    for line in rfile:
        msg = json.loads(line)
        if "rc" in msg:
            rc = msg["rc"]
            break
        stream = out if msg["s"] == 1 else err
        stream.write(base64.b64decode(msg["d"]))
        stream.flush()
    conn.close()
    return rc


#: short options that take a value (cli.py's SHORT_OPTIONS); used only
#: to guess whether a positional input file is present
_VALUE_OPTS = set("abcdegijlmopstuwy")
#: long options that take their value as the next argument
_VALUE_LONG = frozenset((
    "append-abundance", "bloom-bits", "boundary", "ceiling", "differences",
    "gap-extension-penalty", "gap-opening-penalty", "internal-structure",
    "log", "match-reward", "mismatch-penalty", "network-file",
    "output-file", "seeds", "statistics-file", "threads", "uclust-file"))


def _has_input_file(argv) -> bool:
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "-":
            return True
        if a.startswith("--"):
            skip = "=" not in a and a[2:] in _VALUE_LONG
            continue
        if a.startswith("-") and len(a) >= 2:
            # a short-option cluster: its first value-taking option takes
            # the rest of the token or, at its end, the next token
            for k, ch in enumerate(a[1:], start=1):
                if ch in _VALUE_OPTS:
                    skip = k == len(a) - 1
                    break
            continue
        return True
    return False


def shutdown(sock_path: str) -> None:
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(sock_path)
    wfile = conn.makefile("wb")
    wfile.write(b'{"op": "shutdown"}\n')
    wfile.flush()
    conn.makefile("rb").readline()
    conn.close()


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] in ("-h", "--help"):
        sys.stderr.write("usage: python -m swarm_tpu_torch.server "
                         "SOCKET_PATH [--shutdown]\n")
        return 0 if args else 1
    if len(args) > 1 and args[1] == "--shutdown":
        shutdown(args[0])
        return 0
    serve(args[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
