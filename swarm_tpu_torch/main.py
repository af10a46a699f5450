"""Entry point: parse args, read database, dispatch on resolution d.

Counterpart of swarm_tpu/main.py (the reference main(),
src/swarm.cc:633-675), with the same CLI and output streams:

- d = 0: swarm_tpu's dereplication, unchanged;
- d = 1: swarm_tpu's d=1 clustering on its host backend (the native C
  network construction and BFS); the torch sort-join engine is not
  ported yet;
- d >= 2: models/general.py, whose network engine runs on the torch
  device.

SWARM_TPU_PROFILE_DIR records a torch.profiler trace of the run
(trace.json in that directory); SWARM_TPU_TIMING=1 prints per-phase
wall times.
"""

import contextlib
import os
import sys

from swarm_tpu.cli import (
    args_check,
    args_init,
    args_show,
    close_files,
    open_files,
)
from swarm_tpu.db import db_read
from swarm_tpu.fatal import FatalError
from swarm_tpu.messages import HEADER_MESSAGE
from swarm_tpu.params import Parameters, set_alignment_scoring_system
from swarm_tpu.progress import Progress, trace_dump

from .device import default_device


@contextlib.contextmanager
def _host_d1_backend():
    """swarm_tpu's d=1 clustering picks its network engine from
    SWARM_TPU_BACKEND; "numpy" selects the native host code, which
    imports no JAX. Temporary: the variable is process-wide, so another
    thread sees it during the call; the port's own d=1 clustering will take
    its engine as an argument instead."""
    old = os.environ.get("SWARM_TPU_BACKEND")
    os.environ["SWARM_TPU_BACKEND"] = "numpy"
    try:
        yield
    finally:
        if old is None:
            del os.environ["SWARM_TPU_BACKEND"]
        else:
            os.environ["SWARM_TPU_BACKEND"] = old


@contextlib.contextmanager
def _profiled(profile_dir):
    if not profile_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def run(argv, progname: str) -> int:
    p = Parameters()
    p.logfile = sys.stderr
    used_options = args_init(argv, progname, p)
    set_alignment_scoring_system(p)
    args_check(used_options, p)
    open_files(p)
    p.logfile.write(HEADER_MESSAGE)
    args_show(p, p.logfile)

    progress = Progress(p.logfile, bool(p.opt_log))

    with _profiled(os.environ.get("SWARM_TPU_PROFILE_DIR")):
        db = db_read(p, progress)

        if p.opt_differences == 0:
            from swarm_tpu.models.derep import dereplicate

            dereplicate(p, db, progress)
        elif p.opt_differences == 1:
            from swarm_tpu.models.d1 import algo_d1_run

            with _host_d1_backend():
                algo_d1_run(p, db, progress)
        else:
            from .models.general import algo_run

            algo_run(p, db, progress, default_device())

    close_files(p)
    trace_dump()
    return 0


def main() -> int:
    progname = sys.argv[0]
    try:
        return run(sys.argv[1:], progname)
    except FatalError:
        return 1
    except BrokenPipeError:
        os._exit(1)


if __name__ == "__main__":
    sys.exit(main())
