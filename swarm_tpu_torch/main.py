"""Entry point: parse args, read database, dispatch on resolution d.

Counterpart of swarm_tpu/main.py (the reference main(),
src/swarm.cc:633-675), with the same CLI and output streams:

- d = 0: models/derep.py (host);
- d = 1: models/d1.py, whose network comes from the torch sort-join
  engine on the device from ops/neighbors.py's NATIVE_MAX amplicons up
  in a process that already holds the card (4,096: the resident
  server, a run after another), from NATIVE_MAX_GRAFT in a fresh -f
  run, whose graft takes the card anyway (65,536), from NATIVE_MAX_COLD
  in another fresh run (262,144), and from the native C code below, and
  the native BFS;
- d >= 2: models/general.py, whose network engine runs on the torch
  device from NETWORK_MIN amplicons up (4,096; NETWORK_MIN_COLD,
  16,384, in a fresh process) and its device engine when asked for,
  the native C engine otherwise.

The run uses the first CUDA device and raises when there is none; the
CPU is used only when the caller passes ``device`` (in process) or sets
SWARM_TORCH_DEVICE=cpu (the launcher).

Shards (swarm_tpu_torch/parallel): SWARM_TORCH_SHARDS=k splits the
d=1 network, -f's graft and the d>=2 screen over k shards in this
process. Under the rank variables (SWARM_TPU_COORDINATOR,
SWARM_TPU_NUM_PROCESSES, SWARM_TPU_PROCESS_ID) every rank runs the same
argv on the same input: the run joins the process group first, takes
cuda:(rank % device_count), and only rank 0 writes; the other ranks'
outputs and log go to os.devnull.

Each run keeps a record (metrics.py), started anew when the run starts
and readable in process after it: its spans (each progress phase, and
the d>=2 network engine's and writers' steps: `d2_network.build` and
its children `d2_network.screen`, `.to_host`, `.diffs`, `.csr`, then
`general.cluster_graph` and `general.write_*`), each with its name,
start and end (time.perf_counter), parent and the run's id, and its
counters (`metrics.last_run`). SWARM_TPU_TRACE=FILE, read when the run
ends, writes the record there as a chrome trace: one "X" event a span,
the run id and parent in its "args", the counters under "counters".
While a torch.profiler is active, every span is also a
record_function range of its name in the profiler's trace.

SWARM_TPU_PROFILE_DIR records a torch.profiler trace of the run
(trace.json in that directory; it holds the spans as ranges);
SWARM_TPU_TIMING=1 prints per-phase wall times and, at the end of the
run, one `[timing] launches {...}` line: each kernel's launches in this
process, as JSON.
"""

import contextlib
import os
import sys

from . import metrics
from .cli import (
    args_check,
    args_init,
    args_show,
    close_files,
    open_files,
)
from .db import db_read
from .device import default_device
from .fatal import FatalError
from .messages import HEADER_MESSAGE
from .params import Parameters, set_alignment_scoring_system
from .progress import Progress


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


def run(argv, progname: str, device=None) -> int:
    """One CLI run. `device`: a torch device (or its name) for the
    device engines; None takes cuda:0 and raises without one."""
    import torch

    p = Parameters()
    p.logfile = sys.stderr
    used_options = args_init(argv, progname, p)
    set_alignment_scoring_system(p)
    args_check(used_options, p)
    # after the options (help, version and option errors need no card),
    # before any output file is opened
    device = default_device() if device is None else torch.device(device)
    from .parallel import distributed

    rank = distributed.maybe_initialize(device)
    try:
        if distributed.env_config() is not None:
            device = distributed.rank_device(device, rank)
            if not distributed.is_primary():
                _quiet(p)
        return _run(p, device)
    finally:
        distributed.finalize()


def _quiet(p: Parameters) -> None:
    """A rank other than 0: every output, and the log, to os.devnull."""
    p.opt_output_file = p.opt_log = os.devnull
    for name in ("opt_network_file", "opt_internal_structure", "opt_seeds",
                 "opt_statistics_file", "opt_uclust_file"):
        if getattr(p, name):
            setattr(p, name, os.devnull)


def _run(p: Parameters, device) -> int:
    metrics.reset()
    open_files(p)
    p.logfile.write(HEADER_MESSAGE)
    args_show(p, p.logfile)

    progress = Progress(p.logfile, bool(p.opt_log))

    with _profiled(os.environ.get("SWARM_TPU_PROFILE_DIR")):
        db = db_read(p, progress)

        if p.opt_differences == 0:
            from .models.derep import dereplicate

            dereplicate(p, db, progress)
        elif p.opt_differences == 1:
            from .models.d1 import algo_d1_run

            algo_d1_run(p, db, progress, device)
        else:
            from .models.general import algo_run

            algo_run(p, db, progress, device)

    close_files(p)
    metrics.dump()
    if os.environ.get("SWARM_TPU_TIMING"):
        _report_launches()
    return 0


def launch_counts() -> dict:
    """Each kernel wrapper's launches in this process so far (a run in a
    new process, such as a rank's, counts from 0)."""
    from .ops import (d2_diffs, d2_network, fastidious_torch,
                      neighbors_sortjoin, nw_scores)

    return {"d2_diffs": d2_diffs.launches, **d2_network.launches,
            **nw_scores.launches, **neighbors_sortjoin.launches,
            **fastidious_torch.launches}


def _report_launches() -> None:
    """`[timing] launches {...}`: launch_counts() as JSON."""
    import json

    sys.__stderr__.write(f"[timing] launches {json.dumps(launch_counts())}\n")


def main() -> int:
    progname = sys.argv[0]
    try:
        return run(sys.argv[1:], progname,
                   device=os.environ.get("SWARM_TORCH_DEVICE") or None)
    except FatalError:
        return 1
    except BrokenPipeError:
        os._exit(1)


if __name__ == "__main__":
    sys.exit(main())
