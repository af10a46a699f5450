"""Progress reporting (reference: src/utils/progress.cc).

Two modes, chosen by whether -l redirects logging to a file:
 - stderr mode: "<prompt> 0%" at init, "  \\r<prompt> NN%" at milestones
   (200 steps), "  \\r<prompt> 100%\\n" when done;
 - logfile mode: "<prompt>" at init, " 100%\\n" when done (no updates).

Each phase, from its init to its done() or to the next init, is a span
of the run's record (metrics.py), named by its prompt.
"""

import os
import sys
import time

from . import metrics

GRANULARITY = 200

_TIMING = bool(os.environ.get("SWARM_TPU_TIMING"))


class Progress:
    def __init__(self, logfile, log_to_file: bool):
        self.logfile = logfile
        self.log_to_file = log_to_file
        self.prompt = ""
        self.size = 0
        self.chunk = 1
        self.next = 1
        self._t0 = 0.0
        self._span = None

    _last_done = 0.0

    def init(self, prompt: str, size: int) -> None:
        self.prompt = prompt
        self.size = size
        self.chunk = 1 if size < GRANULARITY else size // GRANULARITY
        self.next = 1
        # a phase without done() (swarm's collect_seeds) ends here
        if self._span is not None:
            metrics.end(self._span)
        self._span = metrics.begin(prompt.strip())
        if _TIMING:
            self._t0 = time.perf_counter()
            if Progress._last_done:
                gap = self._t0 - Progress._last_done
                if gap > 0.05:
                    sys.__stderr__.write(
                        f"[timing]   (gap before {prompt.strip()}) "
                        f"{gap:8.3f}s\n"
                    )
        if self.log_to_file:
            self.logfile.write(prompt)
        else:
            self.logfile.write(f"{prompt} 0%")

    def update(self, progress: int) -> None:
        if self.log_to_file:
            return
        if progress < self.next:
            return
        pct = 100.0 * progress / self.size if self.size else 100.0
        self.logfile.write(f"  \r{self.prompt} {pct:.0f}%")
        self.next = progress + self.chunk
        self.logfile.flush()

    def done(self) -> None:
        if self.log_to_file:
            self.logfile.write(" 100%\n")
        else:
            self.logfile.write(f"  \r{self.prompt} 100%\n")
        self.logfile.flush()
        if self._span is not None:
            metrics.end(self._span)
            self._span = None
        if _TIMING:
            Progress._last_done = time.perf_counter()
            sys.__stderr__.write(
                f"[timing] {self.prompt.strip():<40} "
                f"{Progress._last_done - self._t0:8.3f}s\n"
            )


def replay_range(progress: Progress, total: int) -> None:
    """Emit exactly the writes of `for k in range(total): update(k)`
    without the O(total) Python loop (used by the native fast paths)."""
    if progress.log_to_file or total <= 0:
        return
    k = progress.next
    while k < total:
        progress.update(k)
        k = progress.next


def replay_values(progress: Progress, values) -> None:
    """Emit exactly the writes of `for v in values: update(v)` for a
    non-decreasing value sequence (e.g. file positions)."""
    import numpy as np

    if progress.log_to_file or len(values) == 0:
        return
    values = np.asarray(values)
    n = len(values)
    j = 0
    while True:
        j = int(np.searchsorted(values, progress.next, side="left"))
        if j >= n:
            break
        progress.update(int(values[j]))
