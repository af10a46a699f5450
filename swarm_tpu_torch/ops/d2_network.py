"""Bulk d>=2 candidate discovery and exact edges on one torch device.

Counterpart of swarm_tpu/ops/d2_network.py (D2NetworkEngine, single
device). The screen is that module's: a pair of amplicons survives when
the Hamming distance of their 1024-bit qgram parity profiles is at most
10d and their lengths differ by at most d (JAX writes the first as an
int8 product of +-1 vectors, dot = 1024 - 2 * hamming >= 1024 - 20d).
Both are sound lower bounds; the exact diffs (ops/d2_diffs.py or the
native kernel) reject the rest.

Tile pairs (I <= J) of T profiles are screened in chunks of
SWARM_TPU_D2_CHUNK steps (512, as in JAX), in two passes:

- ``screen_words``: each step's survivors bit-packed into T*T/32 words
  by flat position r*T + c, least significant bit first (JAX's
  qgram_screen_words), and a survivor count for each row of each step;
- ``extract_pairs``: an exclusive scan of the counts, one readback of
  the chunk's total, and the pairs in (step, row, column) order (JAX's
  extract_pairs), int32.

On a CUDA tensor each wrapper launches its kernel (csrc/d2_screen.cu:
the screen's dot as int8 products of the +-1 profiles on the tensor
cores, expanded from the packed bits on chip, with the masks in the
epilogue; the extraction reading only the rows that hold survivors) or
raises; on a CPU tensor it runs its plain version
(``screen_words_reference``, ``extract_pairs_reference``), which unpacks
the profiles to +-1 int8 only where it needs them.

The directed CSR is a stable partition of the accepted diff tasks by
source (``csr_partition``), made where the tasks lie: on the engine's
device where the exact diffs ran there (csrc/d2_csr.cu on a CUDA
device), then read back once; on the host, by its plain version
``csr_partition_reference``, where the native host diffs ran.

The exact diffs' directed tasks are laid out where the pairs lie
(``d2_tasks``): on a CUDA device by csrc/d2_tasks.cu, from the screen's
pairs, which never leave the card on that route; on the CPU by its plain
version ``tasks_reference``. The native host diffs take the pairs to the
host (``pairs_to_host``) and lay their tasks out there
(d2_diffs.task_layout), in the same order.

``D2NetworkEngine.build_adjacency`` is the run's span ``d2_network.build``
(metrics.py), its steps the spans ``d2_network.screen`` (the chunk loop),
``.to_host`` (the pairs' concatenation on the engine's device; the name
is the one a benchmark reader reads), ``.diffs`` (the route's choice;
the tasks laid out on the device and the exact diffs there, or the
pairs' copy to the host and the native diffs) and ``.csr`` (the CSR: the
partition, its check and, from the device, the readback); it counts the
directed alignments the exact diffs run (``d2_network.alignments``), of
those the tasks laid out by d2_tasks (``d2_network.device_tasks``, 0
where the native host diffs ran), the edges they accept
(``d2_network.edges``) and of those the edges partitioned on the
engine's device (``d2_network.csr_device_edges``, 0 where the native
host diffs ran). No step synchronises the device before the tasks'
readback of their count.
"""

import os

import numpy as np
import torch

from .. import metrics

PROFILE_BYTES = 128  # 1024-bit qgram parity vector
PROFILE_BITS = 1024

#: kernel launches made by the wrappers (CUDA tensors only)
launches = {"d2_screen": 0, "d2_extract": 0, "d2_csr": 0, "d2_tasks": 0}
#: the CSR partition's passes take at most this many bits of the source
CSR_DIGIT_BITS = 8


def _unpack_pm1(prof_bytes):
    """[n, 128] uint8 -> [n, 1024] int8 in {+1, -1} (bit set -> -1)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=prof_bytes.device)
    bits = (prof_bytes[:, :, None] >> shifts) & 1
    return (1 - 2 * bits.to(torch.int8)).reshape(-1, PROFILE_BITS)


def _as_int32_words(values):
    """int64 values in [0, 2^32) -> int32 tensors of the same bits."""
    return torch.where(values >= 1 << 31, values - (1 << 32),
                       values).to(torch.int32)


def screen_words_reference(prof, lengths, tis, tjs, T, n, d):
    """JAX's qgram_screen_words: [C, T*T/32] words (uint32 bit patterns
    held as int32), a step's survivor at flat position r*T + c in word
    (r*T + c) // 32, bit (r*T + c) % 32.

    prof: [n_pad, 128] uint8 profiles (rows n..n_pad zero); lengths:
    [n_pad] int32; tis/tjs: [C] tile indices of the steps."""
    dev = prof.device
    dot_min = PROFILE_BITS - 20 * d
    powers = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    idx = torch.arange(T, device=dev)
    words = torch.empty((len(tis), T * T // 32), dtype=torch.int32,
                        device=dev)
    for k, (ti, tj) in enumerate(zip(tis.tolist(), tjs.tolist())):
        a = _unpack_pm1(prof[ti * T:(ti + 1) * T])
        b = _unpack_pm1(prof[tj * T:(tj + 1) * T])
        dot = torch._int_mm(a, b.t())  # [T, T] int32
        la = lengths[ti * T:(ti + 1) * T]
        lb = lengths[tj * T:(tj + 1) * T]
        gi = ti * T + idx
        gj = tj * T + idx
        mask = ((dot >= dot_min) & (gi[:, None] < gj[None, :])
                & (gj < n)[None, :]
                & ((la[:, None] - lb[None, :]).abs() <= d))
        words[k] = _as_int32_words(
            (mask.reshape(-1, 32).to(torch.int64) * powers).sum(1))
    return words


def _word_bits(words):
    """[..., W] int32 words -> [..., W, 32] bool, bit j at index j."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    return ((words.to(torch.int64)[..., None] >> shifts) & 1).bool()


def row_counts_reference(words, T):
    """Survivors of each row of each step: [C * T] int32."""
    counts = [_word_bits(step).reshape(T, T).sum(1) for step in words]
    if not counts:
        return torch.zeros(0, dtype=torch.int32, device=words.device)
    return torch.cat(counts).to(torch.int32)


def extract_pairs_reference(words, tis, tjs, T):
    """JAX's extract_pairs without its caps: (ga, gb) int32, every
    survivor of `words` in (step, row, column) order."""
    ga, gb = [], []
    for k, (ti, tj) in enumerate(zip(tis.tolist(), tjs.tolist())):
        flat = torch.nonzero(_word_bits(words[k]).reshape(-1)).squeeze(1)
        ga.append(ti * T + torch.div(flat, T, rounding_mode="floor"))
        gb.append(tj * T + flat % T)
    if not ga:
        empty = torch.zeros(0, dtype=torch.int32, device=words.device)
        return empty, empty.clone()
    return (torch.cat(ga).to(torch.int32), torch.cat(gb).to(torch.int32))


def _check_tile(T, n_pad):
    if T <= 0 or T % 32:
        raise ValueError(f"tile T={T} is not a positive multiple of 32")
    if n_pad >= 1 << 31:
        raise ValueError(f"{n_pad} profiles do not fit int32 pair indices")


def screen_words(prof, lengths, tis, tjs, T, n, d):
    """(words [C, T*T/32] int32, counts [C*T] int32): the steps' survivor
    words as screen_words_reference gives them, and each row's survivor
    count. A CUDA tensor launches d2_screen_kernel (csrc/d2_screen.cu)."""
    _check_tile(T, prof.shape[0])
    if prof.dtype != torch.uint8 or prof.dim() != 2 or \
            prof.shape[1] != PROFILE_BYTES or prof.shape[0] % T:
        raise ValueError("profiles must be [n_pad, 128] uint8, n_pad a "
                         "multiple of T")
    if lengths.dtype != torch.int32 or lengths.shape != prof.shape[:1] or \
            tis.dtype != torch.int32 or tjs.dtype != torch.int32 or \
            tis.shape != tjs.shape:
        raise ValueError("lengths and tile indices must be int32, one a "
                         "profile and one a step")
    if len({t.device for t in (prof, lengths, tis, tjs)}) != 1:
        raise ValueError("profiles, lengths and steps must share a device")
    if prof.device.type == "cpu":
        words = screen_words_reference(prof, lengths, tis, tjs, T, n, d)
        return words, row_counts_reference(words, T)
    if prof.device.type != "cuda":
        raise ValueError(f"no d2_screen kernel for device {prof.device}")

    from .._build import load

    lib = load()
    prof, lengths, tis, tjs = (
        t.contiguous() for t in (prof, lengths, tis, tjs))
    C = tis.shape[0]
    words = torch.empty((C, T * T // 32), dtype=torch.int32,
                        device=prof.device)
    counts = torch.zeros(C * T, dtype=torch.int32, device=prof.device)
    if C == 0:
        return words, counts
    with torch.cuda.device(prof.device):
        err = lib.swarm_d2_screen(
            prof.data_ptr(), lengths.data_ptr(), tis.data_ptr(),
            tjs.data_ptr(), C, T, int(n), int(d), words.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"d2_screen kernel launch failed: CUDA error {err}")
    launches["d2_screen"] += 1
    return words, counts


def extract_pairs(words, counts, tis, tjs, T):
    """(ga, gb) int32: every survivor of `words` in (step, row, column)
    order. A CUDA tensor scans `counts` (int64), reads the chunk's total
    back once and, for a total above 0, launches d2_extract_kernel
    (extract_scanned)."""
    if words.dim() != 2 or words.dtype != torch.int32 or \
            words.shape[1] != T * T // 32 or counts.dtype != torch.int32 or \
            counts.shape != (words.shape[0] * T,) or \
            tis.shape != (words.shape[0],) or tjs.shape != tis.shape:
        raise ValueError("words, counts or steps do not agree with T")
    if len({t.device for t in (words, counts, tis, tjs)}) != 1:
        raise ValueError("words, counts and steps must share a device")
    if words.device.type == "cpu":
        return extract_pairs_reference(words, tis, tjs, T)
    if words.device.type != "cuda":
        raise ValueError(f"no d2_extract kernel for device {words.device}")
    incl = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(incl[-1]) if incl.numel() else 0
    return extract_scanned(words, counts, incl - counts, tis, tjs, T, total)


def extract_scanned(words, counts, offsets, tis, tjs, T, total):
    """The pairs of extract_pairs on a CUDA device, from the exclusive
    scan of the counts (`offsets`, int64) and their `total`: one launch
    of d2_extract_kernel, none for a total of 0."""
    from .._build import load

    lib = load()
    words, counts, offsets, tis, tjs = (
        t.contiguous() for t in (words, counts, offsets, tis, tjs))
    ga = torch.empty(total, dtype=torch.int32, device=words.device)
    gb = torch.empty(total, dtype=torch.int32, device=words.device)
    if total == 0:
        return ga, gb
    with torch.cuda.device(words.device):
        err = lib.swarm_d2_extract(
            words.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
            tis.data_ptr(), tjs.data_ptr(), words.shape[0], T, total,
            ga.data_ptr(), gb.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"d2_extract kernel launch failed: CUDA error {err}")
    launches["d2_extract"] += 1
    return ga, gb


def pairs_to_host(ga, gb, n):
    """(pa, pb): the device pairs (ga, gb) as int64 host arrays. Raises
    where an index lies outside [0, n): a decode bug (such as an int32
    wrap of the global index) must fail here, not corrupt clusters."""
    pa = ga.cpu().numpy().astype(np.int64)
    pb = gb.cpu().numpy().astype(np.int64)
    if len(pa):
        hi = max(int(pa.max()), int(pb.max()))
        lo = min(int(pa.min()), int(pb.min()))
        if hi >= n or lo < 0:
            raise _out_of_range(lo, hi, n)
    return pa, pb


def _out_of_range(lo, hi, n):
    return AssertionError(f"d2 screen produced out-of-range pair index "
                          f"(min={lo}, max={hi}, n={n})")


def pair_fault(ga, gb, n):
    """The AssertionError for pairs (ga, gb) that d2_tasks flagged: an
    index outside [0, n) (pairs_to_host's message), else a pair not in
    order (a >= b)."""
    lo = min(int(ga.min()), int(gb.min()))
    hi = max(int(ga.max()), int(gb.max()))
    if lo < 0 or hi >= n:
        return _out_of_range(lo, hi, n)
    return AssertionError("d2 screen produced a pair out of order (a >= b)")


def tasks_reference(ga, gb, abundances, n, no_break):
    """The plain version of d2_tasks: d2_diffs.task_layout of the
    directions d2_diffs.directions admits, in torch."""
    a, b = ga.to(torch.int64), gb.to(torch.int64)
    if ((a < 0) | (a >= b) | (b >= n)).any():
        empty = torch.zeros(0, dtype=torch.int64, device=ga.device)
        return empty, empty.clone(), True
    if no_break:
        fwd = rev = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    else:
        x, y = abundances[a], abundances[b]
        fwd, rev = x >= y, y >= x
    return torch.cat([b[rev], a[fwd]]), torch.cat([a[rev], b[fwd]]), False


def _launch(kernel, err):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    launches[kernel] += 1


def d2_tasks(ga, gb, abundances, n, no_break):
    """(tq, td, bad): the directed diff tasks of the pairs (ga, gb), [N]
    int32, a < b, in the screen's order, that the abundance rule admits
    (abundances: [n] int64; every direction under no_break), as int64
    tensors in d2_diffs.task_layout's order: tq = [gb[need_ba],
    ga[need_ab]], td = [ga[need_ba], gb[need_ab]], the reverse block
    first, each block in pair order. bad is True, and no task laid out,
    where a pair index lies outside [0, n) or a >= b (pair_fault says
    which). A CUDA tensor launches csrc/d2_tasks.cu's count kernel, scans
    its counts, reads the tasks' count and the flags' back at once and,
    where nothing is flagged, launches the emit kernel; a CPU tensor
    takes tasks_reference."""
    if ga.dim() != 1 or ga.dtype != torch.int32 or gb.dtype != torch.int32 \
            or gb.shape != ga.shape or abundances.dtype != torch.int64 or \
            abundances.shape != (n,):
        raise ValueError("pairs must be [N] int32 and abundances [n] int64")
    if len({t.device for t in (ga, gb, abundances)}) != 1:
        raise ValueError("pairs and abundances must share a device")
    if ga.device.type == "cpu":
        return tasks_reference(ga, gb, abundances, n, no_break)
    if ga.device.type != "cuda":
        raise ValueError(f"no d2_tasks kernel for device {ga.device}")
    dev = ga.device
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    N = ga.numel()
    if N == 0:
        return empty, empty.clone(), False
    from .._build import load

    lib = load()
    ga, gb, abundances = (t.contiguous() for t in (ga, gb, abundances))
    n_tiles = -(-N // lib.swarm_d2_tasks_tile())
    counts = torch.empty(3 * n_tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("d2_tasks", lib.swarm_d2_tasks_count(
            ga.data_ptr(), gb.data_ptr(), abundances.data_ptr(), N, n,
            int(bool(no_break)), counts.data_ptr(), stream))
        ends = torch.cumsum(counts, dim=0, dtype=torch.int64)
        del counts
        # the reverse and forward tasks' end, then the flags' count past it
        tasks, flagged = ends[2 * n_tiles - 1::n_tiles].tolist()
        if flagged > tasks:
            return empty, empty.clone(), True
        tq = torch.empty(tasks, dtype=torch.int64, device=dev)
        td = torch.empty(tasks, dtype=torch.int64, device=dev)
        if tasks:
            _launch("d2_tasks", lib.swarm_d2_tasks_emit(
                ga.data_ptr(), gb.data_ptr(), abundances.data_ptr(), N, n,
                int(bool(no_break)), ends.data_ptr(), tq.data_ptr(),
                td.data_ptr(), stream))
    return tq, td, False


def csr_passes(n):
    """[(shift, width)] of the CSR partition's passes over source ids
    below n: the fewest of at most CSR_DIGIT_BITS bits, the low digit
    first, widths within one of each other."""
    bits = max((n - 1).bit_length(), 1)
    k = -(-bits // CSR_DIGIT_BITS)
    widths = [bits // k + (i < bits % k) for i in range(k)]
    return [(sum(widths[:i]), w) for i, w in enumerate(widths)]


def csr_partition_reference(src, dst, diff, n):
    """The plain version of csr_partition: the kept tasks ordered by
    torch.argsort(src, stable=True)."""
    keep = diff >= 0
    s, t, df = src[keep], dst[keep], diff[keep]
    bad = ((s < 0) | (s >= n) | (t < 0) | (t >= n) | (df > 255)).any()
    order = torch.argsort(s, stable=True)
    s, t, df = s[order], t[order], df[order]
    bad |= ((s[1:] == s[:-1]) & (t[1:] <= t[:-1])).any()
    starts = torch.searchsorted(
        s, torch.arange(n + 1, dtype=s.dtype, device=s.device))
    return (starts.to(torch.int32), t.to(torch.int32), df.to(torch.uint8),
            bad.to(torch.int32).reshape(1))


def csr_partition(src, dst, diff, n):
    """(starts, adj_to, adj_diff, bad) of the directed tasks (src, dst),
    [N] int64 ids below n, and their diffs, [N] int32, -1 = rejected:
    the kept tasks stably partitioned by source, their targets adj_to
    ([m] int32) and diffs adj_diff ([m] uint8) in that order; starts
    ([n + 1] int32) the kept tasks with a source below s, s = 0..n; bad
    ([1] int32) nonzero where a source or target lies outside [0, n), a
    kept diff above 255, or a source's targets do not strictly ascend.
    The CSR is exact only where the tasks come in the screen's order,
    reverse block first (csrc/d2_csr.cu); `bad` says where they did not.
    A CUDA tensor launches csrc/d2_csr.cu's kernels: a count and a
    scatter a pass (csr_passes; the first pass drops the rejected tasks
    and reads the count of the kept ones back), then the finish kernel;
    a CPU tensor takes csr_partition_reference."""
    if src.dim() != 1 or src.dtype != torch.int64 or \
            dst.dtype != torch.int64 or diff.dtype != torch.int32 or \
            dst.shape != src.shape or diff.shape != src.shape:
        raise ValueError("tasks must be [N] int64 and diffs [N] int32")
    if len({t.device for t in (src, dst, diff)}) != 1:
        raise ValueError("tasks and diffs must share a device")
    if src.device.type == "cpu":
        return csr_partition_reference(src, dst, diff, n)
    if src.device.type != "cuda":
        raise ValueError(f"no d2_csr kernel for device {src.device}")
    N = src.numel()
    if N >= 1 << 31 or n >= 1 << 31:
        raise ValueError("the CSR partition takes fewer than 2^31 tasks")
    from .._build import load

    lib = load()
    dev = src.device
    src, dst, diff = (t.contiguous() for t in (src, dst, diff))
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    empty = (torch.zeros(n + 1, dtype=torch.int32, device=dev),
             torch.zeros(0, dtype=torch.int32, device=dev),
             torch.zeros(0, dtype=torch.uint8, device=dev), bad)
    if N == 0:
        return empty
    tile = lib.swarm_d2_csr_tile()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cur, m = (src, dst, diff), N
    with torch.cuda.device(dev):
        for k, (shift, width) in enumerate(csr_passes(n)):
            n_tiles = -(-m // tile)
            counts = torch.empty((1 << width) * n_tiles, dtype=torch.int32,
                                 device=dev)
            _launch("d2_csr", lib.swarm_d2_csr_count(
                cur[0].data_ptr(), cur[2].data_ptr(), m, int(k == 0), shift,
                width, counts.data_ptr(), stream))
            ends = torch.cumsum(counts, dim=0, dtype=torch.int32)
            del counts
            if k == 0:  # the kept tasks, the rest of the passes' size
                kept = int(ends[-1])
                if kept == 0:
                    return empty
                bufs = [(torch.empty(kept, dtype=torch.int32, device=dev),
                         torch.empty(kept, dtype=torch.int32, device=dev),
                         torch.empty(kept, dtype=torch.uint8, device=dev))
                        for _ in range(2)]
            out = bufs[k % 2]
            _launch("d2_csr", lib.swarm_d2_csr_scatter(
                cur[0].data_ptr(), cur[1].data_ptr(), cur[2].data_ptr(), m,
                n, int(k == 0), shift, width, ends.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                bad.data_ptr(), stream))
            cur, m = out, kept
        starts = torch.empty(n + 1, dtype=torch.int32, device=dev)
        _launch("d2_csr", lib.swarm_d2_csr_finish(
            cur[0].data_ptr(), cur[1].data_ptr(), m, n, starts.data_ptr(),
            bad.data_ptr(), stream))
    return starts, cur[1], cur[2], bad


def csr_to_host(starts, adj_to, adj_diff):
    """(adj_start, adj_count, adj_to, adj_diff) int64 host arrays of
    csr_partition's starts, targets and diffs: read back as they are
    (int32, int32 and bytes: 5 bytes an edge) into pageable memory and
    widened there on torch's threads. No pinned buffer outlives the call
    (PERF.md §6)."""
    starts, adj_to, adj_diff = (t.cpu().to(torch.int64).numpy()
                                for t in (starts, adj_to, adj_diff))
    return starts[:-1], np.diff(starts), adj_to, adj_diff


def tile_steps(n_tiles):
    """(tis, tjs) int32 arrays of the tile-pair steps I <= J, in JAX's
    order (I ascending, then J)."""
    tis, tjs = np.triu_indices(n_tiles)
    return tis.astype(np.int32), tjs.astype(np.int32)


class D2NetworkEngine:
    """qgram screen -> exact diffs -> directed CSR edges, on `device`;
    with `shards` (swarm_tpu_torch/parallel) the screen and extraction
    run over them (candidate_pairs_sharded) and the exact diffs on
    `device`."""

    TILE = 4096
    #: the exact diffs run on the card from this many candidate pairs up,
    #: the native ones below: DEVICE_DIFFS_MIN on one host thread and
    #: DEVICE_DIFFS_MIN_THREADED when -t gives the native diffs more,
    #: once the d2_diffs kernel has launched in this process
    #: (d2_diffs.warm: the resident server, a run after another), the
    #: _COLD numbers before. scripts/dispatch_sweep.py on an NVIDIA H100
    #: 80GB HBM3 at 700 W (PERF.md §5), build_adjacency on the engine's
    #: own pairs of gen_corpus(n=32,768, length=150 and 400) at d = 2
    #: and 6, cut or repeated to 512-65,536 pairs (131,072 in a fresh
    #: process): once the kernel had run the card won from 1,024 pairs
    #: at -t 1 and from 2,048-8,192 at -t 8; its first use adds 8-21 ms
    #: (the context and library already up: the screen ran), and before
    #: it the host won up to 8,192 pairs and the card from 16,384 at -t
    #: 1, up to 32,768 and from 65,536 at -t 8
    DEVICE_DIFFS_MIN = 1_024
    DEVICE_DIFFS_MIN_COLD = 16_384
    DEVICE_DIFFS_MIN_THREADED = 8_192
    DEVICE_DIFFS_MIN_THREADED_COLD = 65_536

    def __init__(self, db, d: int, device: torch.device, threads: int = 1,
                 shards=None):
        from .. import _native

        self.shards = shards
        self.db = db
        self.d = int(d)
        self.device = torch.device(device)
        self.threads = max(int(threads), 1)
        self.n = len(db)
        # tests shrink the tile to exercise the multi-tile scan cheaply
        self.TILE = int(os.environ.get("SWARM_TPU_D2_TILE", self.TILE))
        T = self.TILE
        self.n_pad = max(T, -(-self.n // T) * T)
        _check_tile(T, self.n_pad)
        prof_u64 = _native.qgram_profiles_arena(
            db.codes, db.offsets, db.lengths
        )
        prof_u8 = np.zeros((self.n_pad, PROFILE_BYTES), dtype=np.uint8)
        prof_u8[: self.n] = prof_u64.view(np.uint8).reshape(
            self.n, PROFILE_BYTES
        )
        lengths = np.zeros(self.n_pad, dtype=np.int32)
        lengths[: self.n] = db.lengths
        self.prof = torch.from_numpy(prof_u8).to(self.device)
        self.lengths = torch.from_numpy(lengths).to(self.device)

    def candidate_pairs_device(self, shards=None):
        """(ga, gb, n_pairs): every candidate pair (a < b), int32 on the
        engine's device, in (tile pair, row, column) order, screened over
        `shards` where given (parallel/mesh.py: sharded_candidate_pairs);
        n_pairs is the sum of the chunks' totals that the extraction read
        back, so it costs no readback of its own. The spans
        d2_network.screen (the chunk loop) and d2_network.to_host (the
        concatenation) hold the two parts."""
        if shards is not None:
            from ..parallel.mesh import sharded_candidate_pairs

            ga, gb = sharded_candidate_pairs(self, shards)
            return ga, gb, ga.numel()
        T = self.TILE
        all_ti, all_tj = tile_steps(self.n_pad // T)
        C = max(1, int(os.environ.get("SWARM_TPU_D2_CHUNK", "512")))
        empty = torch.zeros(0, dtype=torch.int32, device=self.device)
        ga_parts, gb_parts = [empty], [empty]
        with metrics.span("d2_network.screen"):
            for c0 in range(0, len(all_ti), C):
                tis = torch.from_numpy(all_ti[c0:c0 + C]).to(self.device)
                tjs = torch.from_numpy(all_tj[c0:c0 + C]).to(self.device)
                words, counts = screen_words(self.prof, self.lengths, tis,
                                             tjs, T, self.n, self.d)
                ga, gb = extract_pairs(words, counts, tis, tjs, T)
                del words, counts
                if ga.numel():
                    ga_parts.append(ga)
                    gb_parts.append(gb)
        with metrics.span("d2_network.to_host"):
            ga, gb = torch.cat(ga_parts), torch.cat(gb_parts)
        return ga, gb, ga.numel()

    def candidate_pairs(self):
        """(pa, pb, n_screened): candidate_pairs_device's pairs as int64
        host arrays (pairs_to_host)."""
        ga, gb, n_pairs = self.candidate_pairs_device()
        return (*pairs_to_host(ga, gb, self.n), n_pairs)

    def candidate_pairs_sharded(self, shards):
        """candidate_pairs over `shards`: each screens a contiguous range
        of the steps, and their pairs concatenate in the steps' order
        (parallel/mesh.py: sharded_candidate_pairs)."""
        ga, gb, n_pairs = self.candidate_pairs_device(shards)
        return (*pairs_to_host(ga, gb, self.n), n_pairs)

    def build_adjacency(self, mismatch, gapopen, gapextend, no_break):
        """Directed CSR adjacency (adj_start, adj_count, adj_to,
        adj_diff) of exact accepted edges, targets ascending, plus the
        screened-candidate count and the survivor count. The pairs stay
        on the engine's device where the exact diffs run there (their
        tasks laid out by d2_tasks); only the native route copies them
        to the host. The CSR is built where the exact diffs ran
        (csr_partition)."""
        from . import d2_diffs

        with metrics.span("d2_network.build"):
            ga, gb, n_pairs = self.candidate_pairs_device(self.shards)
            with metrics.span("d2_network.diffs"):
                on_device = self._device_diffs(n_pairs)
                if on_device:
                    tasks = self._diff_engine.diff_tasks(
                        ga, gb, mismatch, gapopen, gapextend, no_break)
                else:
                    pa, pb = pairs_to_host(ga, gb, self.n)
                    tasks = d2_diffs.native_tasks(
                        self.db, pa, pb, self.d, mismatch, gapopen,
                        gapextend, no_break, nthreads=self.threads)
            metrics.record(**{"d2_network.device_tasks":
                              len(tasks[0]) if on_device else 0})
            del ga, gb  # the CSR's buffers may take the pairs' memory
            with metrics.span("d2_network.csr"):
                adj = self._csr(*tasks, on_device)
        return (*adj, n_pairs, n_pairs)

    def _device_diffs(self, n_pairs):
        """Whether the exact diffs of n_pairs pairs run on the device (its
        DeviceDiffEngine made on first use): once the pair count
        amortizes the kernel's launch, and its first use before it has
        run in this process; SWARM_TPU_D2_DIFFS=native|device
        overrides."""
        from . import d2_diffs

        mode = os.environ.get("SWARM_TPU_D2_DIFFS", "auto")
        if self.threads == 1:
            at = self.DEVICE_DIFFS_MIN if d2_diffs.warm else \
                self.DEVICE_DIFFS_MIN_COLD
        else:
            at = self.DEVICE_DIFFS_MIN_THREADED if d2_diffs.warm else \
                self.DEVICE_DIFFS_MIN_THREADED_COLD
        use_device = mode == "device" or (
            mode == "auto" and n_pairs >= at and self.device.type == "cuda"
        )
        if use_device and not hasattr(self, "_diff_engine"):
            self._diff_engine = d2_diffs.DeviceDiffEngine(
                self.db, self.d, self.device)
        return use_device

    def _csr(self, tq, td, diffs, on_device):
        """(adj_start, adj_count, adj_to, adj_diff) of the accepted
        directed edges, sources ascending, then targets, int64 host
        arrays: csr_partition of the tasks (diff_tasks' where on_device,
        else native_tasks'), on their device, read back once. Raises
        where its check failed: the tasks did not come in the screen's
        order, so the partition would not be the sorted CSR."""
        starts, adj_to, adj_diff, bad = csr_partition(tq, td, diffs, self.n)
        if int(bad):
            raise AssertionError(
                "d2 CSR check failed: the tasks are out of the screen's "
                "step order or out of range, so the partition is not the "
                "sorted CSR")
        adj = csr_to_host(starts, adj_to, adj_diff)
        metrics.record(**{
            "d2_network.edges": len(adj[2]),
            "d2_network.csr_device_edges": len(adj[2]) if on_device else 0})
        return adj
