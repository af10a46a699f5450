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

``D2NetworkEngine.build_adjacency`` is the run's span ``d2_network.build``
(metrics.py), its steps the spans ``d2_network.screen`` (the chunk loop),
``.to_host`` (the pairs' copy to the host), ``.diffs`` (the exact diffs)
and ``.csr`` (the edge sort and CSR on the host); it counts the directed
alignments the exact diffs run (``d2_network.alignments``) and the edges
they accept (``d2_network.edges``). No step synchronises the device.
"""

import os

import numpy as np
import torch

from .. import metrics

PROFILE_BYTES = 128  # 1024-bit qgram parity vector
PROFILE_BITS = 1024

#: kernel launches made by the wrappers (CUDA tensors only)
launches = {"d2_screen": 0, "d2_extract": 0}


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
            raise AssertionError(
                f"d2 screen produced out-of-range pair index "
                f"(min={lo}, max={hi}, n={n})"
            )
    return pa, pb


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

    def candidate_pairs(self):
        """(pa, pb, n_screened): unordered candidate pairs (a < b) as
        int64 arrays, in (tile pair, row, column) order."""
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
            pa, pb = pairs_to_host(torch.cat(ga_parts), torch.cat(gb_parts),
                                   self.n)
        return pa, pb, len(pa)

    def candidate_pairs_sharded(self, shards):
        """candidate_pairs over `shards`: each screens a contiguous range
        of the steps, and their pairs concatenate in the steps' order
        (parallel/mesh.py: sharded_candidate_pairs)."""
        from ..parallel.mesh import sharded_candidate_pairs

        return sharded_candidate_pairs(self, shards)

    def build_adjacency(self, mismatch, gapopen, gapextend, no_break):
        """Directed CSR adjacency (adj_start, adj_count, adj_to,
        adj_diff) of exact accepted edges, targets ascending, plus the
        screened-candidate count and the survivor count."""
        with metrics.span("d2_network.build"):
            if self.shards is not None:
                pa, pb, n_screened = self.candidate_pairs_sharded(
                    self.shards)
            else:
                pa, pb, n_screened = self.candidate_pairs()
            with metrics.span("d2_network.diffs"):
                diff_ab, diff_ba = self._diffs(
                    pa, pb, mismatch, gapopen, gapextend, no_break)
            with metrics.span("d2_network.csr"):
                adj = self._csr(pa, pb, diff_ab, diff_ba)
        return (*adj, n_screened, len(pa))

    def _diffs(self, pa, pb, mismatch, gapopen, gapextend, no_break):
        """(diff_ab, diff_ba) of every pair: the device kernel once the
        pair count amortizes its launch, and its first use before it has
        run in this process; SWARM_TPU_D2_DIFFS=native|device
        overrides."""
        from .. import _native
        from . import d2_diffs

        db = self.db
        mode = os.environ.get("SWARM_TPU_D2_DIFFS", "auto")
        if self.threads == 1:
            at = self.DEVICE_DIFFS_MIN if d2_diffs.warm else \
                self.DEVICE_DIFFS_MIN_COLD
        else:
            at = self.DEVICE_DIFFS_MIN_THREADED if d2_diffs.warm else \
                self.DEVICE_DIFFS_MIN_THREADED_COLD
        use_device = mode == "device" or (
            mode == "auto" and len(pa) >= at and self.device.type == "cuda"
        )
        if use_device:
            if not hasattr(self, "_diff_engine"):
                self._diff_engine = d2_diffs.DeviceDiffEngine(
                    db, self.d, self.device)
            return self._diff_engine.diffs_pairs(
                pa, pb, mismatch, gapopen, gapextend, no_break,
            )
        need_ab, need_ba = d2_diffs.directions(db.abundances, pa, pb,
                                               no_break)
        metrics.record(**{"d2_network.alignments":
                          np.count_nonzero(need_ab)
                          + np.count_nonzero(need_ba)})
        return _native.d2_diffs_pairs(
            db.codes, db.offsets, db.lengths, db.abundances, pa, pb,
            self.d, mismatch, gapopen, gapextend, no_break,
            nthreads=self.threads,
        )

    def _csr(self, pa, pb, diff_ab, diff_ba):
        """(adj_start, adj_count, adj_to, adj_diff) of the accepted
        directed edges, sources ascending, then targets."""
        keep_ab = diff_ab >= 0
        keep_ba = diff_ba >= 0
        ef = np.concatenate([pa[keep_ab], pb[keep_ba]])
        et = np.concatenate([pb[keep_ab], pa[keep_ba]])
        ediff = np.concatenate([diff_ab[keep_ab], diff_ba[keep_ba]])
        order = np.lexsort((et, ef))
        ef, et, ediff = ef[order], et[order], ediff[order]
        n = self.n
        adj_count = np.bincount(ef, minlength=n).astype(np.int64) if n else \
            np.zeros(0, dtype=np.int64)
        adj_start = np.zeros(n, dtype=np.int64)
        if n:
            np.cumsum(adj_count[:-1], out=adj_start[1:])
        metrics.record(**{"d2_network.edges": len(et)})
        return adj_start, adj_count, et, ediff
