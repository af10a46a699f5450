"""Bulk d>=2 candidate discovery and exact edges on one torch device.

Counterpart of swarm_tpu/ops/d2_network.py (D2NetworkEngine, single
device). The screen is that module's: Hamming distance between 1024-bit
qgram parity profiles as an int8 product of +-1 vectors,

    hamming(a, b) = (1024 - dot(a_pm1, b_pm1)) / 2,

so mindiff = ceil(hamming / 10) <= d  <=>  dot >= 1024 - 20d, plus the
length bound |len_a - len_b| <= d. Both are sound lower bounds; the
exact diffs (ops/d2_diffs.py or the native kernel) reject the rest.

Tile pairs (I <= J) of T profiles are screened in order; each tile
pair's survivors are found with torch.nonzero, whose output is sized
by the survivor count, and decoded to global int64 indices.
"""

import os
import time

import numpy as np
import torch

PROFILE_BYTES = 128  # 1024-bit qgram parity vector
PROFILE_BITS = 1024


def _unpack_pm1(prof_bytes):
    """[n, 128] uint8 -> [n, 1024] int8 in {+1, -1} (bit set -> -1)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=prof_bytes.device)
    bits = (prof_bytes[:, :, None] >> shifts) & 1
    return (1 - 2 * bits.to(torch.int8)).reshape(-1, PROFILE_BITS)


class D2NetworkEngine:
    """qgram screen -> exact diffs -> directed CSR edges, on `device`."""

    TILE = 4096

    def __init__(self, db, d: int, device: torch.device, threads: int = 1):
        from .. import _native

        self.db = db
        self.d = int(d)
        self.device = torch.device(device)
        self.threads = max(int(threads), 1)
        self.n = len(db)
        # tests shrink the tile to exercise the multi-tile scan cheaply
        self.TILE = int(os.environ.get("SWARM_TPU_D2_TILE", self.TILE))
        T = self.TILE
        self.n_pad = max(T, -(-self.n // T) * T)
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
        self.pm1 = _unpack_pm1(self.prof)
        #: host seconds per phase of the last build_adjacency; with
        #: SWARM_TPU_TIMING set, the device is synchronised between phases
        self.timings = {}

    def _sync(self):
        if self.device.type == "cuda" and os.environ.get("SWARM_TPU_TIMING"):
            torch.cuda.synchronize(self.device)

    def candidate_pairs(self):
        """(pa, pb, n_screened): unordered candidate pairs (a < b) as
        int64 arrays, in (tile pair, row, column) order."""
        T = self.TILE
        n_tiles = self.n_pad // T
        dot_min = PROFILE_BITS - 20 * self.d
        t_screen = t_extract = 0.0
        ga_parts, gb_parts = [], []
        for ti in range(n_tiles):
            a = self.pm1[ti * T:(ti + 1) * T]
            la = self.lengths[ti * T:(ti + 1) * T]
            for tj in range(ti, n_tiles):
                t0 = time.perf_counter()
                b = self.pm1[tj * T:(tj + 1) * T]
                lb = self.lengths[tj * T:(tj + 1) * T]
                dot = torch._int_mm(a, b.t())  # [T, T] int32
                mask = (dot >= dot_min) & (
                    (la[:, None] - lb[None, :]).abs() <= self.d)
                if ti == tj:  # gi < gj
                    mask = torch.triu(mask, diagonal=1)
                if (tj + 1) * T > self.n:  # gj < n
                    mask[:, self.n - tj * T:] = False
                self._sync()
                t1 = time.perf_counter()
                idx = torch.nonzero(mask)
                if idx.shape[0]:
                    ga_parts.append(idx[:, 0] + ti * T)
                    gb_parts.append(idx[:, 1] + tj * T)
                t_extract += time.perf_counter() - t1
                t_screen += t1 - t0
        t1 = time.perf_counter()
        if ga_parts:
            pa = torch.cat(ga_parts).cpu().numpy()
            pb = torch.cat(gb_parts).cpu().numpy()
        else:
            pa = np.zeros(0, dtype=np.int64)
            pb = np.zeros(0, dtype=np.int64)
        self.timings["screen"] = t_screen
        self.timings["extract"] = t_extract + time.perf_counter() - t1
        return pa, pb, len(pa)

    def build_adjacency(self, mismatch, gapopen, gapextend, no_break):
        """Directed CSR adjacency (adj_start, adj_count, adj_to,
        adj_diff) of exact accepted edges, targets ascending, plus the
        screened-candidate count and the survivor count."""
        from .. import _native

        db = self.db
        pa, pb, n_screened = self.candidate_pairs()
        if len(pa):
            # loud invariant: a decode bug (such as an int32 wrap of the
            # global index) must fail here, not corrupt clusters
            hi = max(int(pa.max()), int(pb.max()))
            lo = min(int(pa.min()), int(pb.min()))
            if hi >= self.n or lo < 0:
                raise AssertionError(
                    f"d2 screen produced out-of-range pair index "
                    f"(min={lo}, max={hi}, n={self.n})"
                )
        # exact diffs: the device kernel once the pair count amortizes
        # its dispatch; SWARM_TPU_D2_DIFFS=native|device overrides
        t0 = time.perf_counter()
        mode = os.environ.get("SWARM_TPU_D2_DIFFS", "auto")
        use_device = mode == "device" or (
            mode == "auto" and len(pa) >= 8192 and self.device.type == "cuda"
        )
        if use_device:
            from .d2_diffs import DeviceDiffEngine

            if not hasattr(self, "_diff_engine"):
                self._diff_engine = DeviceDiffEngine(db, self.d, self.device)
            diff_ab, diff_ba = self._diff_engine.diffs_pairs(
                pa, pb, mismatch, gapopen, gapextend, no_break,
            )
        else:
            diff_ab, diff_ba = _native.d2_diffs_pairs(
                db.codes, db.offsets, db.lengths, db.abundances, pa, pb,
                self.d, mismatch, gapopen, gapextend, no_break,
                nthreads=self.threads,
            )
        self.timings["diffs"] = time.perf_counter() - t0
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
        return adj_start, adj_count, et, ediff, n_screened, len(pa)
