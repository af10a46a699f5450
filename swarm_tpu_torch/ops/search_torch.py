"""Device batched cost-space alignment screening for the d>=2 engine.

Counterpart of swarm_tpu/ops/search_jax.py (DeviceAligner). The
reference's hot kernel is a striped SIMD Needleman-Wunsch in cost space
whose backtracked difference count decides membership (src/search8.cc,
src/search16.cc). The work is split:

  1. THIS module: a batched score-only forward pass on the torch device
     (ops/nw_scores.py: the band kernel when a cutoff is given and its
     band fits, else the full-row kernel). No direction bits, no
     backtrack: the output is [B] int32 scores.
  2. Host: pairs with score > d * max(mismatch, gapopen + gapextend)
     cannot have <= d differences (every difference costs at most that
     much), so they are rejected outright; the few survivors are re-run
     through the exact host kernel (ops/search.py + the native
     backtrack), which reproduces the reference's tie-broken diff counts
     bit-for-bit.

The screen is sound: diff(pair) <= d  ==>  score(pair) <= cutoff, so no
accepted pair is ever lost; everything the screen passes is re-checked
exactly.
"""

import numpy as np
import torch

from .d2_diffs import row_stride_16
from .nw_scores import MAX_BAND, band_for_cutoff, banded_scores, full_scores


class DeviceAligner:
    """Holds the code rows on one torch device and answers batched
    screens of one seed against a list of targets."""

    #: lists shorter than this stay on the host (models/general.py).
    #: Carried over from swarm_tpu's DeviceAligner, where it was set for
    #: another device; not re-measured for CUDA yet.
    MIN_DEVICE_BATCH = 2048

    def __init__(self, padded_np: np.ndarray, lengths_np: np.ndarray,
                 device):
        self.device = torch.device(device)
        self.n = padded_np.shape[0]
        # rows at a stride of a multiple of 16 bytes, the unit the band
        # kernel reads: no copy at every launch
        self.padded = row_stride_16(torch.from_numpy(
            np.ascontiguousarray(padded_np, dtype=np.uint8)).to(self.device))
        self.lengths = torch.from_numpy(
            np.ascontiguousarray(lengths_np, dtype=np.int32)).to(self.device)

    def scores(self, seed_id: int, target_ids: np.ndarray,
               mismatch: int, gapopen: int, gapextend: int,
               cutoff: int = None) -> np.ndarray:
        """[B] int32 scores of `seed_id` against `target_ids`. With a
        cutoff whose band is at most 63 the scores are exact up to the
        cutoff and above it otherwise; else exact everywhere."""
        ids = torch.from_numpy(
            np.ascontiguousarray(target_ids, dtype=np.int64)).to(self.device)
        band = None
        if cutoff is not None:
            band = band_for_cutoff(cutoff, gapopen, gapextend)
        if band is not None and band <= MAX_BAND:
            out = banded_scores(
                self.padded, self.lengths, int(seed_id), ids,
                mismatch, gapopen, gapextend, band)
        else:
            out = full_scores(
                self.padded, self.lengths, int(seed_id), ids,
                mismatch, gapopen, gapextend)
        return out.cpu().numpy()
