"""Cost-only global alignment scores of one seed against many targets.

Counterpart of swarm_tpu/ops/pallas_nw.py (band_for_cutoff,
banded_scores_reference, the two Pallas score kernels) and of
nw_scores_device in swarm_tpu/ops/search_jax.py. Cost model of
ops/search.py (src/search8.cc): gap open Q = go + ge, extend R = ge,
boundaries H[-1][i] = Q + iR, E init 2Q + iR, F row boundary
2go + (row+2)ge, diagonal boundary 0 at row 0 else go + row*ge.

Two functions, each with a plain PyTorch version and a CUDA kernel
(csrc/nw_scores.cu):

- full-row scores: the exact cost for every pair, bit-identical to
  ops/search.py. ``nw_scores_reference`` is the plain version,
  ``full_scores`` the wrapper.
- banded scores: the DP restricted to |i - j| <= B (2B+1 slots per
  row). Exact wherever the true cost is <= the cutoff B was chosen for
  (``band_for_cutoff``), and above that cutoff elsewhere (INF when the
  final cell lies outside the band). ``banded_scores_reference`` is the
  plain version, ``banded_scores`` the wrapper.

A wrapper runs the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. The kernels read the code rows
in place through the target ids: no gathered copy of the rows, no
padding of the batch or of the row width.
"""

import torch

INF = 1 << 28

#: widest band the band kernel takes (the rule of DeviceAligner)
MAX_BAND = 63

#: kernel launches made by the wrappers (CUDA tensors only)
launches = {"banded_scores": 0, "full_scores": 0}


def band_for_cutoff(cutoff: int, go: int, ge: int) -> int:
    """Smallest band B with gapopen + B*gapextend > cutoff: every cell
    off the band costs more than any acceptable pair, so the banded
    score classifies accept/reject exactly (docs/PARITY.md sect. 5)."""
    B = (cutoff - go) // ge + 1
    return max(1, int(B))


def banded_scores_reference(qrows, trows, qlens, tlens, mm, go, ge, band):
    """[P] int32 banded scores of pairs (qrows[p], trows[p]); INF when
    the final cell is out of band or a length is 0.

    qrows/trows: [P, W] uint8 codes; qlens/tlens: [P] int32. Mirrors
    banded_scores_reference of swarm_tpu/ops/pallas_nw.py slot for slot
    (band coordinates k in [0, 2B], query index i = row + k - B; F along
    the row from a min-plus prefix scan over the slots).
    """
    P, W = qrows.shape
    B = int(band)
    width = 2 * B + 1
    Q = go + ge
    R = ge
    dev = qrows.device
    i32 = torch.int32
    k = torch.arange(width, dtype=i32, device=dev)
    ql = qlens.to(i32)[:, None]
    tl = tlens.to(i32)
    inf = torch.tensor(INF, dtype=i32, device=dev)

    i0 = k - B  # query index at row 0
    H_prev = torch.where(i0 - 1 >= 0, Q + (i0 - 1) * R, inf).expand(P, width)
    E_prev = torch.where(
        i0 - 1 >= 0, 2 * Q + (i0 - 1) * R, inf).expand(P, width)
    inf_col = torch.full((P, 1), INF, dtype=i32, device=dev)

    # query extended by B slots on the left and B on the right, so the
    # band of a row is a plain slice
    q_ext = torch.zeros((P, W + 2 * B), dtype=torch.uint8, device=dev)
    q_ext[:, B:B + W] = qrows

    scores = torch.full((P,), INF, dtype=i32, device=dev)
    k_final = (ql[:, 0] - tl + B)  # slot of (qlen-1) at row tlen-1
    in_band = (k_final >= 0) & (k_final < width)
    k_gather = k_final.clamp(0, width - 1).long()[:, None]
    n_rows = min(W, int(tl.max())) if P else 0
    for row in range(n_rows):
        i = row + k - B
        i_valid = (i >= 0) & (i < ql)
        q_band = q_ext[:, row:row + width]
        t_code = trows[:, row][:, None]
        V = torch.where(q_band == t_code, 0, mm).to(i32)
        diag_in = torch.where(i == 0, 0 if row == 0 else go + row * ge, H_prev)
        diag = torch.where(i_valid, diag_in + V, inf)
        # up: E carried per column -> slot k+1 of the previous row
        E_in = torch.cat([E_prev[:, 1:], inf_col], dim=1)
        E_in = torch.where(i_valid, E_in, inf)
        # left: F along the row via min-plus prefix scan over band slots
        pre = torch.minimum(diag, E_in)
        f_boundary = 2 * go + (row + 2) * ge
        seed = torch.where(i == 0, f_boundary - k * R, inf)
        A = torch.minimum(pre + Q - (k + 1) * R, seed)
        running = torch.cummin(A, dim=1).values
        shifted = torch.cat([inf_col, running[:, :-1]], dim=1)
        F_in = torch.minimum(
            shifted + k * R, torch.where(i == 0, f_boundary, inf))
        H = torch.minimum(torch.minimum(pre, F_in), inf)
        E = torch.minimum(torch.minimum(H + Q, E_in + R), inf)
        final = torch.gather(H, 1, k_gather)[:, 0]
        ended = (tl == row + 1) & in_band
        scores = torch.where(ended, final, scores)
        H_prev, E_prev = H, E
    scores = torch.where(ql[:, 0] > 0, scores, inf)
    return torch.minimum(scores, inf).to(i32)


def nw_scores_reference(padded, lengths, seed_id, target_ids, mm, go, ge):
    """[B] int32 exact global-alignment cost of row `seed_id` against
    each row of `target_ids`; INF for an empty seed or target.

    padded: [n, W] uint8 codes; lengths: [n] int32; target_ids: [B]
    int32/int64. Mirrors nw_scores_device of swarm_tpu/ops/search_jax.py
    (one target row per step, the F recurrence solved with a min-plus
    prefix scan along the query).
    """
    n, W = padded.shape
    dev = padded.device
    i32 = torch.int32
    tid = target_ids.long()
    nb = tid.shape[0]
    Q = go + ge
    R = ge
    qlen = int(lengths[seed_id])
    dlens = lengths[tid].to(i32)
    if nb == 0 or qlen == 0:
        return torch.full((nb,), INF, dtype=i32, device=dev)
    qseq = padded[seed_id, :qlen]
    rows = padded[tid]

    cols = torch.arange(qlen, dtype=i32, device=dev)
    H = (Q + cols * R).expand(nb, qlen)
    E = (2 * Q + cols * R).expand(nb, qlen)
    scores = torch.full((nb,), INF, dtype=i32, device=dev)
    for row in range(min(W, int(dlens.max()))):
        V = torch.where(rows[:, row][:, None] == qseq[None, :], 0, mm).to(i32)
        diag_boundary = torch.full(
            (nb, 1), 0 if row == 0 else go + row * ge, dtype=i32, device=dev)
        diag = torch.cat([diag_boundary, H[:, :-1]], dim=1) + V
        pre = torch.minimum(diag, E)
        # F recurrence via min-plus prefix scan (exact for Q >= R >= 0)
        A = pre + Q - (cols + 1) * R
        running = torch.cummin(A, dim=1).values
        f_boundary = 2 * go + (row + 2) * ge
        F = torch.cat([
            torch.full((nb, 1), f_boundary, dtype=i32, device=dev),
            torch.clamp(running[:, :-1], max=f_boundary) + cols[1:] * R,
        ], dim=1)
        H = torch.minimum(pre, F)
        E = torch.minimum(H + Q, E + R)
        scores = torch.where(dlens == row + 1, H[:, qlen - 1], scores)
    return scores


def _check(padded, lengths, seed_id, target_ids):
    if padded.dim() != 2 or padded.dtype != torch.uint8:
        raise ValueError("padded must be a [n, W] uint8 tensor")
    if lengths.dtype != torch.int32 or lengths.shape != padded.shape[:1]:
        raise ValueError("lengths must be an [n] int32 tensor")
    if target_ids.dim() != 1 or target_ids.dtype not in (
            torch.int32, torch.int64):
        raise ValueError("target_ids must be a [B] int32 or int64 tensor")
    if len({t.device for t in (padded, lengths, target_ids)}) != 1:
        raise ValueError("codes, lengths and target ids must share a device")
    if not 0 <= seed_id < padded.shape[0]:
        raise ValueError(f"seed_id {seed_id} out of range")
    if padded.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no score kernel for device {padded.device}")


def _launch(name, padded, lengths, seed_id, target_ids, mm, go, ge, band):
    """Launch one kernel of csrc/nw_scores.cu; `band` is None for the
    full-row kernel."""
    from .._build import load

    lib = load()
    padded, lengths, target_ids = (
        t.contiguous() for t in (padded, lengths, target_ids))
    nb = target_ids.shape[0]
    out = torch.empty(nb, dtype=torch.int32, device=padded.device)
    if nb == 0:
        return out
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (padded.data_ptr(), padded.stride(0), padded.shape[1],
                lengths.data_ptr(), int(seed_id), target_ids.data_ptr(),
                int(target_ids.dtype == torch.int64), nb,
                int(mm), int(go), int(ge))
        if band is None:
            err = lib.swarm_nw_full_scores(*args, out.data_ptr(), stream)
        else:
            err = lib.swarm_nw_banded_scores(
                *args, int(band), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    return out


def banded_scores(padded, lengths, seed_id, target_ids, mm, go, ge, band):
    """[B] int32 banded scores of row `seed_id` against rows
    `target_ids` of the resident code matrix (contract in the module
    header). CPU: banded_scores_reference over the gathered rows; CUDA:
    the band kernel of csrc/nw_scores.cu."""
    _check(padded, lengths, seed_id, target_ids)
    if not 1 <= band <= MAX_BAND:
        raise ValueError(f"band {band} outside 1..{MAX_BAND}")
    if padded.device.type == "cpu":
        tid = target_ids.long()
        nb = tid.shape[0]
        return banded_scores_reference(
            padded[seed_id].expand(nb, -1), padded[tid],
            lengths[seed_id].expand(nb), lengths[tid], mm, go, ge, band)
    return _launch("banded_scores", padded, lengths, seed_id, target_ids,
                   mm, go, ge, band)


def full_scores(padded, lengths, seed_id, target_ids, mm, go, ge):
    """[B] int32 exact scores of row `seed_id` against rows
    `target_ids`. CPU: nw_scores_reference; CUDA: the full-row kernel of
    csrc/nw_scores.cu."""
    _check(padded, lengths, seed_id, target_ids)
    if padded.device.type == "cpu":
        return nw_scores_reference(
            padded, lengths, seed_id, target_ids, mm, go, ge)
    return _launch("full_scores", padded, lengths, seed_id, target_ids,
                   mm, go, ge, None)
