"""Exact diffs of d>=2 candidate pairs: the forward-diff banded DP.

Counterpart of swarm_tpu/ops/d2_diffs_jax.py (d2_diffs_program,
DeviceDiffEngine) and swarm_tpu/ops/pallas_d2_diffs.py
(d2_diffs_pallas). The DP and its tie-break contract are described in
d2_diffs_jax.py's header: beside each cost the DP carries the
difference count of the path the native backtrack would choose, so the
result equals _native.d2_diffs_pairs.

- ``d2_diffs_reference``: the plain PyTorch version, a loop over rows
  with the band written out over W slots, vectorised over tasks.
- ``d2_diffs``: the wrapper. A CPU tensor goes to the reference; a CUDA
  tensor launches the hand-written kernel (csrc/d2_diffs.cu) or raises.
- ``DeviceDiffEngine``: keeps the code rows and abundances on a device
  and answers ``diff_tasks``: the directed tasks of the device's pairs,
  laid out there (d2_network.d2_tasks), and their diffs, left on the
  device.
- ``native_tasks``: the same tasks and diffs from the native host kernel
  (_native.d2_diffs_pairs), as CPU tensors.
"""

import numpy as np
import torch

from .. import metrics

INF = 1 << 28

#: kernel launches made by ``d2_diffs`` (CUDA tensors only)
launches = 0
#: whether the kernel has launched in this process, its first use paid:
#: the device-diffs rule of ops/d2_network.py reads it
warm = False


def d2_diffs_reference(tq, td, qlens, dlens, B, Lmax, mismatch, go, ge, d):
    """diffs[N] for directed tasks (query row tq[i], target row td[i]).

    tq/td: [N, Lmax] uint8 code rows (0..3, padding arbitrary);
    qlens/dlens: [N] int32. Returns int32 diffs, -1 = rejected (cost >
    d*max(mismatch, go+ge), diff > d, |qlen-dlen| > B, or empty row).
    Same arguments and result as d2_diffs_jax.d2_diffs_program.
    """
    W = 2 * B + 1
    Q = go + ge
    R = ge
    cutoff = d * max(mismatch, Q)
    dev = tq.device
    N = tq.shape[0]
    i32 = torch.int32
    ql = qlens.to(i32)
    dl = dlens.to(i32)
    active = (ql > 0) & (dl > 0) & ((ql - dl).abs() <= B)

    def full(v):
        return torch.full((N,), v, dtype=i32, device=dev)

    # row -1 boundary per slot k: column k - B - 1
    Hb, Eb, Hd, Ed = [], [], [], []
    for k in range(W):
        im1 = k - B - 1
        if im1 >= 0:
            ok = im1 < ql
            Hb.append(torch.where(ok, Q + im1 * R, INF).to(i32))
            Eb.append(torch.where(ok, 2 * Q + im1 * R, INF).to(i32))
            Hd.append(full(im1 + 1))
            Ed.append(full(im1 + 2))
        else:
            Hb.append(full(INF))
            Eb.append(full(INF))
            Hd.append(full(0))
            Ed.append(full(0))
    score = full(INF)
    sdiff = full(0)
    e_edge, e_edge_d = full(INF), full(0)

    for row in range(Lmax):
        dchar = td[:, row]
        m_lastrow = dl == row + 1
        bval = 0 if row == 0 else go + row * ge
        fboundary = 2 * go + (row + 2) * ge
        Fv, Fd = full(INF), full(0)
        for k in range(W):
            i = row + k - B
            # slots whose query index is outside [0, Lmax) keep their state
            if i < 0 or i > Lmax - 1:
                continue
            qchar = tq[:, i]
            m_valid = i < ql
            if i == 0:
                diag_in, diag_d = full(bval), full(row)
                Fv, Fd = full(fboundary), full(row + 2)
            else:
                diag_in, diag_d = Hb[k], Hd[k]
            is_mm = (dchar != qchar).to(i32)
            diag = torch.where(diag_in >= INF, INF, diag_in + is_mm * mismatch)
            diag_d = diag_d + is_mm
            E_in, E_in_d = (Eb[k + 1], Ed[k + 1]) if k + 1 < W else (
                e_edge, e_edge_d)
            pre = torch.minimum(diag, E_in)
            Hnew = torch.minimum(pre, Fv)
            b1 = diag <= Fv
            b2 = E_in <= torch.minimum(diag, Fv)
            hq = Hnew + Q
            b4 = hq <= Fv + R
            b8 = hq <= E_in + R
            Hd_new = torch.where(b2, E_in_d, torch.where(b1, diag_d, Fd))
            Enew = torch.clamp(torch.minimum(hq, E_in + R), max=INF)
            Ed_new = torch.where(b8, Hd_new + 1, E_in_d + 1)
            Fnew = torch.clamp(torch.minimum(Fv + R, pre + Q), max=INF)
            Fd_new = torch.where(b4, Hd_new + 1, Fd + 1)
            Hb[k] = torch.where(m_valid, Hnew, INF).to(i32)
            Eb[k] = torch.where(m_valid, Enew, INF).to(i32)
            Hd[k] = torch.where(m_valid, Hd_new, Hd[k])
            Ed[k] = torch.where(m_valid, Ed_new, Ed[k])
            Fv = torch.where(m_valid, Fnew, Fv)
            Fd = torch.where(m_valid, Fd_new, Fd)
            m_score = m_lastrow & (ql == i + 1)
            score = torch.where(m_score, Hnew, score)
            sdiff = torch.where(m_score, Hd_new, sdiff)

    ok = active & (score <= cutoff) & (sdiff <= d)
    return torch.where(ok, sdiff, -1).to(i32)


def d2_diffs(rows, lens, tq, td, B, mismatch, go, ge, d):
    """diffs[N] (int32, -1 = rejected) for directed tasks given by row
    indices: query rows[tq[t]], target rows[td[t]].

    rows: [n, Lmax] uint8 codes 0..3 (rows may be a column slice of a
    wider matrix); lens: [n] int32; tq/td: [N] int64.
    On the CPU this is d2_diffs_reference over the gathered rows; on a
    CUDA device it is the kernel of csrc/d2_diffs.cu, which reads the
    rows in place, 16 bytes at a time: a matrix whose row stride is not
    a multiple of 16 bytes is copied into one that is (row_stride_16).
    """
    global launches, warm
    if rows.dim() != 2 or rows.dtype != torch.uint8:
        raise ValueError("rows must be a [n, Lmax] uint8 tensor")
    if lens.dtype != torch.int32 or tq.dtype != torch.int64 or \
            td.dtype != torch.int64:
        raise ValueError("lens must be int32 and task indices int64")
    if tq.shape != td.shape or tq.dim() != 1 or lens.shape != rows.shape[:1]:
        raise ValueError("task index or length shapes disagree")
    if len({t.device for t in (rows, lens, tq, td)}) != 1:
        raise ValueError("rows, lengths and task indices must share a device")
    if rows.device.type == "cpu":
        return d2_diffs_reference(
            rows[tq], rows[td], lens[tq], lens[td], B, rows.shape[1],
            mismatch, go, ge, d)
    if rows.device.type != "cuda":
        raise ValueError(f"no d2_diffs kernel for device {rows.device}")

    from .._build import load

    lib = load()
    if B < 1 or 2 * B + 1 > lib.swarm_d2_max_w():
        raise ValueError(f"band B={B} is wider than the kernel takes")
    lens, tq, td = (t.contiguous() for t in (lens, tq, td))
    if rows.stride(1) != 1 or rows.stride(0) % 16 or rows.data_ptr() % 16:
        rows = row_stride_16(rows)
    out = torch.empty(tq.shape[0], dtype=torch.int32, device=rows.device)
    if tq.shape[0] == 0:
        return out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swarm_d2_diffs(
            rows.data_ptr(), rows.stride(0), lens.data_ptr(), tq.data_ptr(),
            td.data_ptr(), tq.shape[0], int(B), int(mismatch), int(go),
            int(ge), int(d), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"d2_diffs kernel launch failed: CUDA error {err}")
    launches += 1
    warm = True
    return out


def row_stride_16(rows):
    """`rows` ([n, L] uint8) as a view of a fresh zero-padded matrix
    whose row stride is a multiple of 16 bytes, the unit the kernel
    reads. Shape and values are those of `rows`."""
    n, L = rows.shape
    store = torch.zeros((n, max(-(-L // 16) * 16, 16)), dtype=torch.uint8,
                        device=rows.device)
    store[:, :L] = rows
    return store[:, :L]


def directions(abundances, pa, pb, no_break):
    """(need_ab, need_ba) bool arrays: the directions of the pairs that
    the abundance rule admits (swarm_native.c: d2_diffs_pairs), every
    one under no_break."""
    if no_break:
        return np.full(len(pa), True), np.full(len(pa), True)
    ab = np.asarray(abundances)
    return ab[pa] >= ab[pb], ab[pb] >= ab[pa]


def task_layout(pa, pb, need_ab, need_ba):
    """(tq, td) int64 arrays: the directed tasks of the admitted
    directions of the pairs (pa, pb), reverse block first: tq =
    [pb[need_ba], pa[need_ab]], td = [pa[need_ba], pb[need_ab]]. The
    diffs kernel does not care about the order; the network engine's CSR
    (d2_network.csr_partition) needs it. The device's layout,
    d2_network.d2_tasks, gives the same tasks in the same order."""
    tq = np.concatenate([pb[need_ba], pa[need_ab]]).astype(np.int64)
    td = np.concatenate([pa[need_ba], pb[need_ab]]).astype(np.int64)
    return tq, td


def native_tasks(db, pa, pb, d, mismatch, go, ge, no_break, nthreads=1):
    """DeviceDiffEngine.diff_tasks' (tq, td, diffs) as CPU tensors, the
    diffs from the native host kernel (_native.d2_diffs_pairs on
    `nthreads` threads)."""
    from .. import _native

    need_ab, need_ba = directions(db.abundances, pa, pb, no_break)
    tq, td = task_layout(pa, pb, need_ab, need_ba)
    metrics.record(**{"d2_network.alignments": len(tq)})
    diff_ab, diff_ba = _native.d2_diffs_pairs(
        db.codes, db.offsets, db.lengths, db.abundances, pa, pb, d,
        mismatch, go, ge, no_break, nthreads=nthreads)
    diffs = np.concatenate([diff_ba[need_ba], diff_ab[need_ab]])
    return (torch.from_numpy(tq), torch.from_numpy(td),
            torch.from_numpy(diffs.astype(np.int32)))


class DeviceDiffEngine:
    """Directed diff tasks through d2_diffs on one device.

    Construction uploads the padded code rows once, at a row stride of
    a multiple of 16 bytes (`rows` is the [n, Lmax] view of it, so the
    plain version sees the same matrix as before), and the abundances
    (int64); diff_tasks() lays the tasks out on the device and leaves
    them and their diffs there.
    """

    def __init__(self, db, d: int, device: torch.device):
        from .neighbors import pad_codes

        self.d = int(d)
        self.n = len(db)
        self.device = torch.device(device)
        self.Lmax = max(int(db.longest), 1)
        stride = -(-self.Lmax // 16) * 16
        rows = pad_codes(db.codes, db.offsets, db.lengths, stride)
        self.rows = torch.from_numpy(rows).to(self.device)[:, :self.Lmax]
        self.lens = torch.from_numpy(
            np.ascontiguousarray(db.lengths, dtype=np.int32)).to(self.device)
        self.abundances = torch.from_numpy(
            np.asarray(db.abundances, dtype=np.int64)).to(self.device)

    @staticmethod
    def band_for_exact(cutoff: int, go: int, ge: int) -> int:
        # mirror swarm_native.c:band_for_exact
        need = cutoff + go + 2 * ge + 1 - go
        B = -(-need // ge)
        return max(B, 1)

    def diff_tasks(self, ga, gb, mismatch, go, ge, no_break):
        """(tq, td, diffs) on the device: the directed tasks of the pairs
        (ga, gb), [N] int32 on the device, a < b, that the abundance rule
        admits, int64, in task_layout's order (d2_network.d2_tasks), and
        their diffs, int32 (-1 = rejected). Raises AssertionError, before
        the diffs launch, where a pair index lies outside [0, n) or a >=
        b: a decode bug must fail here, not corrupt clusters."""
        from .d2_network import d2_tasks, pair_fault

        cutoff = self.d * max(mismatch, go + ge)
        B = self.band_for_exact(cutoff, go, ge)
        tq, td, bad = d2_tasks(ga, gb, self.abundances, self.n, no_break)
        if bad:
            raise pair_fault(ga, gb, self.n)
        metrics.record(**{"d2_network.alignments": len(tq)})
        diffs = d2_diffs(self.rows, self.lens, tq, td, B, int(mismatch),
                         int(go), int(ge), self.d)
        return tq, td, diffs
