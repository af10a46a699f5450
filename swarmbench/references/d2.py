"""Plain reference of swarm's d >= 2 clustering, in torch.

It follows swarm's published semantics (src/algo.cc, src/search8.cc,
src/utils/backtrack.h of torognes/swarm) and imports nothing of the
program under test. From the corpus the benchmark generated it works out
again everything the program derives, and writes the streams -o, -s,
-i and -w as swarm does, so that they can be compared byte for byte.

1. Amplicon order: abundance descending, then header bytes ascending.
2. Candidate pairs by the pigeonhole principle: an alignment with at
   most d edits leaves one of d + 1 disjoint pieces of w bases of the
   first row (w = min(32, shortest // (d + 1))) unedited, found in the
   other row at a start shifted by at most d. Every pair that shares
   such a piece, and whose lengths differ by at most d, is a candidate:
   the candidates hold every pair within d edits.
3. Unit edit distance in a band of d: exact up to d. A pair over d
   cannot have d or fewer differences, which count the edits of one
   alignment. Rows of one length that differ in at most d places are
   within d edits without it.
4. swarm's differences: the cost-space global alignment (mismatch
   2m + 2p, gap open 2g, extension m + 2e, over their gcd), its
   direction bits and tie-broken backtrack as search8/backtrack.h give
   them, in a band of B = floor(C / extension) slots on each side of the
   diagonal, C = d * max(mismatch, open + extension). Exactness: a path
   through a cell outside the band pays at least open + (B + 1) *
   extension > open + C. Every value at or below open + C is therefore
   the full matrix's, and so is every direction bit the backtrack reads
   on a path of cost at most C (its cells cost at most C; a bit there
   compares values of which the smaller is at most open + C, or one is
   at most C and the other beyond open + C). A pair is an edge when its
   score is at most C and its difference count at most d (a path with
   d differences costs at most C; a score over C has a path over d).
   A pair of rows of one length that differ in h <= d places, where
   h * mismatch < 2 * (open + extension), needs no matrix: an alignment
   of two rows of one length that has a gap has at least two, so the
   gapless one (cost h * mismatch) is the only one of least cost, at
   every cell of its path too; the backtrack walks it, and its
   differences are the h mismatches.
5. Directed edges: q -> t when abundance(q) >= abundance(t) (no -n),
   the difference count of q aligned against t.
6. Swarms: the swarm of an amplicon is the lowest amplicon id from which
   it is reachable (seeds are taken in id order, and an earlier seed
   claims everything it reaches); generation = breadth-first depth from
   the seed inside its swarm; parent = the lowest-id amplicon of the
   previous generation with an edge to it; members in (generation, id)
   order, structure rows in (generation, parent, id) order; the
   iteration count of a swarm is at least 1 (src/algo.cc).

The harness wraps the program's network engine named in ``ENGINE`` and
hands what it returned to ``program_edges``: those edges and their
difference counts are compared with step 5's.

``control=True`` replaces step 4 by the unit edit distance of step 3
(diff := edit distance): a cheaper kernel that breaks the configuration's
guarantee that edges and differences are those of swarm's scored
alignment. The benchmark's test holds that it fails the comparison.
"""

import math
from dataclasses import dataclass

import torch

from swarmbench import text

#: the program's engine whose answers are compared with step 5's edges
ENGINE = ("swarm_tpu_torch.ops.d2_network", "D2NetworkEngine",
          "build_adjacency")

INF = 1 << 20
ED_BLOCK = 1 << 22      # pairs an edit-distance pass holds at once
SCORED_BLOCK = 1 << 20  # alignments a scored pass (and its bits) holds
BIT_UP, BIT_LEFT, BIT_EXTUP, BIT_EXTLEFT = 1, 2, 4, 8


def cost_model(scoring):
    """(mismatch, gap open, gap extension) in swarm's cost space."""
    m = scoring["match_reward"]
    p = scoring["mismatch_penalty"]
    g = scoring["gap_opening_penalty"]
    e = scoring["gap_extension_penalty"]
    mm, go, ge = 2 * m + 2 * p, 2 * g, m + 2 * e
    f = math.gcd(math.gcd(mm, go), ge)
    return mm // f, go // f, ge // f


def abundance_order(headers, abundances):
    """Amplicon ids: file rows sorted by abundance descending, then by
    header bytes ascending (headers: [n, w] uint8, zero past the end)."""
    chars = headers.to(torch.int64)
    n, w = chars.shape
    words = -(-w // 7)
    padded = torch.zeros((n, words * 7), dtype=torch.int64,
                         device=chars.device)
    padded[:, :w] = chars
    shifts = 8 * torch.arange(6, -1, -1, device=chars.device)
    keys = (padded.view(n, words, 7) << shifts).sum(-1)  # big-endian
    order = torch.arange(n, device=chars.device)
    for k in range(words - 1, -1, -1):
        order = order[torch.sort(keys[order, k], stable=True).indices]
    order = order[torch.sort(-abundances[order], stable=True).indices]
    return order


def _pack(codes, start, w):
    """Key of the w bases from column `start` of every row."""
    cols = codes[:, start:start + w].to(torch.int64)
    shifts = 2 * torch.arange(w, device=codes.device)
    return (cols << shifts).sum(1)


def candidate_pairs(codes, lengths, d):
    """Unordered pairs (a < b) that share a piece (step 2), with lengths
    within d of each other: int64 tensors."""
    n = len(lengths)
    dev = codes.device
    shortest = int(lengths.min()) if n else 0
    w = min(32, shortest // (d + 1))
    if w < 1:
        raise ValueError(f"rows of {shortest} nt leave no piece at d={d}")
    found = torch.zeros(0, dtype=torch.int64, device=dev)
    ids = torch.arange(n, device=dev)
    for k in range(d + 1):
        s = k * w
        q = _pack(codes, s, w)
        q_sorted, q_ids = torch.sort(q)
        for delta in range(-d, d + 1):
            t = s + delta
            if t < 0 or t + w > codes.shape[1]:
                continue
            ok = lengths >= t + w
            key = _pack(codes, t, w)[ok]
            rows = ids[ok]
            lo = torch.searchsorted(q_sorted, key, side="left")
            hi = torch.searchsorted(q_sorted, key, side="right")
            count = hi - lo
            total = int(count.sum())
            if not total:
                continue
            which = torch.repeat_interleave(
                torch.arange(len(key), device=dev), count)
            first = torch.cumsum(count, 0) - count
            pos = lo[which] + torch.arange(total, device=dev) - first[which]
            a = q_ids[pos]
            b = rows[which]
            keep = (a != b) & ((lengths[a] - lengths[b]).abs() <= d)
            a, b = a[keep], b[keep]
            pair = torch.minimum(a, b) * n + torch.maximum(a, b)
            found = torch.unique(torch.cat([found, pair]))
    return found // n, found % n


def edit_distance(codes, lengths, pa, pb, d):
    """Unit edit distance of each pair, exact up to d and d + 1 above."""
    out = []
    for s in range(0, len(pa), ED_BLOCK):
        out.append(_edit_distance(codes, lengths, pa[s:s + ED_BLOCK],
                                  pb[s:s + ED_BLOCK], d))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=codes.device)
    return torch.cat(out)


def _edit_distance(codes, lengths, pa, pb, d):
    dev = codes.device
    P = len(pa)
    S = 2 * d + 1
    q, t = codes[pa], codes[pb]
    ql, tl = lengths[pa], lengths[pb]
    Lq = q.shape[1]
    big = d + 1
    k = torch.arange(S, device=dev)
    # row 0: D[0][c] = c; slot k is column k - d
    col0 = k - d
    prev = torch.where(col0 >= 0, col0, INF).to(torch.int32).expand(
        P, S).clone()
    result = torch.full((P,), big, dtype=torch.int32, device=dev)
    for r in range(1, int(tl.max()) + 1 if P else 1):
        tc = t[:, r - 1]
        cur = torch.empty_like(prev)
        for j in range(S):
            c = r + j - d
            if c < 0:
                cur[:, j] = INF
                continue
            if c == 0:
                cur[:, j] = r
                continue
            if c - 1 < Lq:
                sub = (tc != q[:, c - 1]).to(torch.int32)
            else:
                sub = torch.ones(P, dtype=torch.int32, device=dev)
            best = prev[:, j] + sub
            if j + 1 < S:
                best = torch.minimum(best, prev[:, j + 1] + 1)
            if j > 0:
                best = torch.minimum(best, cur[:, j - 1] + 1)
            cur[:, j] = best.clamp(max=INF)
        prev = cur
        at = tl == r
        if at.any():
            slot = (ql - tl + d).clamp(0, S - 1)
            val = cur.gather(1, slot[:, None]).squeeze(1)
            result = torch.where(at, val.clamp(max=big), result)
    return result.to(torch.int64)


def mismatches(codes, tq, tt):
    """Places in which rows tq[i] and tt[i] differ (rows of one length)."""
    out = [(codes[tq[s:s + ED_BLOCK]] != codes[tt[s:s + ED_BLOCK]]).sum(1)
           for s in range(0, len(tq), ED_BLOCK)]
    return torch.cat(out) if out else torch.zeros(
        0, dtype=torch.int64, device=codes.device)


def scored_diffs(codes, lengths, tq, tt, d, mm, go, ge):
    """swarm's differences of query tq[i] against target tt[i] (step 4):
    (diffs, accepted) int64 and bool tensors."""
    Qc = go + ge
    C = d * max(mm, Qc)
    B = C // ge
    dev = codes.device
    diffs = torch.zeros(len(tq), dtype=torch.int64, device=dev)
    ok = torch.zeros(len(tq), dtype=torch.bool, device=dev)
    one = torch.nonzero(lengths[tq] == lengths[tt]).squeeze(1)
    h = mismatches(codes, tq[one], tt[one])
    gapless = (h <= d) & (h * mm < 2 * Qc)
    diffs[one[gapless]] = h[gapless]
    ok[one[gapless]] = True
    todo = torch.ones(len(tq), dtype=torch.bool, device=dev)
    todo[one[gapless]] = False
    todo = torch.nonzero(todo).squeeze(1)
    for s in range(0, len(todo), SCORED_BLOCK):
        at = todo[s:s + SCORED_BLOCK]
        diffs[at], ok[at] = _scored(codes, lengths, tq[at], tt[at], d, mm,
                                    go, ge, B, C)
    return diffs, ok


def _scored(codes, lengths, tq, tt, d, mm, go, ge, B, C):
    dev = codes.device
    P = len(tq)
    S = 2 * B + 1
    Q = go + ge
    R = ge
    q, t = codes[tq], codes[tt]
    ql, tl = lengths[tq], lengths[tt]
    Lq, Lt = q.shape[1], int(tl.max())
    i32 = torch.int32
    k = torch.arange(S, device=dev)
    # the row before row 0: slot s is column s - B - 1
    col = k - B - 1
    H = torch.where(col >= 0, Q + col * R, INF).to(i32).expand(P, S).clone()
    E = torch.where(col >= 0, 2 * Q + col * R, INF).to(i32).expand(
        P, S).clone()
    dirs = torch.empty((P, Lt, S), dtype=torch.uint8, device=dev)
    score = torch.full((P,), INF, dtype=i32, device=dev)
    inf_col = torch.full((P, 1), INF, dtype=i32, device=dev)
    end_slot = (ql - tl + B).clamp(0, S - 1)
    for j in range(Lt):
        i = j + k - B  # the query column of each slot
        valid = (i >= 0) & (i < Lq)
        qi = q[:, i.clamp(0, Lq - 1)]
        V = torch.where(qi == t[:, j:j + 1], 0, mm).to(i32)
        bound = 0 if j == 0 else go + j * ge
        diag_in = torch.where(i == 0, bound, H)
        diag_in = torch.where(i < 0, INF, diag_in)
        diag = (diag_in + V).clamp(max=INF)
        E_in = torch.cat([E[:, 1:], inf_col], 1)
        pre = torch.minimum(diag, E_in)
        fb = 2 * go + (j + 2) * ge
        A = pre + (Q - (k + 1) * R).to(i32)
        run = torch.cummin(A, 1).values
        F_in = (fb + i * R).to(i32).expand(P, S)
        F_in = torch.cat([F_in[:, :1], torch.minimum(
            F_in[:, 1:], run[:, :-1] + (k[1:] * R).to(i32))], 1)
        F_in = torch.where(i < 0, INF, F_in).clamp(max=INF)
        Hn = torch.minimum(pre, F_in)
        hq = Hn + Q
        bits = ((diag <= F_in).to(torch.uint8) * BIT_UP
                | (E_in <= torch.minimum(diag, F_in)).to(torch.uint8)
                * BIT_LEFT
                | (hq <= F_in + R).to(torch.uint8) * BIT_EXTUP
                | (hq <= E_in + R).to(torch.uint8) * BIT_EXTLEFT)
        dirs[:, j] = bits
        H = torch.where(valid, Hn, INF).clamp(max=INF)
        E = torch.where(valid, torch.minimum(hq, E_in + R), INF).clamp(
            max=INF)
        at = tl == j + 1
        score = torch.where(at, Hn.gather(1, end_slot[:, None]).squeeze(1),
                            score)
    # backtrack (src/utils/backtrack.h), every pair at once
    column, row = ql - 1, tl - 1
    aligned = torch.zeros(P, dtype=torch.int64, device=dev)
    matches = torch.zeros_like(aligned)
    op = torch.zeros_like(aligned)  # 0 none, 1 insertion, 2 deletion, 3 match
    outside = torch.zeros(P, dtype=torch.bool, device=dev)
    rows_of = torch.arange(P, device=dev)
    for _ in range(Lq + Lt):
        active = (column >= 0) & (row >= 0) & ~outside
        if not active.any():
            break
        slot = column - row + B
        out = active & ((slot < 0) | (slot >= S))
        outside |= out
        active &= ~out
        cell = dirs[rows_of, row.clamp(min=0), slot.clamp(0, S - 1)].to(
            torch.int64)
        c1 = (op == 1) & ((cell & BIT_EXTLEFT) == 0)
        c2 = ~c1 & (op == 2) & ((cell & BIT_EXTUP) == 0)
        c3 = ~c1 & ~c2 & ((cell & BIT_LEFT) != 0)
        c4 = ~c1 & ~c2 & ~c3 & ((cell & BIT_UP) == 0)
        c5 = ~c1 & ~c2 & ~c3 & ~c4
        same = q[rows_of, column.clamp(min=0)] == t[rows_of, row.clamp(min=0)]
        matches += (active & c5 & same).to(torch.int64)
        aligned += active.to(torch.int64)
        row = row - (active & (c1 | c3 | c5)).to(torch.int64)
        column = column - (active & (c2 | c4 | c5)).to(torch.int64)
        op = torch.where(active & c3, 1, op)
        op = torch.where(active & c4, 2, op)
        op = torch.where(active & c5, 3, op)
    aligned += column + 1 + row + 1
    diffs = aligned - matches
    accepted = (score.to(torch.int64) <= C) & (diffs <= d) & ~outside
    if (outside & (score.to(torch.int64) <= C)).any():
        raise AssertionError("a path of cost <= C left the band: the "
                             "band's proof does not hold")
    return diffs, accepted


@dataclass
class Swarms:
    """Step 6's result over amplicon ids (abundance order)."""

    order: torch.Tensor     # members, swarm after swarm
    swarm_of: torch.Tensor  # [n] the seed of each amplicon's swarm
    gen: torch.Tensor       # [n]
    parent: torch.Tensor    # [n] -1 for seeds
    pdiff: torch.Tensor     # [n] difference count of the parent's edge
    rad: torch.Tensor       # [n]
    seeds: torch.Tensor     # seeds in id order: swarm k is seeds[k]
    struct: torch.Tensor    # non-seed amplicons in structure-row order


def swarms(n, src, dst, diff, device):
    """The swarms of the directed edges src -> dst (step 6)."""
    ids = torch.arange(n, device=device)
    low = ids.clone()
    while True:  # lowest id that reaches each amplicon
        new = low.scatter_reduce(0, dst, low[src], reduce="amin")
        if torch.equal(new, low):
            break
        low = new
    seeds = torch.nonzero(low == ids).squeeze(1)
    inside = low[src] == low[dst]
    s, t, dd = src[inside], dst[inside], diff[inside]
    gen = torch.full((n,), INF, dtype=torch.int64, device=device)
    gen[seeds] = 0
    g = 0
    while True:
        step = (gen[s] == g) & (gen[t] == INF)
        if not step.any():
            break
        gen[t[step]] = g + 1
        g += 1
    # edges from the previous generation; the lowest-id parent claims
    up = gen[t] == gen[s] + 1
    s, t, dd = s[up], t[up], dd[up]
    parent = torch.full((n,), n, dtype=torch.int64, device=device)
    parent = parent.scatter_reduce(0, t, s, reduce="amin")
    mine = parent[t] == s
    pdiff = torch.zeros(n, dtype=torch.int64, device=device)
    pdiff[t[mine]] = dd[mine]
    parent[seeds] = -1
    rad = torch.zeros(n, dtype=torch.int64, device=device)
    for level in range(1, g + 1):
        at = torch.nonzero(gen == level).squeeze(1)
        rad[at] = rad[parent[at]] + pdiff[at]
    order = ids
    for key in (gen, low):
        order = order[torch.sort(key[order], stable=True).indices]
    struct = ids[gen > 0]
    for key in (parent, gen, low):
        struct = struct[torch.sort(key[struct], stable=True).indices]
    return Swarms(order=order, swarm_of=low, gen=gen, parent=parent,
                  pdiff=pdiff, rad=rad, seeds=seeds, struct=struct)


def _field(chars, lens, idx):
    return chars[idx], lens[idx]


def write_streams(sw, headers, abundances, codes, lengths, outputs):
    """swarm's -o, -s, -i, -w streams (bytes) of the swarms `sw`.

    headers: (chars, lens) of each amplicon (id order) as written,
    "<label>_<abundance>"; outputs: which of "-o", "-s", "-i", "-w"."""
    chars, hlens = headers
    dev = chars.device
    n = len(hlens)
    # print_id_noabundance: the header up to its abundance suffix
    ab_chars, ab_lens = text.decimal(abundances)
    llens = hlens - 1 - ab_lens
    index = torch.full((n,), -1, dtype=torch.int64, device=dev)
    index[sw.seeds] = torch.arange(len(sw.seeds), device=dev)
    streams = {}
    if "-o" in outputs:
        last = torch.ones(n, dtype=torch.bool, device=dev)
        if n > 1:
            last[:-1] = sw.swarm_of[sw.order[1:]] != sw.swarm_of[sw.order[:-1]]
        sep = torch.where(last, ord("\n"), ord(" ")).to(torch.uint8)[:, None]
        buf, _, _ = text.join([_field(chars, hlens, sw.order),
                               (sep, torch.ones_like(hlens))], n, dev)
        streams["-o"] = buf
    mass = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, sw.swarm_of, abundances)[sw.seeds]
    if "-s" in outputs:
        size = torch.bincount(sw.swarm_of, minlength=n)[sw.seeds]
        single = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, sw.swarm_of, (abundances == 1).to(torch.int64))[sw.seeds]
        maxgen = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce(
            0, sw.swarm_of, sw.gen, reduce="amax")[sw.seeds].clamp(min=1)
        maxrad = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce(
            0, sw.swarm_of, sw.rad, reduce="amax")[sw.seeds]
        m = len(sw.seeds)
        buf, _, _ = text.join([
            text.decimal(size), b"\t", text.decimal(mass), b"\t",
            _field(chars, llens, sw.seeds), b"\t",
            text.decimal(abundances[sw.seeds]), b"\t", text.decimal(single),
            b"\t", text.decimal(maxgen), b"\t", text.decimal(maxrad), b"\n"],
            m, dev)
        streams["-s"] = buf
    if "-i" in outputs:
        c = sw.struct
        buf, _, _ = text.join([
            _field(chars, llens, sw.parent[c]), b"\t",
            _field(chars, llens, c), b"\t", text.decimal(sw.pdiff[c]), b"\t",
            text.decimal(index[sw.swarm_of[c]] + 1), b"\t",
            text.decimal(sw.gen[c]), b"\n"], len(c), dev)
        streams["-i"] = buf
    if "-w" in outputs:
        # mass descending, then header bytes (the order of swarm's seeds
        # among equal masses is left to its sort: compared as a set)
        by_header = abundance_order(chars[sw.seeds], mass)
        seeds = sw.seeds[by_header]
        buf, _, _ = text.join([
            b">", _field(chars, llens, seeds), b"_",
            text.decimal(mass[by_header]), b"\n",
            text.codes_field(codes[seeds], lengths[seeds]), b"\n"],
            len(seeds), dev)
        streams["-w"] = buf
    return streams


@dataclass
class Result:
    """The reference's answer for one corpus."""

    edges: tuple        # (src, dst, diff) int64, sorted by (src, dst)
    streams: dict       # "-o" ... -> uint8 tensor
    sorted_rows: torch.Tensor  # file row of each amplicon id
    counts: dict        # candidates, within_d, tasks, edges


def program_edges(out):
    """(src, dst, diff) of the CSR lists the program's engine returned."""
    import numpy as np

    adj_start, adj_count, adj_to, adj_diff = out[:4]
    src = np.repeat(np.arange(len(adj_count), dtype=np.int64), adj_count)
    return (src, np.asarray(adj_to, dtype=np.int64),
            np.asarray(adj_diff, dtype=np.int64))


def cluster(corpus, config, device, control=False):
    """The reference's edges and streams for a corpus (corpus.Corpus)
    under a configuration (its d, scoring and outputs)."""
    d, scoring, outputs = config["d"], config["scoring"], config["outputs"]
    dev = torch.device(device)
    chars, hlens = corpus.headers(dev)
    abund = corpus.abundances.to(dev)
    order = abundance_order(chars, abund)
    chars, hlens, abund = chars[order], hlens[order], abund[order]
    codes = corpus.codes.to(dev)[order]
    lengths = corpus.lengths.to(dev)[order]
    n = len(lengths)
    mm, go, ge = cost_model(scoring)
    pa, pb = candidate_pairs(codes, lengths, d)
    if control:
        ed = edit_distance(codes, lengths, pa, pb, d)
        near = ed <= d
        ed = ed[near]
    else:
        # rows of one length that differ in at most d places lie within
        # d edits: only the others need the band of step 3
        near = torch.zeros(len(pa), dtype=torch.bool, device=dev)
        one = torch.nonzero(lengths[pa] == lengths[pb]).squeeze(1)
        near[one[mismatches(codes, pa[one], pb[one]) <= d]] = True
        rest = torch.nonzero(~near).squeeze(1)
        near[rest] = edit_distance(codes, lengths, pa[rest], pb[rest],
                                   d) <= d
    pa, pb = pa[near], pb[near]
    # a -> b always (a < b: abundance(a) >= abundance(b)); b -> a on ties
    back = abund[pa] == abund[pb]
    tq = torch.cat([pa, pb[back]])
    tt = torch.cat([pb, pa[back]])
    if control:
        diffs = torch.cat([ed, ed[back]])
        ok = torch.ones_like(diffs, dtype=torch.bool)
    else:
        diffs, ok = scored_diffs(codes, lengths, tq, tt, d, mm, go, ge)
    src, dst, dd = tq[ok], tt[ok], diffs[ok]
    key = torch.sort(src * n + dst).indices
    src, dst, dd = src[key], dst[key], dd[key]
    sw = swarms(n, src, dst, dd, dev)
    streams = write_streams(sw, (chars, hlens), abund, codes, lengths,
                            outputs)
    return Result(edges=(src, dst, dd), streams=streams, sorted_rows=order,
                  counts={"candidates": len(near), "within_d": len(pa),
                          "tasks": len(tq), "edges": len(src)})
