"""Plain reference of swarm's -d 1 -f (the d = 1 network, then the
fastidious graft), in torch.

It follows swarm 3's published semantics (src/algod1.cc of
torognes/swarm; Mahe et al. 2014, PeerJ 2:e593 and 2015, PeerJ 3:e1420)
and imports nothing of the program under test. From the corpus the
benchmark generated it works out again everything the program derives,
and writes the streams -o, -s, -i and -w as swarm does, so that they can
be compared byte for byte. The building blocks it shares with the d >= 2
reference (references/d2.py) are exact: the amplicon order, the
pigeonhole candidates, the banded edit distance and the swarms of a set
of directed edges.

1. Amplicon order: abundance descending, then header bytes ascending.
2. The d = 1 network: every pair at unit edit distance exactly 1 (one
   substitution, insertion or deletion). Candidates are d2.py's step 2
   at d = 1 (two pieces of the first row, each found in the other row
   shifted by at most 1: they hold every pair within 1). A candidate of
   two rows of one length is an edge when they differ in exactly one
   place (a gap between rows of one length takes two edits), one of two
   lengths when the banded edit distance is 1. Nothing but a full
   comparison decides an edge. swarm finds the same pairs by hashing
   every microvariant of each amplicon and comparing the sequences a
   hash meets; here no hash takes part.
3. Directed edges: q -> t when abundance(q) >= abundance(t) (no -n), so
   both ways on ties.
4. Swarms: d2.py's step 6 on those edges. Seeds are taken in id order,
   a generation's new members in id order, and a member's parent is the
   lowest id of the previous generation with an edge to it; this is
   swarm's breadth-first growth at d = 1, whose generations join in
   amplicon order. Members are listed by generation, then id.
5. The graft (-f, boundary -b 3): a swarm is light when its mass (the
   sum of its abundances) is below 3, else heavy; with no light swarm
   or no heavy one nothing is grafted. For every amplicon of a light
   swarm, its candidate is the lowest-id amplicon of a heavy swarm
   within unit edit distance 2. Candidates: d2.py's step 2 at d = 2,
   with the pieces taken from the light rows and looked for in the heavy
   rows only; within 2 is decided as in step 2 (rows of one length that
   differ in at most 2 places, else the banded edit distance). swarm
   finds these pairs through a shared microvariant (a Bloom filter and a
   hash table of the light amplicons' variants, probed with the heavy
   amplicons' variants); a pair within 2 has one, a pair beyond it none.
   The pairs (candidate, light amplicon) are taken in ascending order,
   and each light swarm is grafted once, at its first pair: its members,
   in their own order, are appended to the heavy swarm of the candidate.
6. Streams, of the swarms left after grafting, in the order of their
   seeds: -o the members, each light swarm after the heavy swarm it was
   grafted to, in the order of the grafts; -s size, mass, the seed's
   label and abundance, the amplicons of abundance 1 (grafted ones
   included), and in columns 6 and 7 the heavy swarm's own largest
   generation (at d = 1 a member's radius is its generation); -i each
   member after the first, its graft line first where it is the graft's
   light amplicon ("candidate, amplicon, 2, swarm, generation of the
   candidate + 1") and then its own line ("parent, amplicon, 1, swarm,
   generation") where it has a parent; -w the seeds, mass descending,
   then the label (compared by mass and as a set, check.py).

The harness wraps the program's network builder named in ``ENGINE`` and
hands what it returned to ``program_edges``: the network's directed
edges, each with the difference 1, are compared with step 3's. The
streams compare the graft.

``control=True`` replaces the unit edit distance by the Hamming distance
(rows of one length that differ in 1, or in at most 2, places), in the
network and in the graft: a cheaper comparison that breaks the
configuration's guarantees by losing every edge and every graft that
takes an insertion or a deletion.
"""

import torch

from swarmbench import text
from swarmbench.references.d2 import (ED_BLOCK, Result, Swarms,
                                      abundance_order, candidate_pairs,
                                      edit_distance, mismatches, swarms,
                                      write_streams)

#: the program's engine whose answers are compared with step 3's edges
ENGINE = ("swarm_tpu_torch.ops.neighbors", "NeighborIndex", "build_network")

#: swarm's default -b: a swarm of a smaller mass is light
BOUNDARY = 3
#: most differences between a light amplicon and its graft candidate
GRAFT_D = 2


def program_edges(out):
    """(src, dst, diff) of the edge lists the program's builder
    returned: every edge of the d = 1 network has one difference."""
    import numpy as np

    ef, et = out[:2]
    ef = np.asarray(ef, dtype=np.int64)
    return ef, np.asarray(et, dtype=np.int64), np.ones_like(ef)


def within(codes, lengths, pa, pb, d, exact, control=False):
    """[P] bool: pairs (pa, pb) within d edits (exactly d where `exact`);
    with `control`, rows of one length within d mismatches instead."""
    dev = codes.device
    same = lengths[pa] == lengths[pb]
    one = torch.nonzero(same).squeeze(1)
    h = mismatches(codes, pa[one], pb[one])
    near = torch.zeros(len(pa), dtype=torch.bool, device=dev)
    near[one] = (h == d) if exact else (h <= d)
    if control:
        return near
    # rows of one length beyond d mismatches may still lie within d
    # edits (an insertion and a deletion); rows of two lengths need the
    # band
    rest = torch.nonzero(~near & ~same if exact else ~near).squeeze(1)
    if len(rest):
        ed = edit_distance(codes, lengths, pa[rest], pb[rest], d)
        near[rest] = (ed == d) if exact else (ed <= d)
    return near


def cross_candidates(codes, lengths, light, heavy, d):
    """(l, h): every pair of a light row and a heavy row that share a
    piece of step 2 (the light row's pieces, found in the heavy row
    shifted by at most d), with lengths within d; pairs listed once."""
    dev = codes.device
    n = len(lengths)
    shortest = int(lengths.min())
    w = min(32, shortest // (d + 1))
    if w < 1:
        raise ValueError(f"rows of {shortest} nt leave no piece at d={d}")
    shifts = 2 * torch.arange(w, device=dev)
    found = torch.zeros(0, dtype=torch.int64, device=dev)
    for k in range(d + 1):
        s = k * w
        q = (codes[light, s:s + w].to(torch.int64) << shifts).sum(1)
        q_sorted, q_at = torch.sort(q)
        for delta in range(-d, d + 1):
            t = s + delta
            if t < 0 or t + w > codes.shape[1]:
                continue
            rows = heavy[lengths[heavy] >= t + w]
            key = (codes[rows, t:t + w].to(torch.int64) << shifts).sum(1)
            lo = torch.searchsorted(q_sorted, key, side="left")
            count = torch.searchsorted(q_sorted, key, side="right") - lo
            total = int(count.sum())
            if not total:
                continue
            which = torch.repeat_interleave(
                torch.arange(len(key), device=dev), count)
            first = torch.cumsum(count, 0) - count
            pos = lo[which] + torch.arange(total, device=dev) - first[which]
            a, b = light[q_at[pos]], rows[which]
            keep = (lengths[a] - lengths[b]).abs() <= d
            found = torch.unique(torch.cat([found, a[keep] * n + b[keep]]))
    return found // n, found % n


def graft_candidates(codes, lengths, light, heavy, n, control=False):
    """(cand, pairs): cand [n] int64, each light amplicon's lowest-id
    heavy amplicon within GRAFT_D edits, -1 where none (step 5); pairs,
    the candidate pairs compared."""
    dev = codes.device
    best = torch.full((n,), n, dtype=torch.int64, device=dev)
    la, hb = cross_candidates(codes, lengths, light, heavy, GRAFT_D)
    for s in range(0, len(la), ED_BLOCK):
        a, b = la[s:s + ED_BLOCK], hb[s:s + ED_BLOCK]
        ok = within(codes, lengths, a, b, GRAFT_D, exact=False,
                    control=control)
        best.scatter_reduce_(0, a[ok], b[ok], reduce="amin")
    return torch.where(best == n, -1, best), len(la)


def graft(swarm_of, cand, n):
    """Step 5's grafts: (final [n] the seed of each amplicon's swarm
    after grafting, block [n] 0 for a swarm's own members, else 1 + the
    rank of the graft that brought them, chosen [n] bool: the light
    amplicon of a graft)."""
    dev = swarm_of.device
    chosen = torch.zeros(n, dtype=torch.bool, device=dev)
    block = torch.zeros(n, dtype=torch.int64, device=dev)
    lights = torch.nonzero(cand >= 0).squeeze(1)
    if not len(lights):
        return swarm_of, block, chosen
    # each light swarm's first pair (candidate, light amplicon)
    key = cand[lights] * n + lights
    first = torch.full((n,), n * n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, swarm_of[lights], key, reduce="amin")
    pick = lights[first[swarm_of[lights]] == key]
    pick = pick[torch.argsort(cand[pick] * n + pick)]
    chosen[pick] = True
    rank = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rank[swarm_of[pick]] = torch.arange(len(pick), device=dev)
    heavy = torch.full((n,), -1, dtype=torch.int64, device=dev)
    heavy[swarm_of[pick]] = swarm_of[cand[pick]]
    grafted = rank[swarm_of] >= 0
    final = swarm_of.clone()
    final[grafted] = heavy[swarm_of[grafted]]
    block[grafted] = 1 + rank[swarm_of[grafted]]
    return final, block, chosen


def write_d1_streams(sw, final, block, chosen, cand, headers, abund, codes,
                     lengths, outputs):
    """Step 6's streams (uint8 tensors) of the swarms `sw` after the
    grafts (`final`, `block`, `chosen` of graft(), `cand` of
    graft_candidates())."""
    chars, hlens = headers
    dev = chars.device
    n = len(hlens)
    kept = torch.nonzero(final == torch.arange(n, device=dev)).squeeze(1)
    # members: by final swarm, then graft block, then the order of step 4
    pos = torch.empty(n, dtype=torch.int64, device=dev)
    pos[sw.order] = torch.arange(n, device=dev)
    order = sw.order
    for key in (block, final):
        order = order[torch.sort(key[order], stable=True).indices]
    after = Swarms(order=order, swarm_of=final, gen=sw.gen,
                   parent=sw.parent, pdiff=sw.pdiff, rad=sw.rad, seeds=kept,
                   struct=None)
    streams = write_streams(after, headers, abund, codes, lengths,
                            [f for f in outputs if f in ("-o", "-w")])
    ab_chars, ab_lens = text.decimal(abund)
    llens = hlens - 1 - ab_lens
    index = torch.full((n,), -1, dtype=torch.int64, device=dev)
    index[kept] = torch.arange(len(kept), device=dev)
    if "-s" in outputs:
        zeros = torch.zeros(n, dtype=torch.int64, device=dev)
        size = torch.bincount(final, minlength=n)[kept]
        mass = zeros.index_add(0, final, abund)[kept]
        single = zeros.index_add(0, final, (abund == 1).to(torch.int64))[kept]
        maxgen = zeros.scatter_reduce(0, sw.swarm_of, sw.gen,
                                      reduce="amax")[kept]
        buf, _, _ = text.join([
            text.decimal(size), b"\t", text.decimal(mass), b"\t",
            (chars[kept], llens[kept]), b"\t", text.decimal(abund[kept]),
            b"\t", text.decimal(single), b"\t", text.decimal(maxgen), b"\t",
            text.decimal(maxgen), b"\n"], len(kept), dev)
        streams["-s"] = buf
    if "-i" in outputs:
        rank = torch.empty(n, dtype=torch.int64, device=dev)
        rank[order] = torch.arange(n, device=dev)
        graft_of = torch.nonzero(chosen).squeeze(1)
        child_of = torch.nonzero(sw.parent >= 0).squeeze(1)
        child = torch.cat([graft_of, child_of])
        up = torch.cat([cand[graft_of], sw.parent[child_of]])
        diff = torch.cat([torch.full_like(graft_of, 2),
                          torch.ones_like(child_of)])
        gen = torch.cat([sw.gen[cand[graft_of]] + 1, sw.gen[child_of]])
        line = torch.cat([2 * rank[graft_of], 2 * rank[child_of] + 1])
        at = torch.argsort(line)
        child, up, diff, gen = child[at], up[at], diff[at], gen[at]
        buf, _, _ = text.join([
            (chars[up], llens[up]), b"\t", (chars[child], llens[child]),
            b"\t", text.decimal(diff), b"\t",
            text.decimal(index[final[child]] + 1), b"\t",
            text.decimal(gen), b"\n"], len(child), dev)
        streams["-i"] = buf
    return streams


def cluster(corpus, config, device, control=False):
    """The reference's edges and streams for a corpus (corpus.Corpus)
    under the configuration's outputs (d = 1, -f, swarm's -b)."""
    outputs = config["outputs"]
    dev = torch.device(device)
    chars, hlens = corpus.headers(dev)
    abund = corpus.abundances.to(dev)
    order = abundance_order(chars, abund)
    chars, hlens, abund = chars[order], hlens[order], abund[order]
    codes = corpus.codes.to(dev)[order]
    lengths = corpus.lengths.to(dev)[order]
    n = len(lengths)
    pa, pb = candidate_pairs(codes, lengths, 1)
    near = torch.cat([within(codes, lengths, pa[s:s + ED_BLOCK],
                             pb[s:s + ED_BLOCK], 1, exact=True,
                             control=control)
                      for s in range(0, len(pa), ED_BLOCK)]) if len(pa) \
        else torch.zeros(0, dtype=torch.bool, device=dev)
    n_candidates = len(pa)
    pa, pb = pa[near], pb[near]
    # a -> b always (a < b: abundance(a) >= abundance(b)); b -> a on ties
    back = abund[pa] == abund[pb]
    src = torch.cat([pa, pb[back]])
    dst = torch.cat([pb, pa[back]])
    key = torch.sort(src * n + dst).indices
    src, dst = src[key], dst[key]
    ones = torch.ones_like(src)
    sw = swarms(n, src, dst, ones, dev)
    mass = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, sw.swarm_of, abund)
    light_swarm = mass < BOUNDARY
    is_light = light_swarm[sw.swarm_of]
    light = torch.nonzero(is_light).squeeze(1)
    heavy = torch.nonzero(~is_light).squeeze(1)
    seeds_light = light_swarm[sw.seeds]
    cand = torch.full((n,), -1, dtype=torch.int64, device=dev)
    n_graft_candidates = 0
    if seeds_light.any() and not seeds_light.all():
        cand, n_graft_candidates = graft_candidates(
            codes, lengths, light, heavy, n, control)
    final, block, chosen = graft(sw.swarm_of, cand, n)
    streams = write_d1_streams(sw, final, block, chosen, cand,
                               (chars, hlens), abund, codes, lengths,
                               outputs)
    return Result(edges=(src, dst, ones), streams=streams,
                  sorted_rows=order,
                  counts={"candidates": n_candidates, "pairs": len(pa),
                          "edges": len(src), "swarms": len(sw.seeds),
                          "light_amplicons": len(light),
                          "graft_candidate_pairs": n_graft_candidates,
                          "grafts": int(chosen.sum())})
