"""Dereplicated amplicons of a sequenced community: true sequences, the
reads drawn from them with sequencing errors, then dereplication.

What swarm is given is what this draws: the unique sequences of a
study's reads, each with its read count. A true sequence (an amplicon of
one organism) is read as often as its organism is abundant; some of its
reads carry errors, and each distinct erroneous read becomes an amplicon
of its own, mostly seen once, a few edits from its true sequence. So the
abundances are dominated by ones, every true sequence sits at the centre
of a cloud of rarer variants, and a cloud grows with its centre's
abundance until the variants within a few edits are all drawn: the
structure swarm's clustering is built on (Mahé et al. 2014, PeerJ
2:e593).

Parameters (a traffic file's keys):

- ``amplicons``: unique sequences kept, a uniform sample of all drawn.
- ``true_length``: [lo, hi] or weighted ranges [[lo, hi, weight], ...]
  of the true sequences' lengths.
- ``community``: ``sequences`` true sequences, their read counts from
  Fisher's log-series with parameter ``log_series_x`` (Fisher, Corbet &
  Williams 1943, J. Anim. Ecol. 12:42).
- ``errors``: ``per_base`` rate, a read's count of errors a Poisson of
  per_base x length; ``shares`` of substitutions, deletions and
  insertions; at most ``most`` errors a read.
- ``truncate`` (optional): every read cut to this length, as reads
  trimmed to one length are.
- ``min_length``: no deletion shortens a row below it. ``label``: the
  headers' prefix.

The file order is a seeded random order; labels are ``<label><k>`` with
k the amplicon's rank among those kept.
"""

import math

import torch

from swarmbench.corpus import Corpus, apply_edits, dereplicate, draw_lengths


def log_series(size, x, g, device):
    """Draws of Fisher's log-series with parameter x (Kemp's algorithm
    LK, as numpy's logseries)."""
    r = math.log1p(-x)
    v = torch.rand(size, generator=g, device=device, dtype=torch.float64)
    u = torch.rand(size, generator=g, device=device, dtype=torch.float64)
    q = -torch.expm1(r * u)
    tail = torch.floor(1 + torch.log(v) / torch.log(q)).clamp(min=1)
    out = torch.where(v <= q * q, tail,
                      torch.where(v >= q, 1.0, 2.0))
    return torch.where(v >= x, 1.0, out).to(torch.int64)


def error_counts(lam, most, g):
    """A count of errors of each erroneous read: a Poisson of mean lam
    given at least one, at most `most` (inverse transform)."""
    p0 = torch.exp(-lam)
    u = p0 + torch.rand(lam.shape, generator=g, device=lam.device,
                        dtype=lam.dtype) * (1 - p0)
    count = torch.ones(lam.shape, dtype=torch.int64, device=lam.device)
    pmf = p0 * lam
    cdf = p0 + pmf
    for k in range(2, most + 1):
        count += (u > cdf).to(torch.int64)
        pmf = pmf * lam / k
        cdf = cdf + pmf
    return count


def make_corpus(params, seed, device="cpu"):
    """The corpus of one traffic file's parameters and a seed."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = int(params["amplicons"])
    comm = params["community"]
    err = params["errors"]
    most = int(err["most"])
    min_len = int(params.get("min_length", 10))
    S = int(comm["sequences"])

    # the true sequences and their reads
    lens = draw_lengths(params["true_length"], S, g, device)
    W = int(lens.max()) + most
    cols = torch.arange(W, device=device)
    true = torch.randint(0, 4, (S, W), generator=g,
                         device=device).to(torch.uint8)
    true = torch.where(cols[None, :] < lens[:, None], true,
                       torch.zeros((), dtype=torch.uint8, device=device))
    reads = log_series(S, float(comm["log_series_x"]), g, device)
    lam = lens.to(torch.float64) * float(err["per_base"])
    wrong = torch.binomial(reads.to(torch.float64), -torch.expm1(-lam),
                           generator=g).to(torch.int64)

    # the erroneous reads, each from its true sequence
    parent = torch.repeat_interleave(torch.arange(S, device=device), wrong)
    n_err = error_counts(lam[parent], most, g)
    rows, rlens = apply_edits(true[parent], lens[parent], n_err, g, min_len,
                              tuple(err["shares"]))
    rows = torch.cat([true, rows])
    rlens = torch.cat([lens, rlens])
    counts = torch.cat([reads - wrong,
                        torch.ones(len(parent), dtype=torch.int64,
                                   device=device)])
    del parent, n_err, true
    if params.get("truncate"):
        rlens = rlens.clamp(max=int(params["truncate"]))
    rows = torch.where(cols[None, :] < rlens[:, None], rows,
                       torch.zeros((), dtype=torch.uint8, device=device))
    seen = counts > 0
    rows, rlens, counts = rows[seen], rlens[seen], counts[seen]
    first, abundance = dereplicate(rows, rlens, counts)
    if len(first) < n:
        raise RuntimeError(f"{len(first)} distinct amplicons drawn, "
                           f"{n} asked for: raise community.sequences")

    # a uniform sample of n, in a seeded file order
    pick = torch.sort(torch.randperm(len(first), generator=g,
                                     device=device)[:n]).values
    order = torch.randperm(n, generator=g, device=device)
    keep = first[pick][order]
    width = int(rlens[keep].max())
    return Corpus(codes=rows[keep, :width].cpu(), lengths=rlens[keep].cpu(),
                  abundances=abundance[pick][order].cpu(),
                  labels=order.cpu(),
                  label=params.get("label", "b").encode())
