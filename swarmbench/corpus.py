"""A corpus of amplicons and the tensor operations its generators share.

A generator (generators/<name>.py, named by a traffic file's
``generator``) draws a ``Corpus`` from the traffic's parameters and a
seed; every random number is drawn from one torch.Generator on the given
device in a few large calls, so a seed gives the same corpus on every
run on one kind of device. ``Corpus.write`` writes the FASTA file of one
run: the same records, each label behind a tag of the run, so that no
two runs of a process read the same bytes.
"""

from dataclasses import dataclass

import torch

from . import text

TAG_WIDTH = 6  # "r0001_": a run's tag before each label


@dataclass
class Corpus:
    """A corpus in file order, on the host."""

    codes: torch.Tensor       # [n, W] uint8 2-bit codes, 0 past a row's end
    lengths: torch.Tensor     # [n] int64
    abundances: torch.Tensor  # [n] int64
    labels: torch.Tensor      # [n] int64: k of <label><k>
    label: bytes              # b"b"
    fasta: torch.Tensor = None   # [bytes] uint8: the records, tag included
    tag_at: torch.Tensor = None  # [n] int64: where each tag starts

    @property
    def n(self):
        return len(self.lengths)

    def headers(self, device=None):
        """(chars, lens): each header without a run's tag, as written."""
        device = device or self.codes.device
        ids = text.decimal(self.labels.to(device))
        abund = text.decimal(self.abundances.to(device))
        buf, offsets, _ = text.join(
            [self.label, ids, b"_", abund], self.n, device)
        lens = offsets[1:] - offsets[:-1]
        width = int(lens.max()) if self.n else 1
        cols = torch.arange(width, device=device)
        idx = (offsets[:-1, None] + cols[None, :]).clamp(
            max=max(len(buf) - 1, 0))
        chars = torch.where(cols[None, :] < lens[:, None], buf[idx],
                            torch.zeros((), dtype=torch.uint8, device=device))
        return chars, lens

    def build_fasta(self, device=None):
        """Lay out the FASTA records once; ``write`` fills in the tag."""
        device = device or self.codes.device
        chars, lens = self.headers(device)
        buf, offsets, starts = text.join(
            [b">", b"r" * TAG_WIDTH, (chars, lens), b"\n",
             text.codes_field(self.codes.to(device), self.lengths.to(device)),
             b"\n"], self.n, device)
        self.fasta = buf.cpu()
        self.tag_at = (offsets[:-1] + starts[1]).cpu()

    def write(self, path, run):
        """Write the corpus to `path` with every label behind the tag
        ``r<run>_``; returns the tag."""
        if self.fasta is None:
            self.build_fasta()
        tag = b"r%04d_" % run
        if len(tag) != TAG_WIDTH:
            raise ValueError(f"run {run} does not fit the tag width")
        cols = torch.arange(TAG_WIDTH)
        pos = (self.tag_at[:, None] + cols[None, :]).reshape(-1)
        self.fasta[pos] = torch.tensor(list(tag), dtype=torch.uint8).repeat(
            self.n)
        with open(path, "wb") as fh:
            fh.write(self.fasta.numpy().tobytes())
        return tag


def _edit(rows, lens, op, pos_u, shift, base, active, min_len):
    """One edit of each active row: a substitution by `shift` (op 0), a
    deletion (op 1, rows longer than min_len) or an insertion of `base`
    (otherwise), at the fraction pos_u of the row's length."""
    W = rows.shape[1]
    cols = torch.arange(W, device=rows.device)[None, :]
    p = (pos_u * lens).to(torch.int64).clamp(max=W - 1)[:, None]
    is_sub = active & (op == 0)
    is_del = active & (op == 1) & (lens > min_len)
    is_ins = active & ~is_sub & ~is_del
    src = cols + (is_del[:, None] & (cols >= p)).to(torch.int64) \
        - (is_ins[:, None] & (cols > p)).to(torch.int64)
    out = rows.gather(1, src.clamp(0, W - 1))
    at_p = cols == p
    out = torch.where(is_ins[:, None] & at_p, base[:, None], out)
    out = torch.where(is_sub[:, None] & at_p,
                      (rows + shift[:, None]) % 4, out)
    return out, lens - is_del.to(torch.int64) + is_ins.to(torch.int64)


def apply_edits(rows, lens, n_edits, g, min_len, shares):
    """Each row after its n_edits random edits (every draw in bulk): a
    substitution, a deletion or an insertion in the ratio `shares`, at a
    uniform position; an insertion grows a row, so `rows` needs the room."""
    N = rows.shape[0]
    dev = rows.device
    most = int(n_edits.max()) if N else 0
    u = torch.rand((N, most), generator=g, device=dev)
    total = float(sum(shares))
    op = (u >= shares[0] / total).to(torch.int64) + \
        (u >= (shares[0] + shares[1]) / total).to(torch.int64)
    pos_u = torch.rand((N, most), generator=g, device=dev)
    shift = torch.randint(1, 4, (N, most), generator=g,
                          device=dev).to(torch.uint8)
    base = torch.randint(0, 4, (N, most), generator=g,
                         device=dev).to(torch.uint8)
    for e in range(most):
        rows, lens = _edit(rows, lens, op[:, e], pos_u[:, e], shift[:, e],
                           base[:, e], e < n_edits, min_len)
    return rows, lens


def draw_lengths(ranges, size, g, device):
    """Lengths drawn from weighted ranges [[lo, hi, weight], ...] (or one
    [lo, hi]): a range by its weight, then a length uniform in it."""
    if not isinstance(ranges[0], (list, tuple)):
        ranges = [list(ranges) + [1.0]]
    lo = torch.tensor([r[0] for r in ranges], device=device)
    hi = torch.tensor([r[1] for r in ranges], device=device)
    w = torch.tensor([float(r[2]) for r in ranges], device=device)
    pick = torch.multinomial(w, size, replacement=True, generator=g) \
        if len(ranges) > 1 else torch.zeros(size, dtype=torch.int64,
                                            device=device)
    u = torch.rand(size, generator=g, device=device)
    span = (hi - lo + 1)[pick]
    return lo[pick] + (u * span).to(torch.int64).clamp(max=span - 1)


def dereplicate(rows, lens, counts):
    """(first, abundance): the first row of each set of equal rows (exact
    comparison of the 2-bit codes packed 32 to a word, and of the
    lengths), in row order, and the sum of `counts` over each set."""
    N, W = rows.shape
    dev = rows.device
    words = -(-W // 32)
    packed = torch.zeros((N, words * 32), dtype=torch.int64, device=dev)
    packed[:, :W] = rows.to(torch.int64)
    shifts = 2 * torch.arange(32, device=dev)
    keys = [lens] + list((packed.view(N, words, 32) << shifts).sum(-1).T)
    del packed
    order = torch.arange(N, device=dev)
    for key in reversed(keys):  # stable: equal rows stay in row order
        order = order[torch.sort(key[order], stable=True).indices]
    same = torch.ones(max(N - 1, 0), dtype=torch.bool, device=dev)
    for key in keys:
        k = key[order]
        same &= k[1:] == k[:-1]
    group = torch.zeros(N, dtype=torch.int64, device=dev)
    group[1:] = torch.cumsum((~same).to(torch.int64), 0)
    n_groups = int(group[-1]) + 1 if N else 0
    abundance = torch.zeros(n_groups, dtype=torch.int64,
                            device=dev).index_add_(0, group, counts[order])
    head = torch.ones(N, dtype=torch.bool, device=dev)
    head[1:] = ~same
    first = order[head]
    by_row = torch.argsort(first)
    return first[by_row], abundance[by_row]
