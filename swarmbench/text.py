"""Bulk ASCII records: rows of variable-width fields, built with tensor ops.

A record is a list of parts: a constant ``bytes``, or a field given as
``(chars, lens)``, a [N, w] uint8 tensor of ASCII codes with each row's
width in ``lens``, or a field of whole numbers from ``decimal``. ``join``
lays the N records end to end in one uint8 tensor, in row order, with no
loop over rows. The benchmark writes its FASTA inputs and the reference
writes swarm's output streams with it.
"""

import torch

ACGT = torch.tensor(list(b"ACGT"), dtype=torch.uint8)


def decimal(values):
    """(chars [N, 20] uint8, lens [N]): each value in decimal, no sign."""
    v = values.to(torch.int64)
    if (v < 0).any():
        raise ValueError("decimal() takes values >= 0")
    lens = torch.ones_like(v)
    for k in range(1, 19):  # int64 holds at most 19 digits
        lens += (v >= 10 ** k).to(torch.int64)
    t = torch.arange(20, device=v.device)
    power = torch.tensor([10 ** k for k in range(19)], dtype=torch.int64,
                         device=v.device)
    exp = (lens[:, None] - 1 - t[None, :]).clamp(min=0, max=18)
    digit = torch.div(v[:, None], power[exp], rounding_mode="floor") % 10
    chars = (digit + ord("0")).to(torch.uint8)
    return chars, lens


def codes_field(codes, lens):
    """A sequence field: [N, w] 2-bit codes (0..3) as ACGT."""
    return ACGT.to(codes.device)[codes.long()], lens.to(torch.int64)


def join(parts, n, device):
    """One uint8 tensor holding the n records, and each record's offset.

    parts: a list of bytes (the same in every record) and (chars, lens)
    fields. Returns (buffer, offsets [n + 1], starts) where starts[k] is
    each part's offset inside its record, a [n] tensor."""
    widths = []
    for part in parts:
        if isinstance(part, (bytes, bytearray)):
            widths.append(torch.full((n,), len(part), dtype=torch.int64,
                                     device=device))
        else:
            widths.append(part[1].to(torch.int64))
    total = torch.stack(widths).sum(0) if parts else torch.zeros(
        n, dtype=torch.int64, device=device)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(total, 0)
    buf = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=device)
    at = offsets[:-1].clone()
    starts = []
    for part, width in zip(parts, widths):
        starts.append(at - offsets[:-1])
        if isinstance(part, (bytes, bytearray)):
            if len(part):
                cols = torch.arange(len(part), device=device)
                const = torch.tensor(list(part), dtype=torch.uint8,
                                     device=device)
                buf[(at[:, None] + cols[None, :]).reshape(-1)] = \
                    const.repeat(n)
        else:
            chars, lens = part
            cols = torch.arange(chars.shape[1], device=device)
            mask = cols[None, :] < lens[:, None]
            buf[(at[:, None] + cols[None, :])[mask]] = chars[mask]
        at = at + width
    return buf, offsets, starts
