"""The comparison that decides `correct`: the program's answers against
the reference's, as numbers each with its limit.

Every number counts differences, and every limit is 0: the comparison
is exact. Which numbers a cell has follows from its reference: the
edges' numbers where the reference judges an engine's edges, a stream's
number for each stream the configuration writes. The program's runs of a window cluster one corpus, each run
under its own tag before every label; a run's streams, its tag taken
out, are compared with the reference's streams, and the edges its
network engine handed to the graph replay with the reference's edges.

- ``runs_failed``: runs that raised, returned non-zero or wrote no file.
- ``edges_missing``, ``edges_extra``: directed edges of the reference
  that the program's first run lacks, and the reverse.
- ``edge_diffs_differ``: edges of both whose difference counts differ.
- ``runs_edges_differ``: runs whose edges differ from the first run's.
- ``o_lines_differ``, ``s_lines_differ``, ``i_lines_differ``: lines of
  the -o, -s and -i streams that differ, positionally, summed over the
  runs (a run whose stream equals the first run's repeats its count).
- ``w_records_differ``: -w records out of place. swarm sorts its seeds
  by mass with a comparator that is no strict order on equal masses
  (strcmp(...) == -1), so that order is left to std::sort's algorithm:
  the masses are compared in order, and the records of each mass as a
  set.
"""

from collections import defaultdict

LIMITS = {
    "runs_failed": 0,
    "edges_missing": 0,
    "edges_extra": 0,
    "edge_diffs_differ": 0,
    "runs_edges_differ": 0,
    "o_lines_differ": 0,
    "s_lines_differ": 0,
    "i_lines_differ": 0,
    "w_records_differ": 0,
}

#: the number that counts each stream's differences
STREAMS = {"-o": "o_lines_differ", "-s": "s_lines_differ",
           "-i": "i_lines_differ", "-w": "w_records_differ"}


def lines_differ(a, b):
    """Lines that differ between two streams, position by position."""
    if a == b:
        return 0
    la, lb = a.split(b"\n"), b.split(b"\n")
    return sum(x != y for x, y in zip(la, lb)) + abs(len(la) - len(lb))


def _seed_records(stream):
    """(masses in order, {mass: sorted records}) of a -w stream."""
    lines = stream.split(b"\n")
    masses, groups = [], defaultdict(list)
    for k in range(0, len(lines) - 1, 2):
        header = lines[k]
        cut = header.rfind(b"_")
        mass = header[cut + 1:] if cut >= 0 else b""
        masses.append(mass)
        groups[mass].append(header + b"\n" + lines[k + 1])
    return masses, {m: sorted(r) for m, r in groups.items()}


def records_differ(a, b):
    """-w records out of place: masses compared in order, the records of
    each mass as a set."""
    if a == b:
        return 0
    ma, ga = _seed_records(a)
    mb, gb = _seed_records(b)
    count = sum(x != y for x, y in zip(ma, mb)) + abs(len(ma) - len(mb))
    for mass in set(ga) | set(gb):
        ra, rb = ga.get(mass, []), gb.get(mass, [])
        count += sum(x != y for x, y in zip(ra, rb)) + abs(len(ra) - len(rb))
    return count


def stream_differ(flag, a, b):
    return records_differ(a, b) if flag == "-w" else lines_differ(a, b)


def edge_numbers(ref_edges, prog_edges, n):
    """(missing, extra, diffs differ) of the program's edges (numpy or
    torch int64 arrays src, dst, diff) against the reference's."""
    import torch

    dev = torch.as_tensor(ref_edges[0]).device  # the reference's device
    rs, rd, rdiff = (torch.as_tensor(x).to(dev) for x in ref_edges)
    ps, pd, pdiff = (torch.as_tensor(x).to(dev) for x in prog_edges)
    rkey = rs * n + rd
    pkey = ps * n + pd
    both = torch.cat([rkey, pkey])
    uniq, inverse = torch.unique(both, return_inverse=True)
    in_ref = torch.zeros(len(uniq), dtype=torch.bool, device=dev)
    in_ref[inverse[:len(rkey)]] = True
    in_prog = torch.zeros(len(uniq), dtype=torch.bool, device=dev)
    in_prog[inverse[len(rkey):]] = True
    missing = int((in_ref & ~in_prog).sum())
    extra = int((in_prog & ~in_ref).sum())
    rdiff_of = torch.full((len(uniq),), -1, dtype=torch.int64, device=dev)
    rdiff_of[inverse[:len(rkey)]] = rdiff
    pdiff_of = torch.full((len(uniq),), -1, dtype=torch.int64, device=dev)
    pdiff_of[inverse[len(rkey):]] = pdiff
    common = in_ref & in_prog
    differ = int((rdiff_of[common] != pdiff_of[common]).sum())
    return missing, extra, differ


def compare(reference, runs, n):
    """The numbers of a window's runs against the reference.

    reference: reference.Result; runs: the harness's Run records, each
    with ``failed``, ``edges`` (or None) and ``streams`` (the first
    run's tag-free bytes, and for a later run only where they differ
    from the first run's, else ``same_as_first``)."""
    ref_streams = {k: bytes(v.cpu().numpy())
                   for k, v in reference.streams.items()}
    names = ["runs_failed"]
    if reference.edges is not None:
        names += ["edges_missing", "edges_extra", "edge_diffs_differ",
                  "runs_edges_differ"]
    names += [STREAMS[flag] for flag in ref_streams]
    numbers = {name: 0 for name in LIMITS if name in names}
    numbers["runs_failed"] = sum(1 for r in runs if r.failed)
    good = [r for r in runs if not r.failed]
    if not good:
        numbers["runs_failed"] = max(numbers["runs_failed"], 1)
        return numbers
    first = good[0]
    if reference.edges is None:
        pass
    elif first.edges is None:
        numbers["edges_missing"] = len(reference.edges[0])
    else:
        m, e, dd = edge_numbers(reference.edges, first.edges, n)
        numbers["edges_missing"], numbers["edges_extra"] = m, e
        numbers["edge_diffs_differ"] = dd
    if reference.edges is not None:
        numbers["runs_edges_differ"] = sum(
            1 for r in good[1:] if not r.edges_same_as_first)
    first_counts = {flag: stream_differ(flag, first.streams.get(flag, b""),
                                        ref)
                    for flag, ref in ref_streams.items()}
    for r in good:
        for flag, ref in ref_streams.items():
            if r is first or flag in r.same_as_first:
                count = first_counts[flag]
            else:
                count = stream_differ(flag, r.streams.get(flag, b""), ref)
            numbers[STREAMS[flag]] += count
    return numbers


def verdict(numbers):
    """(correct, {name: {"value", "limit"}}) of the numbers a cell has,
    in LIMITS' order."""
    table = {name: {"value": numbers[name], "limit": limit}
             for name, limit in LIMITS.items() if name in numbers}
    return all(row["value"] <= row["limit"] for row in table.values()), \
        table
