"""d=0 engine: strict dereplication (reference: src/derep.cc).

Pure host logic: identical sequences are merged into clusters; clusters
are ordered by decreasing mass then first-seen sequence number, members
chained in database (abundance-sorted) order.
"""

from typing import Dict, List

import numpy as np

from ..db import Db
from ..params import Parameters
from ..progress import Progress


class Cluster:
    __slots__ = ("seqno_first", "members", "mass", "size", "singletons")

    def __init__(self, seqno_first: int):
        self.seqno_first = seqno_first
        self.members: List[int] = [seqno_first]
        self.mass = 0
        self.size = 0
        self.singletons = 0


def _group_native(db: Db, progress: Progress):
    """C grouping + numpy aggregation (same cluster semantics)."""
    from .. import _native
    from ..progress import replay_range

    n = len(db)
    nclusters, group = _native.derep_groups(db.codes, db.offsets, db.lengths)
    mass = np.bincount(group, weights=db.abundances.astype(np.float64),
                       minlength=nclusters).astype(np.int64)
    # float64 weights are exact only below 2^53; recompute exactly when
    # any cluster could exceed that
    if mass.max(initial=0) >= (1 << 53) - 1:
        mass = np.zeros(nclusters, dtype=np.int64)
        np.add.at(mass, group, db.abundances.astype(np.int64))
    size = np.bincount(group, minlength=nclusters)
    singles = np.bincount(
        group, weights=(db.abundances == 1).astype(np.float64),
        minlength=nclusters,
    ).astype(np.int64)
    order_members = np.argsort(group, kind="stable")
    bounds = np.zeros(nclusters + 1, dtype=np.int64)
    np.cumsum(size, out=bounds[1:])
    first = order_members[bounds[:-1]]

    clusters = []
    for c in range(nclusters):
        cl = Cluster(int(first[c]))
        cl.members = order_members[bounds[c] : bounds[c + 1]]
        cl.mass = int(mass[c])
        cl.size = int(size[c])
        cl.singletons = int(singles[c])
        clusters.append(cl)
    replay_range(progress, n)
    return clusters, int(mass.max(initial=0)), int(size.max(initial=0))


def dereplicate(p: Parameters, db: Db, progress: Progress) -> None:
    from .. import _native

    n = len(db)

    progress.init("Dereplicating:    ", n)
    if _native.available() and n:
        clusters, maxmass, maxsize = _group_native(db, progress)
        progress.done()
    else:
        by_sequence: Dict[bytes, Cluster] = {}
        clusters = []
        maxmass = 0
        maxsize = 0

        offsets = db.offsets
        lengths = db.lengths
        codes_bytes = db.codes.tobytes()
        abundances = db.abundances

        for seqno in range(n):
            key = codes_bytes[offsets[seqno] : offsets[seqno] + lengths[seqno]]
            cluster = by_sequence.get(key)
            if cluster is None:
                cluster = Cluster(seqno)
                cluster.members = []
                by_sequence[key] = cluster
                clusters.append(cluster)
            cluster.members.append(seqno)
            abundance = int(abundances[seqno])
            cluster.mass += abundance
            cluster.size += 1
            if abundance == 1:
                cluster.singletons += 1
            maxmass = max(maxmass, cluster.mass)
            maxsize = max(maxsize, cluster.size)
            progress.update(seqno)
        progress.done()

    progress.init("Sorting:          ", 1)
    clusters.sort(key=lambda c: (-c.mass, c.seqno_first))
    progress.done()

    ua = p.opt_usearch_abundance
    aa = p.opt_append_abundance

    # --- swarms output ---
    if p.opt_mothur:
        progress.init("Writing swarms:   ", len(clusters))
        out = [f"swarm_{p.opt_differences}\t{len(clusters)}"]
        for counter, cluster in enumerate(clusters):
            out.append("\t")
            out.append(",".join(db.print_id(m, ua, aa) for m in cluster.members))
            progress.update(counter + 1)
        out.append("\n")
        p.outfile.write("".join(out))
        progress.done()
    else:
        progress.init("Writing swarms:   ", len(clusters))
        out = []
        for counter, cluster in enumerate(clusters):
            out.append(" ".join(db.print_id(m, ua, aa) for m in cluster.members))
            out.append("\n")
            progress.update(counter + 1)
        p.outfile.write("".join(out))
        progress.done()

    # --- seeds fasta with summed abundance ---
    if p.opt_seeds:
        progress.init("Writing seeds:    ", len(clusters))
        out = []
        for counter, cluster in enumerate(clusters):
            seed = cluster.seqno_first
            out.append(">")
            out.append(db.print_id_with_new_abundance(seed, cluster.mass, ua))
            out.append("\n")
            out.append(db.sequence_string(seed))
            out.append("\n")
            progress.update(counter + 1)
        p.seeds_file.write("".join(out))
        progress.done()

    # --- uclust-style output ---
    if p.opt_uclust_file:
        progress.init("Writing UCLUST:   ", len(clusters))
        out = []
        for counter, cluster in enumerate(clusters):
            seed = cluster.seqno_first
            seed_id = db.print_id(seed, ua, aa)
            out.append(f"C\t{counter}\t{cluster.size}\t*\t*\t*\t*\t*\t{seed_id}\t*\n")
            out.append(
                f"S\t{counter}\t{db.lengths[seed]}\t*\t*\t*\t*\t*\t{seed_id}\t*\n"
            )
            for member in cluster.members[1:]:
                out.append(
                    f"H\t{counter}\t{db.lengths[member]}\t{100.0:.1f}\t+\t0\t0\t=\t"
                    f"{db.print_id(member, ua, aa)}\t{seed_id}\n"
                )
            progress.update(counter + 1)
        p.uclustfile.write("".join(out))
        progress.done()

    # --- internal structure ---
    if p.opt_internal_structure:
        progress.init("Writing structure:", len(clusters))
        out = []
        for counter, cluster in enumerate(clusters):
            seed = cluster.seqno_first
            seed_id = db.print_id_noabundance(seed, ua)
            for member in cluster.members[1:]:
                out.append(
                    f"{seed_id}\t{db.print_id_noabundance(member, ua)}\t0\t{counter + 1}\t0\n"
                )
            progress.update(counter + 1)
        p.internal_structure_file.write("".join(out))
        progress.done()

    # --- statistics ---
    if p.opt_statistics_file:
        progress.init("Writing stats:    ", len(clusters))
        out = []
        for counter, cluster in enumerate(clusters):
            seed = cluster.seqno_first
            out.append(
                f"{cluster.size}\t{cluster.mass}\t{db.print_id_noabundance(seed, ua)}\t"
                f"{db.abundances[seed]}\t{cluster.singletons}\t0\t0\n"
            )
            progress.update(counter + 1)
        p.statsfile.write("".join(out))
        progress.done()

    p.logfile.write("\n")
    p.logfile.write(f"Number of swarms:  {len(clusters)}\n")
    p.logfile.write(f"Largest swarm:     {maxsize}\n")
    p.logfile.write(f"Heaviest swarm:    {maxmass}\n")
