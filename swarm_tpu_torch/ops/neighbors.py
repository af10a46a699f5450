"""d=1 neighbor discovery: batched microvariant hashing + sorted hash join.

The reference enumerates, for each amplicon, all canonical 1-edit
microvariants as incrementally-updated Zobrist hashes and probes a hash
table (src/variants.cc:184-249, src/algod1.cc:558-627). Here the same
mathematics is expressed as dense batched array ops — three gathers into
a Zobrist table, XOR prefix/suffix scans, and a binary-search join
against the sorted amplicon hash array. Counterpart of
swarm_tpu/ops/neighbors.py: NeighborIndex builds the d=1 network with
the native C code below NATIVE_MAX amplicons (NATIVE_MAX_GRAFT or
NATIVE_MAX_COLD in a process that does not hold the card yet) and with
the torch sort-join
engine (ops/neighbors_sortjoin.py) from there up, and the batched
hashes serve the fastidious python join.

Canonical variant set of a length-L sequence s (identical to the
reference's enumeration, which guarantees each 1-edit *sequence* is
produced exactly once):
  - substitutions: position p, base b != s[p]                 (3L)
  - deletions: position 0, plus each p>0 with s[p] != s[p-1]  (runs R)
  - insertions: before position 0 any base (4), after each p
    any base b != s[p]                                        (3L + 4)

Because every hash match is verified exactly against the candidate
sequence, hash randomness never affects output (reference SURVEY §3.5).
"""

import os
from typing import Tuple

import numpy as np

_RNG_SEED = 0x5EED5EED


def make_zobrist(max_len: int, seed: int = _RNG_SEED) -> np.ndarray:
    """Zobrist table Z[pos, base] of random uint64, pos in [0, max_len+2)."""
    rng = np.random.Generator(np.random.Philox(seed))
    return rng.integers(0, 1 << 64, size=(max_len + 2, 4), dtype=np.uint64)


def pad_codes(codes: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
              max_len: int) -> np.ndarray:
    """[n, max_len] uint8 matrix of nucleotide codes, zero padded."""
    from .. import _native

    n = len(lengths)
    if _native.available() and n:
        return _native.pad_rows(codes, offsets, lengths, max_len)
    out = np.zeros((n, max_len), dtype=np.uint8)
    for i in range(n):
        out[i, : lengths[i]] = codes[offsets[i] : offsets[i] + lengths[i]]
    return out


def sequence_hashes(padded: np.ndarray, lengths: np.ndarray, zob: np.ndarray) -> np.ndarray:
    """Zobrist hash of each sequence: XOR_p Z[p, s_p]."""
    n, max_len = padded.shape
    pos = np.arange(max_len)
    mask = pos[None, :] < lengths[:, None]
    gathered = zob[pos[None, :], padded]  # [n, L]
    gathered = np.where(mask, gathered, np.uint64(0))
    return np.bitwise_xor.reduce(gathered, axis=1)


def variant_hashes(
    padded: np.ndarray, lengths: np.ndarray, zob: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All canonical 1-edit variant hashes for each sequence.

    Returns (seqhash [n], hashes [n, 7*max_len+4], valid mask).
    Layout (kind-major — fixed, independent of the reference's
    enumeration order, which never affects output):
      slot = k*L + p for k in [0, 7), p in [0, max_len):
        k in [0, 3): substitution at p with the k-th base != s_p
                     (ascending base order)          — always valid in-range
        k == 3:      deletion at p                   — valid iff run start
        k in [4, 7): insertion after p (new position p+1) with the
                     (k-4)-th base != s_p            — always valid in-range
      slot in [7L, 7L+4): insertion before position 0 with base slot-7L.
    """
    n, max_len = padded.shape
    zero = np.uint64(0)
    pos = np.arange(max_len)
    mask = pos[None, :] < lengths[:, None]  # [n, L]

    g0 = np.where(mask, zob[pos[None, :], padded], zero)  # Z[p, s_p]
    gm1 = np.zeros_like(g0)  # Z[p-1, s_p] for p >= 1
    if max_len > 1:
        gm1[:, 1:] = zob[pos[1:] - 1, padded[:, 1:]]
    gm1 = np.where(mask, gm1, zero)
    gp1 = np.where(mask, zob[(pos + 1)[None, :], padded], zero)  # Z[p+1, s_p]

    seqhash = np.bitwise_xor.reduce(g0, axis=1)  # [n]

    # exclusive prefix XOR of g0: prefix[:, p] = XOR_{q<p} Z[q, s_q]
    prefix = np.zeros((n, max_len), dtype=np.uint64)
    if max_len > 1:
        np.bitwise_xor.accumulate(g0[:, :-1], axis=1, out=prefix[:, 1:])

    # inclusive suffix XOR of gm1: sufdel[:, p] = XOR_{q>=p} Z[q-1, s_q]
    sufdel = np.bitwise_xor.accumulate(gm1[:, ::-1], axis=1)[:, ::-1]
    sufdel = np.concatenate([sufdel, np.zeros((n, 1), dtype=np.uint64)], axis=1)

    # inclusive suffix XOR of gp1: sufins[:, p] = XOR_{q>=p} Z[q+1, s_q]
    sufins = np.bitwise_xor.accumulate(gp1[:, ::-1], axis=1)[:, ::-1]
    sufins = np.concatenate([sufins, np.zeros((n, 1), dtype=np.uint64)], axis=1)

    other3 = _three_of_four(padded)  # [n, L, 3] bases != s_p, ascending

    segs = []
    segs_valid = []

    # substitutions (k = 0..2): h = seqhash ^ Z[p, s_p] ^ Z[p, other3_k]
    for k in range(3):
        zsub = zob[pos[None, :], other3[:, :, k]]
        segs.append(seqhash[:, None] ^ g0 ^ np.where(mask, zsub, zero))
        segs_valid.append(mask)

    # deletion at p (k = 3): prefix[p] ^ sufdel[p+1]; valid iff run start
    dele = prefix ^ sufdel[:, 1:]
    run_start = np.ones((n, max_len), dtype=bool)
    if max_len > 1:
        run_start[:, 1:] = padded[:, 1:] != padded[:, :-1]
    segs.append(dele)
    segs_valid.append(mask & run_start)

    # insertions after p (k = 4..6): incl_prefix[p] ^ Z[p+1, b] ^ sufins[p+1]
    prefix_incl = prefix ^ g0
    for k in range(3):
        zins = zob[(pos + 1)[None, :], other3[:, :, k]]
        segs.append(
            prefix_incl ^ np.where(mask, zins, zero) ^ sufins[:, 1:]
        )
        segs_valid.append(mask)

    # insertions before position 0, any base (4 tail slots)
    bases = np.arange(4, dtype=np.uint8)
    ins0 = zob[0, bases][None, :] ^ sufins[:, 0:1]
    ins0_valid = np.broadcast_to((lengths[:, None] > 0), (n, 4))

    hashes = np.concatenate(segs + [ins0], axis=1)
    valid = np.concatenate(segs_valid + [ins0_valid], axis=1)
    return seqhash, hashes, valid


def _three_of_four(padded: np.ndarray) -> np.ndarray:
    """Indices of the 3 bases != s_p, shape [n, L, 3]."""
    # for s in 0..3, the other three bases in ascending order
    table = np.array(
        [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64
    )
    return table[padded]


def decode_slot(slot: np.ndarray, max_len: int, padded: np.ndarray, amp: np.ndarray):
    """Decode kind-major variant slot ids into (type, pos, base).

    type: 0=substitution, 1=deletion, 2=insertion
    For insertion, pos is the insertion position in the *new* sequence.
    """
    tail = slot >= 7 * max_len
    kind = np.where(tail, 0, slot // max_len)  # 0..6
    p = np.where(tail, 0, slot % max_len)

    var_type = np.where(
        tail, 2, np.where(kind < 3, 0, np.where(kind == 3, 1, 2))
    )
    s_p = padded[amp, p]
    table = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64)
    j = np.where(kind < 3, kind, np.clip(kind - 4, 0, 2))
    other_base = table[s_p, j]

    pos = np.where(tail, 0, np.where(kind < 4, p, p + 1))
    base = np.where(
        tail,
        slot - 7 * max_len,
        np.where(kind == 3, 0, other_base),
    )
    return var_type, pos, base


class NeighborIndex:
    """Padded codes + Zobrist machinery for a database, and its d=1
    network.

    Counterpart of swarm_tpu's NeighborIndex under its auto backend,
    with the device join on the torch `device`. The rule, decided before
    anything is launched: the native host builder
    (swarm_native.c: d1_network) takes fewer than NATIVE_MAX amplicons
    when the process already holds the CUDA context and the kernel
    library (device.card_ready: the resident server, a run after another
    in one process), fewer than NATIVE_MAX_GRAFT when it does not but
    the run takes the card anyway (`graft_on_card`: -f's graft on a CUDA
    device), and fewer than NATIVE_MAX_COLD otherwise
    (SWARM_TPU_D1_NATIVE_MAX overrides all three, as in swarm_tpu); the torch
    sort-join engine takes the rest, whatever their mix of lengths (its
    rows are ragged: swarm_tpu's width buckets have no counterpart), and
    a failure there raises. When the run asks for shards
    (swarm_tpu_torch/parallel: SWARM_TORCH_SHARDS or the rank
    variables), the sharded engine (parallel/mesh.py:
    SortJoinShardedEngine) takes every n >= 1 instead, with no native
    threshold, as swarm_tpu's jax_shard backend does; it raises on any
    failure too.
    """

    #: the native host builder takes n below these, the card's engine
    #: from them up. scripts/dispatch_sweep.py on an NVIDIA H100 80GB
    #: HBM3 at 700 W (PERF.md §5), `swarm -d 1 -o -s` on
    #: gen_corpus(length=150) and mixed_length_corpus at -t 1 and -t 8:
    #: with the card held, the card's engine won at every size from
    #: 4,096 (the sweep's smallest) to 131,072; in a fresh process, whose
    #: first use of the card adds 0.2-1.0 s, the host won up to 131,072
    #: and the card from 262,144 (mixed lengths: from 65,536-131,072).
    #: A fresh -f run pays the context and the library for its graft
    #: anyway: `swarm -d 1 -f -o -s` on fastidious_corpus at -t 1 and 8
    #: and its small-light-side form at -t 1 (medians of three fresh
    #: processes in turns), the host won up to 4,096-16,384 and the card
    #: from 16,384-65,536; 65,536 itself was a tie in single samples,
    #: 131,072 and more the card's in every sample
    NATIVE_MAX = 4_096
    NATIVE_MAX_GRAFT = 65_536
    NATIVE_MAX_COLD = 262_144

    def __init__(self, db, threads: int = 1, device=None,
                 graft_on_card: bool = False):
        self.db = db
        #: -f's graft takes the card in this run whatever builds the
        #: network, so a fresh process pays the CUDA context and the
        #: kernel library either way: NATIVE_MAX_GRAFT applies there
        self.graft_on_card = graft_on_card
        self.max_len = max(int(db.longest), 1)
        self.lengths = db.lengths.astype(np.int64)
        self.threads = max(int(threads), 1)
        self.device = device
        self._engine = None
        self._padded = None
        self._zob = None
        #: the d=1 engine's ragged rows on the device (words, row_word,
        #: lengths) when build_network was asked to keep them (for -f's
        #: graft, which takes them); else None
        self.packed_rows = None

    # only the fastidious python join needs these; keep them lazy
    @property
    def padded(self) -> np.ndarray:
        if self._padded is None:
            db = self.db
            self._padded = pad_codes(
                db.codes, db.offsets, db.lengths, self.max_len
            )
        return self._padded

    @property
    def zob(self) -> np.ndarray:
        if self._zob is None:
            self._zob = make_zobrist(self.max_len)
        return self._zob

    def seq_hashes(self) -> np.ndarray:
        return sequence_hashes(self.padded, self.lengths, self.zob)

    def _device_engine(self):
        from .. import parallel
        from ..device import default_device

        shards = parallel.shards_for(
            default_device() if self.device is None else self.device)
        if shards is not None:
            from ..parallel.mesh import SortJoinShardedEngine

            return SortJoinShardedEngine(self.db, shards)
        from .neighbors_sortjoin import SortJoinNeighborEngine

        return SortJoinNeighborEngine(self.db, self.device)

    def uses_native(self) -> bool:
        """Whether the native host builder makes the network. (A process
        goes from cold to holding the card, never back, and NATIVE_MAX
        <= NATIVE_MAX_GRAFT <= NATIVE_MAX_COLD: once the engine is chosen
        it stays so.)"""
        from .. import parallel
        from ..device import card_ready

        if parallel.requested():
            return False
        at = self.NATIVE_MAX if card_ready() else \
            self.NATIVE_MAX_GRAFT if self.graft_on_card else \
            self.NATIVE_MAX_COLD
        native_max = int(os.environ.get("SWARM_TPU_D1_NATIVE_MAX", at))
        return len(self.lengths) < native_max

    def start_network(self) -> None:
        """Start the device join before the hashing phase, so that the
        device works while the host checks for duplicate sequences (a
        duplicate's fatal abandons the work with no output); a no-op for
        the native builder."""
        if len(self.lengths) == 0 or self.uses_native():
            return
        from .. import metrics

        with metrics.span("d1_network.start"):
            self._engine = self._device_engine()
            self._engine.start()

    def build_network(self, no_break: bool, abundances: np.ndarray,
                      keep_rows: bool = False):
        """Return (edges_from, edges_to): all pairs dist(a,b)==1 with the
        abundance rule applied (ab[a] >= ab[b] unless no_break), a != b.

        Edge lists are returned sorted by (from, to). With keep_rows the
        device engine's packed rows stay in self.packed_rows.
        """
        from .. import metrics

        if len(self.lengths) == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        with metrics.span("d1_network.build"):
            ef, et = self._build(no_break, abundances, keep_rows)
        metrics.record(**{"d1_network.edges": len(ef)})
        return ef, et

    def _build(self, no_break, abundances, keep_rows):
        from .. import _native, metrics

        if self.uses_native():
            ef, et = _native.d1_network(
                self.db.codes, self.db.offsets, self.db.lengths,
                np.asarray(abundances, dtype=np.int64), no_break,
                nthreads=self.threads,
            )
            metrics.record(d1_join_comparisons=int(len(ef)))
            return ef, et
        if self._engine is None:
            self.start_network()
        engine, self._engine = self._engine, None
        edges = engine.build_network(no_break, abundances)
        if keep_rows:
            self.packed_rows = engine.packed_rows
        return edges


def _join(hashes, valid, sorted_hashes, order):
    """Join variant hashes against the sorted amplicon hash array.

    Returns candidate (amp, slot, target) triples (hash-equal, unverified).
    Handles runs of equal hash values in the table (collisions)."""
    n, n_slots = hashes.shape
    m = len(sorted_hashes)
    flat = hashes.reshape(-1)
    flat_valid = valid.reshape(-1)

    lo = np.searchsorted(sorted_hashes, flat, side="left")
    hi = np.searchsorted(sorted_hashes, flat, side="right")
    counts = np.where(flat_valid, hi - lo, 0)

    total = int(counts.sum())
    if total == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty, empty

    flat_idx = np.repeat(np.arange(n * n_slots), counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    table_pos = np.repeat(lo, counts) + within

    amp = flat_idx // n_slots
    slot = flat_idx % n_slots
    target = order[table_pos]
    return amp, slot, target
