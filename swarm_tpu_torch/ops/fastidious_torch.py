"""Fastidious graft (-f) on the torch device.

Counterpart of swarm_tpu/ops/fastidious_jax.py: its GraftEngine, with
variant_hash_halves (swarm_tpu/ops/neighbors_jax.py), _decode_slots and
_variant_rows. A light amplicon l grafts onto the smallest heavy
amplicon h at distance <= 2, found through a shared midpoint m, a
canonical 1-edit variant of both (reference: src/algod1.cc:211-555).
Each variant's key is its Zobrist hash (hi << 32) | lo with the table of
make_zobrist_pair, held as one int64: the keys are JAX's, whatever the
width (the table's rows do not depend on its length, and each row here
uses its own length).

Slot order. A row of length L > 0 has 6L + 4 + R valid variants, R its
run starts: the 4 insertions before position 0 (by base), then for each
position p the 3 substitutions and the 3 insertions after p by the bases
o_k = k + (x_p <= k), then the deletions at run starts in position order.
Only valid slots are made: there is no sentinel. A slot is a key's index
within its row; JAX strides its slots by a padded width, so the tests
compare each row's keys as a multiset and the variants they rebuild.

Four steps, each with a plain PyTorch version and a CUDA kernel
(csrc/graft.cu); a wrapper runs the plain version only for tensors on
the CPU, and on a CUDA tensor launches its kernel or raises:

- keygen: variant_hash_halves (plain, JAX's layout) and
  variant_keys_reference (plain, ragged rows in the slot order above),
  and the wrappers keygen_count (each row's number of keys) and
  keygen_emit (the keys and their payload, the key's index within its
  side);
- partition: neighbors_sortjoin.partition (d1_partition), each side into
  the same buckets;
- join: join_reference (plain) and the wrappers join_count, join_emit
  and join_pairs: one pair (small payload << 32) | big payload for every
  two keys of the two sides that are equal, in the big side's partition
  order, then the small side's. The items
  are chunks of JOIN_CHUNK big elements (join_items); join_count writes
  neither side and leaves each chunk's count and a JoinRecord
  (join_record_reference, its plain version), from which alone join_emit
  writes the pairs (join_emit_reference);
- verify: variant_rows_reference and verify_reference (plain: the
  payloads decoded to (amplicon, slot), both variants rebuilt and
  compared) and the wrapper verify, which also keeps the smallest heavy
  amplicon of every light one (best).

GraftEngine(db, device).graft_candidates(heavy, light) -> (count,
graft_cand) has the contract of JAX's: the number of verified (heavy,
light, midpoint) triples and, for each light amplicon, its smallest
heavy one (-1 where none). The smaller side is partitioned once; the
bigger side streams in strips sized from its key counts and the free
device memory. JAX's second engine (a sorted table and a byte-set probe
for a small side) is this one: a small side leaves most buckets empty,
and an empty bucket costs one read of its bounds.
"""

import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import default_device
from . import neighbors_sortjoin as sj

#: kernel launches made by the wrappers (CUDA tensors only); each pass of
#: keygen (count, emit) and of join (count, emit) counts as one launch
launches = {"graft_keygen": 0, "graft_join": 0, "graft_verify": 0}

#: big-side elements a chunk, the join's item (csrc/graft.cu: kJoinChunk):
#: a block of the count pass probes a chunk's keys against the small
#: elements of the buckets it touches
JOIN_CHUNK = 1024
#: the bits of a record's place in its chunk, and the largest count a
#: record holds (a longer chain is counted along the links)
PLACE_BITS = JOIN_CHUNK.bit_length() - 1
COUNT_MAX = (1 << (32 - PLACE_BITS)) - 1
#: small elements a hash table in shared memory (kJoinTile): a chunk
#: whose buckets hold more are probed tile after tile
JOIN_TILE = 1024

_RNG_SEED = 0x5EED5EED
_INT32_MAX = (1 << 31) - 1
#: elements of the [rows, 7 * L + 4] temporaries of one step of the plain
#: keygen (rows of one length are taken in steps)
_PLAIN_STEP = 1 << 22


def make_zobrist_pair(max_len: int, seed: int = _RNG_SEED) -> np.ndarray:
    """Zobrist table [max_len + 2, 4, 2] of random uint32 (hi, lo).
    Philox draws the same prefix whatever max_len, so a table for the
    corpus' longest row gives JAX's hashes for a padded width."""
    rng = np.random.Generator(np.random.Philox(seed))
    return rng.integers(0, 1 << 32, size=(max_len + 2, 4, 2), dtype=np.uint32)


def zobrist_tensor(zob: np.ndarray, device) -> torch.Tensor:
    """The table on `device`: int64 values in [0, 2^32) on the CPU (the
    plain versions' form), the uint32 bits as int32 on the card (the
    kernels')."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(zob.astype(np.int64))
    return torch.from_numpy(np.ascontiguousarray(zob).view(np.int32)).to(
        device)


def _xor_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive XOR scan along dim 1 (torch has no cumulative XOR)."""
    d = 1
    while d < x.shape[1]:
        x = torch.cat([x[:, :d], x[:, d:] ^ x[:, :-d]], dim=1)
        d <<= 1
    return x


def _xor_scan_reverse(x: torch.Tensor) -> torch.Tensor:
    return _xor_scan(x.flip(1)).flip(1)


def variant_hash_halves(padded: torch.Tensor, lengths: torch.Tensor,
                        zob: torch.Tensor):
    """((hash_hi [C, 7L+4], hash_lo), (seq_hi [C], seq_lo), valid).

    padded: [C, L] codes (L >= 1); lengths: [C]; zob: [>= L+2, 4, 2]
    int64 values in [0, 2^32). JAX's kind-major layout and values, slot
    for slot: slot k*L + p for kinds 0..2 (substitution by o_k), 3
    (deletion, valid at run starts) and 4..6 (insertion after p by o_k),
    tail slots 7L..7L+3 (insertions before position 0 by base), each
    half an int64 value in [0, 2^32).
    """
    C, L = padded.shape
    dev = padded.device
    pos = torch.arange(L, device=dev)
    mask = pos[None, :] < lengths.long()[:, None]
    pidx = padded.long()
    run_start = torch.cat(
        [torch.ones((C, 1), dtype=torch.bool, device=dev),
         padded[:, 1:] != padded[:, :-1]], dim=1)
    o = [k + (pidx <= k).long() for k in range(3)]

    hash_halves, seq_halves = [], []
    for h in range(2):
        z = zob[: L + 2, :, h]
        g0 = torch.where(mask, z[pos[None, :], pidx], 0)  # Z[p, s_p]
        gm1 = torch.where(mask & (pos[None, :] >= 1),
                          z[(pos - 1).clamp(min=0)[None, :], pidx], 0)
        gp1 = torch.where(mask, z[pos[None, :] + 1, pidx], 0)
        incl = _xor_scan(g0)
        seqhash = incl[:, -1]
        prefix = torch.cat([torch.zeros_like(g0[:, :1]), incl[:, :-1]], dim=1)
        sufdel = _xor_scan_reverse(gm1)
        sufdel_next = torch.cat([sufdel[:, 1:], torch.zeros_like(g0[:, :1])],
                                dim=1)
        sufins = _xor_scan_reverse(gp1)
        sufins_next = torch.cat([sufins[:, 1:], torch.zeros_like(g0[:, :1])],
                                dim=1)
        base_part = seqhash[:, None] ^ g0
        segs = [base_part ^ torch.where(mask, z[pos[None, :], o[k]], 0)
                for k in range(3)]
        segs.append(prefix ^ sufdel_next)
        ins_part = prefix ^ g0 ^ sufins_next
        segs += [ins_part ^ torch.where(mask, z[pos[None, :] + 1, o[k]], 0)
                 for k in range(3)]
        segs.append(z[0][None, :] ^ sufins[:, :1])
        hash_halves.append(torch.cat(segs, dim=1))
        seq_halves.append(seqhash)
    valid = torch.cat(
        [mask, mask, mask, mask & run_start, mask, mask, mask,
         (lengths.long() > 0)[:, None].expand(C, 4)], dim=1)
    return tuple(hash_halves), tuple(seq_halves), valid


def _slot_order(hi, lo, valid, L: int):
    """(keys [C, 7L+4] int64, valid) of variant_hash_halves' output in the
    port's slot order: tail, then (3 substitutions, 3 insertions) a
    position, then the deletions."""
    keys = sj.make_keys(hi, lo)
    C = keys.shape[0]
    sub_ins = [0, 1, 2, 4, 5, 6]

    def order(x):
        kinds = x[:, : 7 * L].reshape(C, 7, L)
        return torch.cat([x[:, 7 * L:],
                          kinds[:, sub_ins].transpose(1, 2).reshape(C, 6 * L),
                          kinds[:, 3]], dim=1)

    return order(keys), order(valid)


def _row_codes(words, row_word, lengths, ids, width: int):
    """[len(ids), width] uint8 codes of rows `ids` (zero past each row)."""
    n_words = -(-width // sj.BASES_PER_WORD)
    table = sj.gather_rows(words, row_word, lengths, ids, n_words)
    return sj.unpack2bit(table)[:, :width]


def variant_keys_reference(words, row_word, lengths, ids, zob):
    """(keys [total] int64, counts [m] int64): every valid variant key of
    the ragged rows ids [m] (int64 amplicon ids), row after row in the
    slot order. Rows of one length are taken together, each at its own
    length. The plain version of keygen_count and keygen_emit."""
    m = ids.numel()
    dev = words.device
    lens = lengths[ids].long()
    counts = torch.zeros(m, dtype=torch.int64, device=dev)
    parts = []
    for L in torch.unique(lens).tolist():
        if L == 0:
            continue
        rows = torch.nonzero(lens == L)[:, 0]
        step = max(1, _PLAIN_STEP // (7 * L + 4))
        for i in range(0, rows.numel(), step):
            sel = rows[i:i + step]
            amps = ids[sel]
            (hi, lo), _, valid = variant_hash_halves(
                _row_codes(words, row_word, lengths, amps, L), lengths[amps],
                zob)
            keys, valid = _slot_order(hi, lo, valid, L)
            counts[sel] = valid.sum(dim=1)
            at = torch.nonzero(valid)
            parts.append((keys[valid], sel[at[:, 0]],
                          (torch.cumsum(valid, dim=1) - 1)[valid]))
    starts = torch.cumsum(counts, dim=0) - counts
    keys = torch.empty(int(counts.sum()) if m else 0, dtype=torch.int64,
                       device=dev)
    for k, row, rank in parts:
        keys[starts[row] + rank] = k
    return keys, counts


def _check_side(words, row_word, lengths, ids):
    sj._check_ragged(words, row_word, lengths)
    if ids.dim() != 1 or ids.dtype != torch.int64 or \
            ids.device != words.device:
        raise ValueError("ids must be an [m] int64 tensor beside the rows")
    if words.device.type == "cpu" and ids.numel() and (
            int(ids.min()) < 0 or int(ids.max()) >= lengths.numel()):
        raise ValueError("an id is outside the rows")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def variant_counts_reference(words, row_word, lengths, ids):
    """[m] int32: 6L + 4 plus the run starts of each row ids[i] (0 for an
    empty row); the plain version of keygen_count."""
    lens = lengths[ids].long()
    runs = torch.zeros(ids.numel(), dtype=torch.int64, device=words.device)
    for w, sel in sj._width_steps(sj.row_sizes(lens)):
        amps = ids[sel]
        table = sj.unpack2bit(sj.gather_rows(words, row_word, lengths, amps,
                                             w))
        _, valid = sj._valid_slots(table, lengths[amps])
        runs[sel] = valid[:, 1:].sum(dim=1)
    return torch.where(lens > 0, 6 * lens + 4 + runs, 0).to(torch.int32)


def keygen_count(words, row_word, lengths, ids) -> torch.Tensor:
    """[m] int32: the valid variants of each row ids[i] (6L + 4 + its run
    starts, 0 for an empty row)."""
    _check_side(words, row_word, lengths, ids)
    m = ids.numel()
    if words.device.type == "cpu":
        return variant_counts_reference(words, row_word, lengths, ids)
    from .._build import load

    counts = torch.empty(m, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        err = load().swarm_graft_keygen_count(
            words.data_ptr(), words.numel(), row_word.contiguous().data_ptr(),
            lengths.contiguous().data_ptr(), lengths.numel(),
            ids.contiguous().data_ptr(), m, counts.data_ptr(),
            sj._stream(words))
    if m:
        _raise_on(err, "graft_keygen")
    return counts


def keygen_emit(words, row_word, lengths, ids, zob, ends, total: int):
    """(keys [total] int64, payloads [total] int32): the valid variant
    keys of rows ids in the slot order, and each key's index (its
    payload). `zob` is zobrist_tensor's, `ends` the inclusive int64
    cumsum of keygen_count's counts and `total` its last value (< 2^31)."""
    _check_side(words, row_word, lengths, ids)
    m = ids.numel()
    if ends.dtype != torch.int64 or ends.shape != (m,):
        raise ValueError("ends must be an [m] int64 tensor")
    if total > _INT32_MAX:
        raise ValueError("a side or strip takes fewer than 2^31 keys")
    if zob.dim() != 3 or zob.shape[1:] != (4, 2) or zob.device != words.device:
        raise ValueError("zob must be a [rows, 4, 2] table beside the rows")
    if words.device.type == "cpu":
        if m and int(lengths[ids].max()) + 2 > zob.shape[0]:
            raise ValueError("a row is too long for the Zobrist table")
        keys, _ = variant_keys_reference(words, row_word, lengths, ids, zob)
        if keys.numel() != total:
            raise ValueError(f"total {total} is not the rows' {keys.numel()}")
        return keys, torch.arange(total, dtype=torch.int32)
    from .._build import load

    if zob.dtype != torch.int32 or not zob.is_contiguous():
        raise ValueError("the kernel takes zobrist_tensor's int32 table")
    keys = torch.empty(total, dtype=torch.int64, device=words.device)
    pays = torch.empty(total, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        err = load().swarm_graft_keygen_emit(
            words.data_ptr(), words.numel(), row_word.contiguous().data_ptr(),
            lengths.contiguous().data_ptr(), lengths.numel(),
            ids.contiguous().data_ptr(), m, zob.data_ptr(), zob.shape[0],
            ends.contiguous().data_ptr(), keys.data_ptr(), pays.data_ptr(),
            sj._stream(words))
    if m:
        _raise_on(err, "graft_keygen")
    return keys, pays


class JoinRecord(NamedTuple):
    """What join_count leaves for join_emit: rec [m_big] int64, from
    chunk k's first element on one record a big element that pairs, in
    place order, (head << 32) | (min(count, COUNT_MAX) << PLACE_BITS) |
    place, head the first small element of its key, count its small
    elements, place the big element's place in its chunk; n_rec
    [n_chunks] int32, each chunk's records; links [m_small] int32, each
    small element's next element of its key in partition order (-1 after
    the last; the kernel writes only those of a key that repeats)."""
    rec: torch.Tensor
    n_rec: torch.Tensor
    links: torch.Tensor


def join_items(b_ends, m_big: int, chunk: int = JOIN_CHUNK):
    """(first, last) [n_chunks] int64: the buckets of the first and the
    last element of each chunk [k * chunk, (k + 1) * chunk) of a big side
    of m_big keys partitioned at b_ends (one torch.searchsorted, no
    readback). A chunk is the join's item: a bucket beyond `chunk` spreads
    over several, small buckets come several to one."""
    starts = torch.arange(0, m_big, chunk, device=b_ends.device)
    at = torch.stack([starts, (starts + chunk).clamp(max=m_big) - 1])
    first, last = torch.searchsorted(b_ends, at, right=True)
    return first, last


def join_record_reference(skeys, s_ends, bkeys, b_ends,
                          chunk: int = JOIN_CHUNK):
    """(counts [n_chunks] int64, JoinRecord): the pairs of each chunk of
    the big side, and the record of the pairs (links of every small
    element); the plain version of join_count. The sides are partitioned
    into the same buckets, so equal keys share one."""
    dev = bkeys.device
    m_big = bkeys.numel()
    n_chunks = -(-m_big // chunk)
    sk, perm = torch.sort(skeys, stable=True)
    lo = torch.searchsorted(sk, bkeys)
    cnt = torch.searchsorted(sk, bkeys, right=True) - lo
    head = perm[lo.clamp(max=max(skeys.numel() - 1, 0))] if skeys.numel() \
        else torch.zeros_like(lo)
    e = torch.arange(m_big, device=dev)
    k = e // chunk
    counts = torch.zeros(n_chunks, dtype=torch.int64, device=dev)
    counts.index_add_(0, k, cnt)
    hit = cnt > 0
    n_rec = torch.bincount(k[hit], minlength=n_chunks).to(torch.int32)
    before = torch.cumsum(n_rec.long(), 0) - n_rec
    rank = torch.cumsum(hit.long(), 0) - 1 - before[k]
    bits = chunk.bit_length() - 1
    rec = torch.full((m_big,), -1, dtype=torch.int64, device=dev)
    rec[(k * chunk + rank)[hit]] = (head[hit] << 32) | (
        cnt[hit].clamp(max=(1 << (32 - bits)) - 1) << bits) | (e % chunk)[hit]
    links = torch.full((skeys.numel(),), -1, dtype=torch.int32, device=dev)
    same = sk[1:] == sk[:-1]
    links[perm[:-1][same]] = perm[1:][same].to(torch.int32)
    return counts, JoinRecord(rec, n_rec, links)


def join_emit_reference(spays, bpays, record: JoinRecord,
                        chunk: int = JOIN_CHUNK) -> torch.Tensor:
    """[P] int64 pairs (spay << 32) | bpay of a JoinRecord: record after
    record, each its head's chain along the links; the plain version of
    join_emit."""
    rec, n_rec, links = record
    bits = chunk.bit_length() - 1
    e = torch.arange(rec.numel(), device=rec.device)
    valid = e % chunk < n_rec.long()[e // chunk]
    v = rec[valid]
    at = (e[valid] // chunk) * chunk + (v & (chunk - 1))
    cur = v >> 32
    cnt = (v & sj.MASK32) >> bits
    for i in torch.nonzero(cnt == (1 << (32 - bits)) - 1)[:, 0].tolist():
        j, c = int(cur[i]), 1
        while int(links[j]) >= 0:
            j, c = int(links[j]), c + 1
        cnt[i] = c
    offsets = torch.cumsum(cnt, 0) - cnt
    pb = bpays[at].long() & sj.MASK32
    pairs = torch.empty(int(cnt.sum()), dtype=torch.int64, device=rec.device)
    for step in range(int(cnt.max()) if cnt.numel() else 0):
        live = cnt > step
        pairs[offsets[live] + step] = (spays[cur[live]].long() << 32) | pb[live]
        cur = torch.where(live & (cnt > step + 1),
                          links[cur.clamp(min=0)].long(), cur)
    return pairs


def join_reference(skeys, spays, bkeys, bpays) -> torch.Tensor:
    """[P] int64 pairs (spay << 32) | bpay of every small key equal to a
    big key: the big keys in their order, each with its equal small keys
    in theirs. Keys in any order; the plain version of join_pairs."""
    dev = bkeys.device
    sk, perm = torch.sort(skeys, stable=True)
    lo = torch.searchsorted(sk, bkeys)
    cnt = torch.searchsorted(sk, bkeys, right=True) - lo
    j = torch.repeat_interleave(torch.arange(bkeys.numel(), device=dev), cnt)
    within = torch.arange(j.numel(), device=dev) - (
        torch.cumsum(cnt, dim=0) - cnt)[j]
    i = perm[lo[j] + within]
    return spays[i].long() * (1 << 32) + bpays[j].long()


def join_count(skeys, s_ends, bkeys, b_ends):
    """(counts [n_chunks] int64, JoinRecord): the pairs of each chunk of
    JOIN_CHUNK big elements (the join's items) of two sides partitioned
    into the same buckets, and their record for join_emit. Writes neither
    side."""
    sj._check_partitioned(skeys, None, s_ends)
    sj._check_partitioned(bkeys, None, b_ends)
    if s_ends.shape != b_ends.shape or skeys.device != bkeys.device:
        raise ValueError("both sides must be partitioned into the same "
                         "buckets on one device")
    if bkeys.device.type == "cpu":
        return join_record_reference(skeys, s_ends, bkeys, b_ends)
    from .._build import load

    dev = bkeys.device
    m_big = bkeys.numel()
    first, last = join_items(b_ends, m_big)
    counts = torch.empty(first.numel(), dtype=torch.int64, device=dev)
    record = JoinRecord(
        torch.empty(m_big, dtype=torch.int64, device=dev),
        torch.empty(first.numel(), dtype=torch.int32, device=dev),
        torch.empty(skeys.numel(), dtype=torch.int32, device=dev))
    if m_big == 0:
        return counts, record
    with torch.cuda.device(dev):
        err = load().swarm_graft_join_count(
            skeys.data_ptr(), s_ends.contiguous().data_ptr(),
            bkeys.data_ptr(), m_big, b_ends.contiguous().data_ptr(),
            first.data_ptr(), last.data_ptr(), counts.data_ptr(),
            record.rec.data_ptr(), record.n_rec.data_ptr(),
            record.links.data_ptr(), sj._stream(bkeys))
    _raise_on(err, "graft_join")
    return counts, record


def join_emit(spays, bpays, record: JoinRecord, ends,
              total: int) -> torch.Tensor:
    """[total] int64 pairs in join_reference's order, from join_count's
    record alone; `ends` is the inclusive cumsum of join_count's counts,
    `total` its last value."""
    rec, n_rec, links = record
    m_big = bpays.numel()
    if spays.dtype != torch.int32 or bpays.dtype != torch.int32 or \
            spays.shape != links.shape or rec.shape != bpays.shape:
        raise ValueError("payloads must be [m] int32 tensors of the sides "
                         "join_count saw")
    if ends.dtype != torch.int64 or ends.shape != n_rec.shape or \
            n_rec.numel() != -(-m_big // JOIN_CHUNK):
        raise ValueError("ends must be an [n_chunks] int64 tensor")
    if rec.dtype != torch.int64 or n_rec.dtype != torch.int32 or \
            links.dtype != torch.int32:
        raise ValueError("the record must be join_count's")
    if any(t.device != bpays.device for t in (spays, *record, ends)):
        raise ValueError("the payloads, the record and ends must share a "
                         "device")
    if bpays.device.type == "cuda" and not all(
            t.is_contiguous() for t in record):
        raise ValueError("the kernel takes a contiguous record")
    if bpays.device.type == "cpu":
        pairs = join_emit_reference(spays, bpays, record)
        if pairs.numel() != total:
            raise ValueError(f"total {total} is not the sides' {pairs.numel()}")
        return pairs
    from .._build import load

    pairs = torch.empty(total, dtype=torch.int64, device=bpays.device)
    if total == 0:
        return pairs
    with torch.cuda.device(bpays.device):
        err = load().swarm_graft_join_emit(
            spays.contiguous().data_ptr(), bpays.contiguous().data_ptr(),
            m_big, rec.data_ptr(), n_rec.data_ptr(), links.data_ptr(),
            ends.contiguous().data_ptr(), pairs.data_ptr(),
            sj._stream(bpays))
    _raise_on(err, "graft_join")
    return pairs


def join_pairs(skeys, spays, s_ends, bkeys, bpays, b_ends) -> torch.Tensor:
    """Cross-side pairs of two sides partitioned into the same buckets:
    join_count, torch.cumsum, one readback of the total, join_emit."""
    counts, record = join_count(skeys, s_ends, bkeys, b_ends)
    ends, total = sj._cumsum_total(counts)
    return join_emit(spays, bpays, record, ends, total)


def decode_payloads(ids, ends, pays):
    """(amps, slots) int64 of payloads of a side: the row whose keys hold
    each (ends = inclusive cumsum of the rows' key counts), and the key's
    index within it."""
    row = torch.searchsorted(ends, pays.long(), right=True)
    if row.numel() and int(row.max()) >= ends.numel():
        raise ValueError("a payload is outside its side")
    start = torch.where(row > 0, ends[(row - 1).clamp(min=0)], 0)
    return ids[row], pays.long() - start


def variant_rows_reference(words, row_word, lengths, amps, slots,
                           width: int):
    """([P, width] uint8 codes, [P] int64 lengths) of the variants (amp,
    slot) in the slot order, zero past each length (width >= L + 1)."""
    codes = _row_codes(words, row_word, lengths, amps, width)
    L = lengths[amps].long()
    idx = torch.arange(width, device=codes.device)[None, :]
    tail = slots < 4
    mid = ~tail & (slots < 4 + 6 * L)
    q = (slots - 4).clamp(min=0)
    p, j = q // 6, q % 6
    s_p = codes.gather(1, p.clamp(max=width - 1)[:, None])[:, 0].long()
    k = j % 3
    other = k + (s_p <= k).long()
    # a deletion's position: the rank-th run start
    runs = (idx < L[:, None]) & torch.cat(
        [torch.ones_like(codes[:, :1], dtype=torch.bool),
         codes[:, 1:] != codes[:, :-1]], dim=1)
    rank = slots - 4 - 6 * L
    hit = runs & (torch.cumsum(runs, dim=1) - 1 == rank[:, None])
    if bool((~tail & ~mid & ~hit.any(dim=1)).any()):
        raise ValueError("a deletion slot past the row's run starts")
    dpos = hit.long().argmax(dim=1)
    vtype = torch.where(tail, 2, torch.where(mid, torch.where(j < 3, 0, 2), 1))
    pos = torch.where(tail, 0, torch.where(mid, torch.where(j < 3, p, p + 1),
                                           dpos))
    base = torch.where(tail, slots, other)
    out_len = L + torch.where(vtype == 1, -1, torch.where(vtype == 2, 1, 0))
    pos_c, vt = pos[:, None], vtype[:, None]
    src = torch.where(vt == 1, idx + (idx >= pos_c).long(),
                      torch.where(vt == 2, idx - (idx > pos_c).long(), idx))
    out = codes.gather(1, src.clamp(0, width - 1))
    out = torch.where((vt != 1) & (idx == pos_c), base[:, None].to(out.dtype),
                      out)
    return torch.where(idx < out_len[:, None], out, 0), out_len


def verify_reference(words, row_word, lengths, s_ids, s_ends, b_ids, b_ends,
                     pairs) -> torch.Tensor:
    """[P] bool: whether the two variants of each pair (spay << 32) | bpay
    are the same sequence; pairs of one width are taken together. The
    plain version of verify."""
    s_amp, s_slot = decode_payloads(s_ids, s_ends, pairs >> 32)
    b_amp, b_slot = decode_payloads(b_ids, b_ends, pairs & sj.MASK32)
    longest = torch.maximum(lengths[s_amp], lengths[b_amp]).long()
    ok = torch.zeros(pairs.numel(), dtype=torch.bool, device=pairs.device)
    for w, sel in sj._width_steps(sj.row_sizes(longest + 1)):
        width = w * sj.BASES_PER_WORD
        ra, la = variant_rows_reference(words, row_word, lengths, s_amp[sel],
                                        s_slot[sel], width)
        rb, lb = variant_rows_reference(words, row_word, lengths, b_amp[sel],
                                        b_slot[sel], width)
        ok[sel] = (la == lb) & (ra == rb).all(dim=1)
    return ok


def best_reference(s_ids, s_ends, b_ids, b_ends, good, small_is_heavy,
                   best):
    """best [n] int32 lowered in place, for the light amplicon of every
    pair of `good`, to the pair's heavy amplicon if it is smaller."""
    s_amp, _ = decode_payloads(s_ids, s_ends, good >> 32)
    b_amp, _ = decode_payloads(b_ids, b_ends, good & sj.MASK32)
    heavy, light = (s_amp, b_amp) if small_is_heavy else (b_amp, s_amp)
    best.scatter_reduce_(0, light, heavy.to(torch.int32), reduce="amin")
    return best


def verify(words, row_word, lengths, s_ids, s_ends, b_ids, b_ends, pairs,
           small_is_heavy: bool, best) -> torch.Tensor:
    """[P] bool: verify_reference's flags; and best [n] int32 lowered, for
    the light amplicon of every good pair, to the pair's heavy amplicon
    if it is smaller (in place)."""
    _check_side(words, row_word, lengths, s_ids)
    _check_side(words, row_word, lengths, b_ids)
    if pairs.dim() != 1 or pairs.dtype != torch.int64 or \
            pairs.device != words.device:
        raise ValueError("pairs must be a [P] int64 tensor beside the rows")
    if best.dtype != torch.int32 or best.shape != lengths.shape or \
            best.device != words.device:
        raise ValueError("best must be an [n] int32 tensor beside the rows")
    for ids, ends in ((s_ids, s_ends), (b_ids, b_ends)):
        if ends.dtype != torch.int64 or ends.shape != ids.shape:
            raise ValueError("ends must be an [m] int64 tensor a side")
    if words.device.type == "cpu":
        ok = verify_reference(words, row_word, lengths, s_ids, s_ends, b_ids,
                              b_ends, pairs)
        best_reference(s_ids, s_ends, b_ids, b_ends, pairs[ok],
                       small_is_heavy, best)
        return ok
    from .._build import load

    ok = torch.empty(pairs.numel(), dtype=torch.bool, device=words.device)
    if pairs.numel() == 0:
        return ok
    with torch.cuda.device(words.device):
        err = load().swarm_graft_verify(
            words.data_ptr(), words.numel(), row_word.contiguous().data_ptr(),
            lengths.contiguous().data_ptr(), lengths.numel(),
            s_ids.contiguous().data_ptr(), s_ends.contiguous().data_ptr(),
            s_ids.numel(), b_ids.contiguous().data_ptr(),
            b_ends.contiguous().data_ptr(), b_ids.numel(),
            pairs.contiguous().data_ptr(), pairs.numel(), int(small_is_heavy),
            ok.data_ptr(), best.data_ptr(), sj._stream(words))
    _raise_on(err, "graft_verify")
    return ok


#: the [timing] phases of a graft, in order
PHASES = ("H2D", "keygen count", "keygen emit", "partition", "join",
          "verify", "D2H", "host finish")


class GraftEngine:
    """Device-side graft-candidate discovery for the fastidious pass, on
    `device` (None: cuda:0, raising without it).

    `rows`: the ragged rows (words, row_word, lengths) that the d=1
    engine left on the device, or None: the arena is copied and packed
    by d1_keygen's count pass. With SWARM_TPU_TIMING set it writes a
    `[timing] graft` line a phase (summed over the strips), the device
    synchronised between phases.
    """

    #: keys a strip of the bigger side holds at most; None: as many as
    #: half the free device memory takes at 24 bytes a key (keys,
    #: payloads and the partition's scratch pair; the join's 8-byte
    #: record comes after the scratch is freed), below 2^31
    MAX_STRIP_KEYS = None
    #: the same budget on the CPU, where the plain versions run
    CPU_STRIP_KEYS = 1 << 26

    def __init__(self, db, device=None, rows=None):
        self.db = db
        self.n = len(db)
        self.device = default_device() if device is None \
            else torch.device(device)
        self._rows = rows
        self._timing = bool(os.environ.get("SWARM_TPU_TIMING"))

    def _phase(self, spent, name, t0):
        if not self._timing:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        spent[name] = spent.get(name, 0.0) + now - t0
        return now

    def _strip_keys(self, small_keys: int) -> int:
        if self.MAX_STRIP_KEYS is not None:
            return self.MAX_STRIP_KEYS
        if self.device.type == "cpu":
            return self.CPU_STRIP_KEYS
        free, _ = torch.cuda.mem_get_info(self.device)
        return max(1, min(_INT32_MAX, (free // 2 - 24 * small_keys) // 24))

    def packed_rows(self):
        """(words, row_word, lengths) of every row on the device."""
        if self._rows is None:
            codes, offsets, lengths, row_word, n_words = \
                sj.SortJoinNeighborEngine(self.db, self.device).arena()
            _, words = sj.keygen_count(codes, offsets, lengths, row_word,
                                       n_words)
            self._rows = (words, row_word, lengths)
        return self._rows

    def graft_candidates(self, heavy_amps: np.ndarray,
                         light_amps: np.ndarray):
        """(count, graft_cand [n] int64, -1 where none): the verified
        (heavy, light, midpoint) triples and each light amplicon's
        smallest heavy one."""
        graft_cand = np.full(self.n, -1, dtype=np.int64)
        if len(heavy_amps) == 0 or len(light_amps) == 0:
            return 0, graft_cand
        spent = {}
        dev = self.device
        t0 = time.perf_counter()
        words, row_word, lengths = self.packed_rows()
        lens = np.asarray(self.db.lengths, dtype=np.int64)
        zob = zobrist_tensor(make_zobrist_pair(max(int(lens.max()), 1)), dev)
        heavy = np.asarray(heavy_amps, dtype=np.int64)
        light = np.asarray(light_amps, dtype=np.int64)
        small_is_heavy = (7 * lens[heavy] + 4).sum() <= \
            (7 * lens[light] + 4).sum()
        small, big = (heavy, light) if small_is_heavy else (light, heavy)
        s_ids = torch.from_numpy(small).to(dev)
        b_ids = torch.from_numpy(big).to(dev)
        t0 = self._phase(spent, "H2D", t0)

        s_ends, s_total = sj._cumsum_total(keygen_count(words, row_word,
                                                        lengths, s_ids))
        b_counts = keygen_count(words, row_word, lengths, b_ids).cpu().numpy()
        budget = self._strip_keys(s_total)
        strips = _strips(b_counts, budget)
        bits = sj.bucket_bits(s_total + max(
            int(b_counts[a:b].sum()) for a, b in strips))
        t0 = self._phase(spent, "keygen count", t0)
        if s_total > _INT32_MAX:
            raise ValueError("the smaller side has 2^31 keys or more")
        skeys, spays = keygen_emit(words, row_word, lengths, s_ids, zob,
                                   s_ends, s_total)
        t0 = self._phase(spent, "keygen emit", t0)
        skeys, spays, s_bucket_ends = sj.partition(skeys, spays, bits)
        t0 = self._phase(spent, "partition", t0)

        best = torch.full((self.n,), _INT32_MAX, dtype=torch.int32,
                          device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        for a, b in strips:
            ids = b_ids[a:b]
            cum = np.cumsum(b_counts[a:b], dtype=np.int64)
            ends, total = torch.from_numpy(cum).to(dev), int(cum[-1])
            t0 = self._phase(spent, "keygen count", t0)
            bkeys, bpays = keygen_emit(words, row_word, lengths, ids, zob,
                                       ends, total)
            t0 = self._phase(spent, "keygen emit", t0)
            bkeys, bpays, b_bucket_ends = sj.partition(bkeys, bpays, bits)
            t0 = self._phase(spent, "partition", t0)
            pairs = join_pairs(skeys, spays, s_bucket_ends, bkeys, bpays,
                               b_bucket_ends)
            del bkeys, bpays, b_bucket_ends
            t0 = self._phase(spent, "join", t0)
            ok = verify(words, row_word, lengths, s_ids, s_ends, ids, ends,
                        pairs, small_is_heavy, best)
            count += ok.sum()
            del pairs, ok
            t0 = self._phase(spent, "verify", t0)
        best = best.cpu().numpy()
        total = int(count)
        t0 = self._phase(spent, "D2H", t0)
        graft_cand = np.where(best == _INT32_MAX, -1, best.astype(np.int64))
        self._phase(spent, "host finish", t0)
        for name in PHASES:
            if name in spent:
                sys.__stderr__.write(
                    f"[timing] graft ({dev.type}) {name:<14} "
                    f"{spent[name]:8.3f}s\n")
        return total, graft_cand


def _strips(counts: np.ndarray, budget: int):
    """[(start, end)] row ranges of a side whose key counts sum to at
    most `budget` each (at least one row a strip)."""
    cum = np.cumsum(counts, dtype=np.int64)
    strips, start = [], 0
    while start < len(cum):
        base = cum[start - 1] if start else 0
        end = max(int(np.searchsorted(cum, base + budget, side="right")),
                  start + 1)
        strips.append((start, end))
        start = end
    return strips
