"""swarm_tpu_torch's d=1 partition and bucket join
(ops/neighbors_sortjoin.py: bucket_of, partition, join_pairs) on the
CPU, exactly:

- partition_reference is stable, its bucket_ends cover every key, and
  equal keys share a bucket (edge rows, 1-nt rows, a run of insertions);
- numpy emulations of the kernels' schedules (csrc/d1_join.cu): the
  partition's tile histograms, the digit-major scan, the in-tile ranks of
  each warp's chunks and the staged store, the bounds' binary search;
  the join's shared-memory table, the list of repeated keys with its
  one-warp links, the emit pass from that record, and the
  oversized-bucket variant, run with a small tile; held
  against partition_reference, join_buckets_reference and brute force;
- the candidates of partition + join against swarm_tpu's join_pairs fed
  with the same keys as its deletion_keys_poly halves.

tests/test_torch_cuda.py holds the kernels against the plain versions
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_tpu.ops import neighbors_sortjoin as jax_sj
from swarm_tpu_torch.corpora import d1_edge_rows, insertion_run
from swarm_tpu_torch.ops import neighbors_sortjoin as sj
from test_torch_d1_sortjoin import _arena, _case_db, _jax_keys, _rows_db

M64 = (1 << 64) - 1


def _row_keys(rows):
    """(keys, owners) of code rows, through the port's keygen."""
    keys, owners, _ = sj.deletion_keys(*_arena(_rows_db(rows)))
    return keys, owners


def _key_case(case):
    """(keys, owners) of a case: the keys of a corpus in keygen order, or
    random keys with many equal ones."""
    if case == "edge_rows":
        return _row_keys(d1_edge_rows())
    if case == "one_nt_rows":  # their keys are 1..4 and the empty row's 0
        return _row_keys([np.array([c], np.uint8) for c in range(4)]
                         + [np.array([c, 3 - c], np.uint8) for c in range(4)])
    if case == "insertion_run":
        return _row_keys(insertion_run())
    rng = np.random.default_rng(int(case[-1]))
    m = 3000
    keys = rng.integers(-40, 40, size=m) * (1 << 40) + rng.integers(0, 4, m)
    return (torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(rng.integers(0, 900, m).astype(np.int32)))


KEY_CASES = ["edge_rows", "one_nt_rows", "insertion_run", "random0",
             "random1"]


# ---- numpy emulations of the kernels --------------------------------------

def _bucket_np(keys, bits):
    """bucket_of as the kernels compute it, in uint32 arithmetic."""
    u = keys.astype(np.int64).view(np.uint64)
    h0, h1 = u >> np.uint64(32), u & np.uint64(0xFFFFFFFF)
    m32 = np.uint64(0xFFFFFFFF)
    mix = ((((h1 * np.uint64(0x9E3779B1)) & m32) ^ h0)
           * np.uint64(0x85EBCA6B)) & m32
    if bits == 0:
        return np.zeros(len(keys), dtype=np.int64)
    return (mix >> np.uint64(32 - bits)).astype(np.int64)


def emulate_partition(keys, owners, bits, warps=8, items=16):
    """(keys, owners, bucket_ends) as the partition's kernels compute
    them: per pass, each tile's digit histogram (count kernel), the
    digit-major inclusive cumsum, then the scatter kernel: warp w holds
    chunks of 32 consecutive elements of the w-th span of the tile, the
    warps' per-digit counts (the lowest lane of a group of equal digits,
    found by one ballot a digit bit, adds the group's size), their
    exclusive prefix over the warps, the digits' exclusive scan in 32
    lanes' spans, each element's place in the staged tile (digit start +
    earlier warps and chunks + rank among its peers), and the store from
    the staged tile; then each bucket's end by binary search."""
    tile = warps * items * 32
    keys, owners = np.asarray(keys).copy(), np.asarray(owners).copy()
    m = len(keys)
    n_tiles = -(-m // tile)
    lanes = np.arange(32)
    for shift, width in sj.digit_passes(bits):
        radix = 1 << width
        digit = (_bucket_np(keys, bits) >> shift) & (radix - 1)
        counts = np.stack([np.bincount(digit[t * tile:(t + 1) * tile],
                                       minlength=radix)
                           for t in range(n_tiles)], axis=1)
        ends = np.cumsum(counts.reshape(-1)).reshape(radix, n_tiles)
        out_k, out_o = np.empty_like(keys), np.empty_like(owners)
        for t in range(n_tiles):
            first = t * tile
            n_here = min(tile, m - first)

            def chunk(w, c):
                e = (w * items + c) * 32 + lanes
                valid = e < n_here
                return e, np.where(valid, digit[np.minimum(first + e, m - 1)],
                                   -1 - lanes)

            whist = np.zeros((warps, radix), dtype=np.int64)
            for w in range(warps):
                for c in range(items):
                    _, dig = chunk(w, c)
                    for lane in lanes:
                        peers = dig == dig[lane]
                        if dig[lane] >= 0 and not peers[:lane].any():
                            whist[w, dig[lane]] += peers.sum()
            tot = whist.sum(axis=0)
            whist = np.cumsum(whist, axis=0) - whist
            gbase = ends[:, t] - tot
            per = -(-radix // 32)
            spans = [tot[min(lane * per, radix):min(lane * per + per, radix)]
                     for lane in lanes]
            sums = np.array([s.sum() for s in spans])
            tstart = np.concatenate([
                (np.cumsum(sums) - sums)[lane] + np.cumsum(s) - s
                for lane, s in enumerate(spans)]).astype(np.int64)
            staged_k = np.zeros(n_here, dtype=keys.dtype)
            staged_o = np.zeros(n_here, dtype=owners.dtype)
            for w in range(warps):
                for c in range(items):
                    e, dig = chunk(w, c)
                    base = {d: whist[w, d] for d in dig if d >= 0}
                    for lane in lanes:
                        d = dig[lane]
                        if d < 0:
                            continue
                        at = tstart[d] + base[d] + (dig[:lane] == d).sum()
                        staged_k[at] = keys[first + e[lane]]
                        staged_o[at] = owners[first + e[lane]]
                    for d in base:
                        whist[w, d] = base[d] + (dig == d).sum()
            for e in range(n_here):
                d = (_bucket_np(staged_k[e:e + 1], bits)[0] >> shift) & (
                    radix - 1)
                at = gbase[d] + e - tstart[d]
                out_k[at], out_o[at] = staged_k[e], staged_o[e]
        keys, owners = out_k, out_o
    bucket = _bucket_np(keys, bits)
    bucket_ends = []
    for b in range(1 << bits):
        lo, hi = 0, m
        while lo < hi:
            mid = (lo + hi) >> 1
            if bucket[mid] <= b:
                lo = mid + 1
            else:
                hi = mid
        bucket_ends.append(lo)
    return keys, owners, np.array(bucket_ends, dtype=np.int64)


def _slot_np(key, slot_bits):
    """slot_of: the top slot_bits bits of key * 0x9E3779B97F4A7C15 mod 2^64."""
    return ((int(key) & M64) * 0x9E3779B97F4A7C15 & M64) >> (64 - slot_bits)


def _pack(a, b):
    return min(a, b) << 32 | max(a, b)


def emulate_join(keys, owners, bucket_ends, cap=1536, threads=256):
    """(counts, pairs) as the join's kernels compute them. The count
    pass, one block a bucket of up to `cap` elements: the open-addressing
    table of its keys (a power of two of at least 4/3 cap slots, linear
    probing; a slot's head is the element that took it), each head's
    count, the elements of heads with two or more listed in element
    order, then warp 0 over the list in chunks of 32: each listed
    element's link (the place of the nearest lower peer of its head in
    the chunk, else the head's last place so far) and its pairs along
    its links; the record it leaves is the list and the links. The emit
    pass walks that record alone, place after place. A bigger bucket, in
    both passes: rounds of `threads` elements, each walking the earlier
    elements tile by tile (`cap` a tile), the nearest tile first."""
    slot_bits = (4 * cap // 3 - 1).bit_length()
    counts, pairs = [], []
    for b in range(len(bucket_ends)):
        lo = int(bucket_ends[b - 1]) if b else 0
        s = int(bucket_ends[b]) - lo
        K = [int(k) for k in keys[lo:lo + s]]
        O = [int(o) for o in owners[lo:lo + s]]
        got = []
        if s <= cap:
            table, head = {}, []
            for t in range(s):
                h = _slot_np(K[t], slot_bits)
                while h in table and K[table[h]] != K[t]:
                    h = (h + 1) % (1 << slot_bits)
                head.append(table.setdefault(h, t))
            n_of = np.bincount(head, minlength=max(s, 1))
            listed = [t for t in range(s) if n_of[head[t]] >= 2]
            last, link = {}, []
            for base in range(0, len(listed), 32):
                chunk = listed[base:base + 32]
                for i, t in enumerate(chunk):
                    lower = [base + u for u in range(i)
                             if head[chunk[u]] == head[t]]
                    link.append(lower[-1] if lower else last.get(head[t], -1))
                for i, t in enumerate(chunk):
                    last[head[t]] = base + i
            count = 0
            for i, t in enumerate(listed):  # the count pass
                j = link[i]
                while j >= 0:
                    count += O[listed[j]] != O[t]
                    j = link[j]
            for i, t in enumerate(listed):  # the emit pass, from the record
                j = link[i]
                while j >= 0:
                    if O[listed[j]] != O[t]:
                        got.append(_pack(O[t], O[listed[j]]))
                    j = link[j]
            assert count == len(got)
        else:
            for r in range(0, s, threads):
                for t in range(r, min(r + threads, s)):
                    j1 = min(r + threads, s)
                    while j1 > 0:
                        j0 = max(j1 - cap, 0)
                        for j in range(min(j1, t) - 1, j0 - 1, -1):
                            if K[j] == K[t] and O[j] != O[t]:
                                got.append(_pack(O[t], O[j]))
                        j1 -= cap
        counts.append(len(got))
        pairs += got
    return np.array(counts, dtype=np.int64), np.array(pairs, dtype=np.int64)


def _brute_force(keys, owners):
    keys, owners = np.asarray(keys), np.asarray(owners)
    return sorted(_pack(int(owners[i]), int(owners[j]))
                  for i in range(len(keys)) for j in range(i)
                  if keys[i] == keys[j] and owners[i] != owners[j])


# ---- the partition --------------------------------------------------------

@pytest.mark.parametrize("case", KEY_CASES)
def test_partition_reference_is_stable_and_groups_equal_keys(case):
    keys, owners = _key_case(case)
    bits = max(sj.bucket_bits(keys.numel()), 4)
    pkeys, powners, ends = sj.partition_reference(keys, owners, bits)
    bucket = sj.bucket_of(keys, bits)
    assert ends.shape == (1 << bits,) and int(ends[-1]) == keys.numel()
    assert bool((ends[1:] >= ends[:-1]).all())
    at = torch.searchsorted(ends, torch.arange(keys.numel()), right=True)
    assert torch.equal(sj.bucket_of(pkeys, bits), at)  # every key covered
    # stable: within a bucket the keygen's order
    order = torch.argsort(bucket, stable=True)
    assert bool((order[1:] > order[:-1])[at[1:] == at[:-1]].all())
    assert torch.equal(pkeys, keys[order]) and torch.equal(powners,
                                                          owners[order])
    # equal keys share a bucket, and the buckets are spread
    uniq, inv = torch.unique(keys, return_inverse=True)
    first = torch.full((uniq.numel(),), -1, dtype=torch.int64)
    first[inv] = bucket
    assert torch.equal(first[inv], bucket)
    assert torch.unique(bucket).numel() > min(uniq.numel(), 1 << bits) // 4
    # the wrapper on the CPU is the plain version, in place
    k2, o2 = keys.clone(), owners.clone()
    got = sj.partition(k2, o2, bits)
    assert got[0] is k2 and got[1] is o2
    assert torch.equal(k2, pkeys) and torch.equal(o2, powners)
    assert torch.equal(got[2], ends)


def test_bucket_of_spreads_short_rows_and_small_keys():
    """The 1-nt rows' keys (1..4 and 0, as both halves) and keys that
    differ only in their low bits land in distinct buckets: the mixer,
    not the raw top bits, names the bucket."""
    h = torch.arange(5)
    small = sj.make_keys(h, h)
    assert torch.unique(sj.bucket_of(small, 17)).numel() == 5
    low = torch.arange(1 << 12, dtype=torch.int64)
    assert torch.unique(sj.bucket_of(low, 8)).numel() > 200
    assert torch.equal(sj.bucket_of(low, 0), torch.zeros_like(low))


@pytest.mark.parametrize("m,bits", [(0, 0), (1024, 0), (1025, 2),
                                    (113_574_625, 17), (141_496_184, 18),
                                    (1 << 28, 18), (1 << 29, 19)])
def test_bucket_bits_and_passes(m, bits):
    assert sj.bucket_bits(m) == bits
    passes = sj.digit_passes(bits)
    assert len(passes) % 2 == 0
    assert sum(w for _, w in passes) == bits
    assert all(1 <= w <= sj.MAX_DIGIT_BITS for _, w in passes)
    assert [s for s, _ in passes] == [sum(w for _, w in passes[:i])
                                      for i in range(len(passes))]
    if bits:
        assert (m - 1) >> bits < sj.BUCKET_KEYS


@pytest.mark.parametrize("warps,items", [(8, 16), (2, 2)])
@pytest.mark.parametrize("case", KEY_CASES)
def test_partition_kernel_emulation(case, warps, items):
    keys, owners = _key_case(case)
    bits = max(sj.bucket_bits(keys.numel()), 5)
    want = sj.partition_reference(keys, owners, bits)
    got = emulate_partition(keys.numpy(), owners.numpy(), bits, warps, items)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


# ---- the join -------------------------------------------------------------

@pytest.mark.parametrize("cap,threads", [(1536, 256), (16, 8)])
@pytest.mark.parametrize("case", KEY_CASES)
def test_join_kernel_emulation(case, cap, threads):
    """In-tile buckets, oversized buckets (the insertion run's 125 equal
    keys, and every bucket above a 16-element tile), empty buckets."""
    keys, owners = _key_case(case)
    # many small buckets for the tile, a few big ones against 16 elements
    bits = sj.bucket_bits(keys.numel()) + (8 if cap > 16 else 0)
    pkeys, powners, ends = sj.partition(keys.clone(), owners.clone(), bits)
    want = sj.join_buckets_reference(pkeys, powners, ends)
    counts, pairs = emulate_join(pkeys.numpy(), powners.numpy(),
                                 ends.numpy(), cap, threads)
    np.testing.assert_array_equal(pairs, want.numpy())
    np.testing.assert_array_equal(
        counts, sj.join_count(pkeys, powners, ends)[0].numpy())
    assert torch.equal(sj.join_pairs(pkeys, powners, ends), want)
    assert sorted(want.tolist()) == _brute_force(keys, owners)
    sizes = torch.diff(ends, prepend=ends.new_zeros(1))
    if cap > 16:
        assert int((sizes == 0).sum()) > 0  # empty buckets
    else:
        assert int((sizes > cap).sum()) > 0  # the oversized variant ran


def test_join_wrappers_refuse_what_the_kernels_cannot_read():
    keys, owners = _key_case("random0")
    pkeys, powners, ends = sj.partition_reference(keys, owners, 3)
    with pytest.raises(ValueError, match="int64"):
        sj.join_count(pkeys.int(), powners, ends)
    with pytest.raises(ValueError, match="int32"):
        sj.join_count(pkeys, powners.long(), ends)
    with pytest.raises(ValueError, match="2\\^bits"):
        sj.join_count(pkeys, powners, ends[:7])
    with pytest.raises(ValueError, match="not partitioned"):
        sj.join_count(keys, owners, ends)
    with pytest.raises(ValueError, match="int32"):
        sj.partition(keys, owners.long(), 3)


# ---- the JAX reference ----------------------------------------------------

@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "seed3",
                                  "insertion_run"])
def test_candidates_equal_jax_join_pairs(case):
    """The unique candidates of partition + join equal the unique pairs
    of swarm_tpu's join_pairs on the same keys (its deletion_keys_poly
    halves, every slot, -1 owners for invalid ones), caps large enough
    (it pairs equal hi and a lo prefix, the port equal 64-bit keys)."""
    db = _case_db(case)
    j0, j1, jvalid = _jax_keys(case)
    n = len(db)
    owner = np.where(jvalid, np.arange(n)[:, None], -1).astype(np.int32)
    hi = np.asarray(j0).reshape(-1)
    valid_hi = hi[jvalid.reshape(-1)]
    _, run = np.unique(valid_hi, return_counts=True)
    M = hi.size
    cap2 = int((run * (run - 1) // 2).sum()) + 16
    fn = jax.jit(jax_sj.join_pairs, static_argnums=(3, 4, 5, 6))
    pa, pb, _, n_pairs, over, *_ = fn(
        jnp.asarray(hi), jnp.asarray(np.asarray(j1).reshape(-1)),
        jnp.asarray(owner.reshape(-1)), n, M, cap2, int(run.max()))
    assert int(over) == 0 and int(n_pairs) <= cap2
    pa, pb = np.asarray(pa), np.asarray(pb)
    want = np.unique(pa[pa >= 0].astype(np.int64) << 32 | pb[pa >= 0])

    keys, owners, _ = sj.deletion_keys(*_arena(db))
    got = sj.join_pairs(*sj.partition(keys, owners,
                                      sj.bucket_bits(keys.numel())))
    np.testing.assert_array_equal(torch.unique(got).numpy(), want)
    assert want.size > 0
