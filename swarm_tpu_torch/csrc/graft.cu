// Fastidious graft (-f) on ragged rows: variant keygen (count, emit), a
// cross-side join of the two sides' buckets, and the midpoint verify.
//
// Replaces the XLA programs of swarm_tpu/ops/fastidious_jax.py (the graft
// had no Pallas source):
//   variant_keys_hilo (:582), variant_keys_chunk (:102) and the Zobrist
//   hashes of variant_hash_halves (swarm_tpu/ops/neighbors_jax.py:126)
//                                        -> graft_count_kernel,
//                                           graft_emit_kernel
//                                           (swarm_graft_keygen_*)
//   graft_sort3 (:614) and build_graft_table (:123)
//                                        -> d1_partition (csrc/d1_join.cu),
//                                           run on each side with the same
//                                           bucket bits, and the hash table
//                                           of graft_join_count_kernel
//   graft_pairs3 (:626), _graft_probe_body (:154), graft_probe_all (:254)
//                                        -> graft_join_count_kernel,
//                                           graft_join_emit_kernel
//                                           (swarm_graft_join_*)
//   _variant_rows (:79), _decode_slots (:49), the per-light minimum of
//   GraftEngine.graft_candidates (:470-477)
//                                        -> graft_verify_kernel
//                                           (swarm_graft_verify)
// Plain PyTorch versions and the wrappers: swarm_tpu_torch/ops/
// fastidious_torch.py. JAX had two engines (a sort of both sides with a
// windowed run walk, and a sorted table plus byte-set probe for a small
// side); here one engine serves both regimes: the smaller side is
// partitioned once, the bigger side in strips by the same bucket bits, and
// each bucket of a strip meets the same bucket of the smaller side.
//
// Keys. A light amplicon grafts onto a heavy one through a shared midpoint
// m, a canonical 1-edit variant of both. A variant's key is its Zobrist
// hash (hi << 32) | lo, h(x) = XOR_p Z[p, x_p], with the table of
// make_zobrist_pair ([max_len + 2][4] pairs of uint32), so the keys are
// JAX's. A row x of length L > 0 has 6L + 4 + R valid variants (R its run
// starts), emitted in this slot order: the 4 insertions before position 0
// (Z[0, b] ^ S_ins), then for each position p the 3 substitutions and the 3
// insertions after p by the bases o_k = k + (x_p <= k), k = 0..2, then the
// deletions at run starts in position order (a deletion inside a run equals
// the one at its start). JAX strides its slots by a padded width; a slot
// here is the key's index within its row, decoded by the verify from the
// row alone. The payload moved through the partition is the key's index
// within its side (or strip): 32 bits, where a row and a slot would need
// 17 + 16 on 5 kb reads, so the partition keeps its 4-byte payload and the
// verify finds the row by a binary search of the count pass' ends.
//
// Keygen count. One thread a row of a side: 6L + 4 plus the run starts
// (a popcount of the 2-bit fields that differ from the field before,
// 16 a word). Bytes: the row's words, its start and length.
//
// Keygen emit. One warp a row (a persistent grid: each warp takes rows
// r, r + warps, ...), lane = position in a chunk of 32. The first walk
// XORs each lane's terms and one butterfly gives the row's three totals:
// the hash, S_del = XOR_{q>=1} Z[q-1, x_q] and S_ins = XOR_q Z[q+1, x_q].
// The second walk takes XOR scans of the chunk's terms (five shuffles of
// 64 bits each): a substitution at p is h ^ Z[p, x_p] ^ Z[p, o]; a
// deletion the prefix before p ^ the S_del terms after p; an insertion
// after p the prefix through p ^ the S_ins terms after p ^ Z[p+1, o].
// What bounds it: bytes, 12 a key written (key and payload), against ~15
// integer operations a key. The stores are what the design is about: a
// chunk's 6 x 32 keys are staged in the warp's shared memory in slot
// order and leave as 16-byte stores of consecutive addresses (a scalar
// head where the chunk's span starts on an odd key, a scalar tail), where
// each lane writing its own six keys at a 48-byte stride put one store
// instruction over 48 sectors for 256 useful bytes; the deletions, placed
// by a ballot of the run starts, are staged by rank and leave as one
// contiguous store; the payloads, which are only the keys' own indices,
// are written once a row as an iota of 16-byte stores (scalar head and
// tail to the row's 4-key alignment), not six 4-byte stores a lane at a
// 24-byte stride. The Zobrist table is read by __ldg where it lies: held
// in shared memory (base-major, up to 1,536 rows) it was no faster on the
// H100, as the stores bound the pass.
//
// Join. Pure: neither side is written. The items are chunks of kJoinChunk
// consecutive elements of the bigger side as partitioned, so a big bucket
// spreads over many chunks and small buckets come several to a chunk; the
// buckets a chunk touches are found by one torch.searchsorted of the big
// side's bucket ends (no readback). Keys of different buckets differ, so
// one hash table serves every bucket of a chunk: the small side's
// elements of those buckets (a contiguous span) go into a table in shared
// memory by open addressing (linear probing from a mix of the key other
// than the bucket's). An entry is a valid bit, a 21-bit fingerprint of
// the key and the smallest element of its key (atomicCAS to claim,
// atomicMin to lower), beside a count of its elements after the first,
// so that a key that comes once, as most do, costs one atomic, and a
// probe that misses reads one word a slot; a fingerprint that matches is
// confirmed on the full 64-bit key. Each big key then probes the table
// once. The count pass' blocks are persistent (as many as are resident),
// block b taking chunks b, b + grid, ...: the spans of a batch of
// kMetaBatch chunks are read at once, and the next chunk's big keys and
// small span come to shared memory by 1-D bulk copies of the TMA
// (cp.async.bulk into an mbarrier, two stages) while this one is probed,
// the threads issuing no copy of their own; a chunk whose buckets hold no
// small key is not read. A chunk that no key repeats in and that pairs
// nothing costs three block barriers. A span beyond
// kJoinTile elements is taken in tiles, each probed in turn; a key's
// count sums over them and its head is its first element in the first
// tile that holds it. The count pass leaves one record a big element that
// pairs, at the chunk's own span of an [m_big] int64 array, compacted in
// place order (a ballot and one exchange of warp counts): the key's first
// small element, its count, its place. The block whose chunk holds a
// bucket's first big element also links that bucket's small elements of a
// repeated key, each to the next of its key in partition order (an
// [m_small] int32 array; most keys come once and are never linked): the
// elements to link are listed in order, and warp 0 walks the list from its
// end in chunks of 32, __match_any_sync on the slot finding each
// element's next among the chunk's lanes, else the key's last one seen. In
// a span of several tiles every element of the block's own buckets is
// linked, and a key's last element in a tile links to the smallest later
// element of its key (an atomicMin over the later tiles' elements probed
// against this tile's table). torch.cumsum of the chunks' counts and one
// readback size the emit pass (one warp a chunk), which reads only the
// records: a record's pairs are its small chain from the head (spay <<
// 32) | bpay, in place order (a warp scan of the counts places them; more
// pairs than counted trap), so the pairs come bucket by bucket, the big
// elements in partition order, each with its small partners in partition
// order: join_reference's order. The big side's keys are read once, by
// the count pass. No window, cap or retry: a run of equal keys of any
// length is walked whole. 64-bit equality has no use for the tensor
// cores. What bounds it: bytes, 8 a key of both sides read, 4 a payload
// of a key that pairs, 8 a pair written; on an H100 the count pass runs
// at ~30% of that, held by each chunk's table work and barriers, not by
// its reads (scripts/graft_ab.py times it without small keys).
//
// Verify. A group of kVerifyLanes (16) lanes a pair, two pairs a warp.
// A pair is a chain of round trips to memory, each needing the one
// before, so the design is about having few of them, and few
// instructions a pair: the card's time follows the instructions it
// issues once the pairs fill it. Rows: each payload's row is found in
// its side's ends by a k-ary search, each lane reading one pivot a
// round, both sides' pivots loaded together: the first round's pivots
// lie every 8 rows around the row the payload would be in if all rows
// had as many keys (64 rows either way), which on reads of similar
// lengths leaves fewer than 16 rows in one round, where a binary search
// of 150,000 rows takes 18 dependent loads; later rounds split what is
// left evenly (n rows become n / 17). The last round reads the
// remaining rows' ends, the end before each and their ids at once, and
// a ballot picks the row. Slots decode as in the slot order above; a
// deletion's position, the rank-th run start, comes from popcounts of
// the words' run-start masks, a word a lane, scanned across the group.
// Compare: lane j builds word j of each variant (16 bases) from the
// source's words j - 1, j and j + 1, reading the code a base is chosen
// against with them: a substitution replaces one 2-bit field, a
// deletion takes the fields from its position on from the pair (j, j +
// 1) shifted down one field (__funnelshift_r), an insertion the fields
// after its base from the pair (j - 1, j) shifted up one
// (__funnelshift_l); fields past the variant's length are zero, as the
// rows' are. Lengths first, then one __all_sync a pass of 16 words (256
// bases: one pass for a read of ~150 nt, 20 for 5 kb). A verified pair
// sets ok[pair] and lowers best[light] by atomicMin to the heavy
// amplicon (the smallest heavy amplicon a light one meets, JAX's
// lexsort and first-of-run). What bounds it: bytes (the pair, its
// flag, each row's words, id, length and key ends), ~1.5 us at the
// fastidious cells' 5 MB, below an empty launch (~2 us); the realistic
// floor is the launch and one chain: the pair, the first round, the
// last, the row's start and length, its words. On an H100 a cell of
// 5,435 pairs (one wave) takes ~4x the launch; one of 63,009 takes ~5x
// that, the same with 6 or 8 blocks an SM: held by the instructions a
// pair issues, not by the chains in flight (PERF.md).
//
// Ragged rows are those of csrc/ragged_rows.cuh (row_word, 2-bit codes, zero
// past the length); every kernel traps on a row that does not fit the
// layout, an id outside [0, n), a row too long for the Zobrist table or a
// payload outside its side.

#include <cuda_runtime.h>

#include <cstdint>

#include "ragged_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kStageKeys = 6 * 32 + 32;  // a chunk's keys, then its deletions

// join: a block a chunk of the big side, tables of up to kJoinTile small
// elements
constexpr int kJoinThreads = 256;
constexpr int kJoinWarps = kJoinThreads / 32;
constexpr int kPlaceBits = 10;
constexpr int kJoinChunk = 1 << kPlaceBits;                // big elements
constexpr int kJoinPer = kJoinChunk / kJoinThreads;        // a thread's
constexpr int kJoinTile = 1024;                            // small elements
constexpr int kJoinLists = kJoinTile / kJoinThreads;       // 32-chunks a warp
constexpr int kElemBits = 10;                              // of a table entry
constexpr uint32_t kElemMask = (1u << kElemBits) - 1u;
constexpr int kTagBits = 31 - kElemBits;                   // the fingerprint
constexpr int kJoinSlotBits = kElemBits + 1;
constexpr int kJoinSlots = 1 << kJoinSlotBits;             // 1/2 full at most
constexpr int kMetaBatch = 128;  // a count block's chunks a batch
constexpr int kJoinBlocks = 4;   // count blocks an SM (64 registers)
static_assert(kJoinTile == 1 << kElemBits, "an entry holds an element");
// a record: the head (first small element) << 32 | count << kPlaceBits |
// place; a count from kCountMax on is found along the links
constexpr uint32_t kCountMax = (1u << (32 - kPlaceBits)) - 1u;
constexpr size_t kJoinSmem =
    2 * ((size_t)kJoinChunk * 8 + (size_t)(kJoinTile + 2) * 8 + 8) +
    (size_t)3 * kMetaBatch * 8 + (size_t)kJoinSlots * 8 +
    (size_t)kJoinTile * 4 + (size_t)kJoinPer * kJoinWarps * 4 +
    (size_t)kJoinWarps * 8;

// the words of row `amp` (of n) and its length, after the layout's checks
__device__ __forceinline__ const uint32_t *row_of(
    const uint32_t *words, int64_t n_words, const int64_t *row_word,
    const int32_t *lengths, int64_t n, int64_t amp, int *len) {
  if (amp < 0 || amp >= n) __trap();
  *len = lengths[amp];
  return words + row_start(row_word, amp, n, *len, n_words);
}

__device__ __forceinline__ uint32_t code_at(const uint32_t *src, int p) {
  return (__ldg(src + (p >> 4)) >> (2 * (p & 15))) & 3u;
}

// run starts among the fields of word w of a row of len bases (position 0
// always starts one); `prev` is the code before the word, updated
__device__ __forceinline__ uint32_t run_starts(uint32_t x, int w, int len,
                                               uint32_t *prev) {
  const uint32_t before = (x << 2) | *prev;
  uint32_t starts = nonzero_fields(x ^ before) & field_mask(len - 16 * w);
  if (w == 0) starts |= 1u;
  *prev = x >> 30;
  return starts;
}

// Z[p, b] as the key (hi << 32) | lo
__device__ __forceinline__ uint64_t zkey(const uint2 *zob, int p,
                                         uint32_t b) {
  const uint2 z = __ldg(zob + 4 * p + b);
  return ((uint64_t)z.x << 32) | z.y;
}

__device__ __forceinline__ uint64_t warp_xor(uint64_t v) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) v ^= __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ uint64_t warp_xor_scan(uint64_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v ^= u;
  }
  return v;
}

// counts[r] = the valid variants of row ids[r]
__global__ void __launch_bounds__(kThreads)
    graft_count_kernel(const uint32_t *__restrict__ words, int64_t n_words,
                       const int64_t *__restrict__ row_word,
                       const int32_t *__restrict__ lengths, int64_t n,
                       const int64_t *__restrict__ ids, int64_t m,
                       int32_t *__restrict__ counts) {
  const int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (r >= m) return;
  int len;
  const uint32_t *src =
      row_of(words, n_words, row_word, lengths, n, ids[r], &len);
  int runs = 0;
  uint32_t prev = 0u;
  for (int w = 0; 16 * w < len; ++w)
    runs += __popc(run_starts(__ldg(src + w), w, len, &prev));
  counts[r] = len > 0 ? 6 * len + 4 + runs : 0;
}

// keys [d, d + cnt) from the warp's stage st: 16-byte stores of
// consecutive addresses, a scalar head where d is odd and a scalar tail
__device__ __forceinline__ void store_keys(int64_t *__restrict__ keys,
                                           int64_t d, const uint64_t *st,
                                           int cnt, int lane) {
  const int head = (int)(d & 1) < cnt ? (int)(d & 1) : cnt;
  if (lane < head) keys[d] = (int64_t)st[0];
  const int two = (cnt - head) >> 1;
  longlong2 *out = (longlong2 *)(keys + d + head);
  for (int i = lane; i < two; i += 32)
    out[i] = make_longlong2((long long)st[head + 2 * i],
                            (long long)st[head + 2 * i + 1]);
  if (lane == 0 && head + 2 * two < cnt)
    keys[d + cnt - 1] = (int64_t)st[cnt - 1];
}

// pays[i] = i for i in [a, e): 16-byte stores, scalar head and tail
__device__ __forceinline__ void store_iota(int32_t *__restrict__ pays,
                                           int64_t a, int64_t e, int lane) {
  const int64_t head = min((int64_t)((4 - (a & 3)) & 3), e - a);
  if (lane < head) pays[a + lane] = (int32_t)(a + lane);
  a += head;
  const int64_t quads = (e - a) >> 2;
  int4 *out = (int4 *)(pays + a);
  for (int64_t i = lane; i < quads; i += 32) {
    const int32_t v = (int32_t)(a + 4 * i);
    out[i] = make_int4(v, v + 1, v + 2, v + 3);
  }
  const int64_t t = a + 4 * quads + lane;
  if (t < e) pays[t] = (int32_t)t;
}

// The keys of row ids[r] and their payloads (their own index) from
// ends[r - 1] (ends = inclusive cumsum of the counts), by one warp;
// st: the warp's stage of kStageKeys keys
__device__ __forceinline__ void emit_row(
    const uint32_t *__restrict__ words, int64_t n_words,
    const int64_t *__restrict__ row_word, const int32_t *__restrict__ lengths,
    int64_t n, const int64_t *__restrict__ ids, int64_t r,
    const uint2 *__restrict__ zob, int64_t z_rows,
    const int64_t *__restrict__ ends,
    int64_t *__restrict__ keys, int32_t *__restrict__ pays, uint64_t *st,
    int lane) {
  int len;
  const uint32_t *src =
      row_of(words, n_words, row_word, lengths, n, ids[r], &len);
  if ((int64_t)len + 2 > z_rows) __trap();  // Z rows 0..len are read
  if (len == 0) return;
  const int64_t out = r ? ends[r - 1] : 0;
  store_iota(pays, out, ends[r], lane);

  // walk 1: the row's hash and the two suffix totals
  uint64_t seq = 0, s_del = 0, s_ins = 0;
  for (int p = lane; p < len; p += 32) {
    const uint32_t c = code_at(src, p);
    seq ^= zkey(zob, p, c);
    if (p >= 1) s_del ^= zkey(zob, p - 1, c);
    s_ins ^= zkey(zob, p + 1, c);
  }
  seq = warp_xor(seq);
  s_del = warp_xor(s_del);
  s_ins = warp_xor(s_ins);
  if (lane < 4)  // insertions before position 0
    keys[out + lane] = (int64_t)(zkey(zob, 0, lane) ^ s_ins);

  // walk 2: XOR scans of the chunk's terms, the keys staged in slot order;
  // the deletions by a ballot, staged by rank
  uint64_t pre0 = 0, pre_del = 0, pre_ins = 0;  // over the earlier chunks
  uint32_t before_chunk = 4u;  // no code: position 0 starts a run
  int64_t del_at = out + 4 + 6 * (int64_t)len;
  uint64_t *dels = st + 6 * 32;
  for (int base = 0; base < len; base += 32) {
    const int p = base + lane;
    const bool in = p < len;
    const uint32_t c = in ? code_at(src, p) : 4u;
    const uint64_t g0 = in ? zkey(zob, p, c) : 0;
    const uint64_t gd = in && p >= 1 ? zkey(zob, p - 1, c) : 0;
    const uint64_t gi = in ? zkey(zob, p + 1, c) : 0;
    const uint64_t inc0 = warp_xor_scan(g0, lane);
    const uint64_t incd = warp_xor_scan(gd, lane);
    const uint64_t inci = warp_xor_scan(gi, lane);
    uint32_t before = __shfl_up_sync(kFull, c, 1);
    if (lane == 0) before = before_chunk;
    const bool start = in && c != before;
    const unsigned starts = __ballot_sync(kFull, start);
    const uint64_t prefix = pre0 ^ inc0 ^ g0;         // XOR of g0 before p
    const uint64_t del_after = s_del ^ pre_del ^ incd;  // terms after p
    const uint64_t ins_after = s_ins ^ pre_ins ^ inci;
    __syncwarp();  // the previous chunk's stage is written out
    if (in) {
      const uint64_t sub = seq ^ g0;
      const uint64_t ins = prefix ^ g0 ^ ins_after;
#pragma unroll
      for (uint32_t k = 0; k < 3; ++k) {
        const uint32_t o = k + (c <= k);
        st[6 * lane + k] = sub ^ zkey(zob, p, o);
        st[6 * lane + 3 + k] = ins ^ zkey(zob, p + 1, o);
      }
    }
    if (start) dels[__popc(starts & ((1u << lane) - 1u))] = prefix ^ del_after;
    __syncwarp();
    store_keys(keys, out + 4 + 6 * (int64_t)base, st,
               6 * min(32, len - base), lane);
    const int n_del = __popc(starts);
    if (lane < n_del) keys[del_at + lane] = (int64_t)dels[lane];
    del_at += n_del;
    pre0 ^= __shfl_sync(kFull, inc0, 31);
    pre_del ^= __shfl_sync(kFull, incd, 31);
    pre_ins ^= __shfl_sync(kFull, inci, 31);
    before_chunk = __shfl_sync(kFull, c, 31);
  }
}

// One warp a row, rows r, r + the grid's warps, ...
__global__ void __launch_bounds__(kThreads)
    graft_emit_kernel(const uint32_t *__restrict__ words, int64_t n_words,
                      const int64_t *__restrict__ row_word,
                      const int32_t *__restrict__ lengths, int64_t n,
                      const int64_t *__restrict__ ids, int64_t m,
                      const uint2 *__restrict__ zob, int64_t z_rows,
                      const int64_t *__restrict__ ends,
                      int64_t *__restrict__ keys,
                      int32_t *__restrict__ pays) {
  __shared__ __align__(16) uint64_t stage[kWarps][kStageKeys];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + warp; r < m; r += warps)
    emit_row(words, n_words, row_word, lengths, n, ids, r, zob, z_rows, ends,
             keys, pays, stage[warp], lane);
}

// ---- join: persistent blocks over chunks of the big side ----

struct JoinSmem {
  int64_t *bk;      // [2][kJoinChunk] a chunk's keys, two stages
  int64_t *sk;      // [2][kJoinTile + 2] its small span's keys, if they fit
  uint64_t *bar;    // [2] each stage's mbarrier
  int64_t *span;    // [3][kMetaBatch] a batch's chunks: small span, own
  uint32_t *table;  // [kJoinSlots] a slot's entry (tag | smallest
                    // element), or 0: empty
  int32_t *cnt;     // [kJoinSlots] a slot's elements after the first; in
                    // the links, the next element (global) of its key
                    // after those seen
  int32_t *list;    // [kJoinTile] the elements to link, in order
  int32_t *wc;      // [kJoinPer][kJoinWarps], then [kJoinWarps]: counts
  int64_t *sum;     // [kJoinWarps]
};

__device__ __forceinline__ JoinSmem join_smem(unsigned char *base) {
  JoinSmem sm;
  sm.bk = (int64_t *)base;
  sm.sk = sm.bk + 2 * kJoinChunk;
  sm.bar = (uint64_t *)(sm.sk + 2 * (kJoinTile + 2));
  sm.span = (int64_t *)(sm.bar + 2);
  sm.table = (uint32_t *)(sm.span + 3 * kMetaBatch);
  sm.cnt = (int32_t *)(sm.table + kJoinSlots);
  sm.list = sm.cnt + kJoinSlots;
  sm.wc = sm.list + kJoinTile;
  sm.sum = (int64_t *)(sm.wc + kJoinPer * kJoinWarps);
  return sm;
}

// A key's home slot in a table of 2^bits slots and its tag: the top bits
// of one multiply by 2^64 / phi (another mix than the bucket's: within a
// bucket the bucket's bits are all equal), the next kTagBits bits a
// fingerprint, so that a probe that misses reads one entry a slot, and
// one that hits also the key
__device__ __forceinline__ uint32_t tag_of(int64_t key, int bits,
                                           uint32_t *slot) {
  const uint64_t p = (uint64_t)key * 0x9E3779B97F4A7C15ull;
  *slot = (uint32_t)(p >> (64 - bits));
  return 0x80000000u |
         (((uint32_t)(p >> (64 - bits - kTagBits)) & ((1u << kTagBits) - 1u))
          << kElemBits);
}

// the slot of `key` in the table of the small keys sk, or -1
__device__ __forceinline__ int find_slot(const JoinSmem &sm,
                                         const int64_t *sk, int64_t key,
                                         int bits) {
  uint32_t h;
  const uint32_t tag = tag_of(key, bits, &h);
  const uint32_t mask = (1u << bits) - 1u;
  for (;; h = (h + 1) & mask) {
    const uint32_t cur = sm.table[h];
    if (cur == 0u) return -1;
    if ((cur >> kElemBits) == (tag >> kElemBits) &&
        sk[cur & kElemMask] == key)
      return (int)h;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void *p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Hopper's bulk copies (the TMA, one thread issuing a whole span, its
// bytes counted into an mbarrier): the threads' load pipe stays free for
// the table, where per-thread cp.async ahead of the probes held their
// shared-memory loads back
__device__ __forceinline__ void bar_init(uint64_t *bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t *bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t *bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// [dst, dst + bytes) <- [src, ...): both 16-byte aligned, bytes a
// multiple of 16 (none for 0)
__device__ __forceinline__ void bulk_copy(void *dst, const void *src,
                                          unsigned bytes, uint64_t *bar) {
  if (bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 2^bits slots of the table and their counts emptied (the table is empty
// between chunks)
__device__ __forceinline__ void clear_table(const JoinSmem &sm, int bits) {
  for (int h = threadIdx.x; h < (1 << bits); h += kJoinThreads) {
    sm.table[h] = 0u;
    sm.cnt[h] = 0;
  }
}

// The n small keys of sk (in shared memory, visible) into the empty table
// of 2^bits slots, each slot keeping the smallest element of its key and
// counting its elements after the first (a key that comes once, as most
// do, costs one atomicCAS); returns (in every thread, after a barrier)
// whether some key repeats
__device__ __forceinline__ bool build_table(const JoinSmem &sm,
                                            const int64_t *sk, int n,
                                            int bits) {
  volatile uint32_t *table = sm.table;
  bool repeats = false;
  for (int i = threadIdx.x; i < n; i += kJoinThreads) {
    const int64_t key = sk[i];
    uint32_t h;
    const uint32_t tag = tag_of(key, bits, &h) | (uint32_t)i;
    for (;;) {
      uint32_t cur = table[h];
      if (cur == 0u) {
        cur = atomicCAS(sm.table + h, 0u, tag);
        if (cur == 0u) break;
      }
      if ((cur >> kElemBits) == (tag >> kElemBits) &&
          sk[cur & kElemMask] == key) {  // a slot only ever holds one key
        atomicMin(sm.table + h, tag);
        atomicAdd(sm.cnt + h, 1);
        repeats = true;
        break;
      }
      h = (h + 1) & ((1u << bits) - 1u);
    }
  }
  return __syncthreads_or(repeats);
}

// Links of the tile's elements [own, n) (keys sk, global index tile_lo +
// i): each to the next element of its key, in partition order; without
// `every` only those of a repeated key, with it every one, a key's last
// in the tile to its smallest element in [later, s_hi) (the next tiles).
// All threads call it, after the tile's probes; the counts are spent.
__device__ __forceinline__ void link_tile(
    const JoinSmem &sm, const int64_t *sk, const int64_t *__restrict__ skeys,
    int64_t tile_lo, int n, int own, int bits, bool every, int64_t later,
    int64_t s_hi, int32_t *__restrict__ links) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int slots = 1 << bits;
  // the elements to link, listed in order (warp w: a span of 32-chunks)
  const int chunks = (n + kJoinThreads - 1) / kJoinThreads;
  const int span = 32 * chunks;
  unsigned flags[kJoinLists];
  int mine = 0;
#pragma unroll
  for (int c = 0; c < kJoinLists; ++c) {
    const int t = warp * span + 32 * c + lane;
    flags[c] = __ballot_sync(
        kFull, c < chunks && t < n && t >= own &&
                   (every || sm.cnt[find_slot(sm, sk, sk[t], bits)] > 0));
    mine += __popc(flags[c]);
  }
  if (lane == 0) sm.wc[warp] = mine;
  __syncthreads();  // and every probe has read the counts
  int at = 0, listed = 0;
  for (int w = 0; w < kJoinWarps; ++w) {
    const int v = sm.wc[w];
    if (w < warp) at += v;
    listed += v;
  }
#pragma unroll
  for (int c = 0; c < kJoinLists; ++c) {
    if ((flags[c] >> lane) & 1u)
      sm.list[at + __popc(flags[c] & below)] = warp * span + 32 * c + lane;
    at += __popc(flags[c]);
  }
  // a key's next element after this tile: none, or with `every` the
  // smallest later one of its key
  for (int h = threadIdx.x; h < slots; h += kJoinThreads)
    sm.cnt[h] = every ? INT32_MAX : -1;
  __syncthreads();
  if (every) {
    for (int64_t j = later + threadIdx.x; j < s_hi; j += kJoinThreads) {
      const int h = find_slot(sm, sk, skeys[j], bits);
      if (h >= 0) atomicMin(sm.cnt + h, (int32_t)j);
    }
    __syncthreads();
    for (int h = threadIdx.x; h < slots; h += kJoinThreads)
      if (sm.cnt[h] == INT32_MAX) sm.cnt[h] = -1;
    __syncthreads();
  }
  if (warp != 0 || listed == 0) return;
  // warp 0, from the list's end: each element's next is the nearest
  // later lane of its slot, else the key's last one seen
  for (int base = (listed - 1) & ~31; base >= 0; base -= 32) {
    const int q = base + lane;
    const int t = q < listed ? sm.list[q] : -1;
    const int g = t >= 0 ? find_slot(sm, sk, sk[t], bits) : -1 - lane;
    const unsigned peers = __match_any_sync(kFull, g);
    const unsigned above = peers & ~((2u << lane) - 1u);
    if (t >= 0)
      links[tile_lo + t] =
          above ? (int32_t)(tile_lo + sm.list[base + __ffs(above) - 1])
                : sm.cnt[g];
    __syncwarp();
    if (t >= 0 && (peers & below) == 0) sm.cnt[g] = (int32_t)(tile_lo + t);
    __syncwarp();
  }
}

// where the small span [s_lo, ...) lies in a stage: at its parity, so
// that the bulk copy's source and destination are both 16-byte aligned
__device__ __forceinline__ int64_t *small_at(const JoinSmem &sm, int st,
                                             int64_t s_lo) {
  return sm.sk + st * (kJoinTile + 2) + (s_lo & 1);
}

// The copies of chunk k into stage `st` (thread 0): its big keys, and its
// small span [s_lo, s_hi) when it fits one table, by bulk copies into the
// stage's mbarrier, an odd head or tail element by the thread itself
// (visible after the next block barrier); nothing for a chunk whose
// buckets hold no small key, which nothing probes
__device__ __forceinline__ void fetch_chunk(
    const JoinSmem &sm, int st, const int64_t *__restrict__ skeys,
    const int64_t *__restrict__ bkeys, int64_t m_big, int64_t k,
    int64_t s_lo, int64_t s_hi) {
  const int64_t e0 = k * kJoinChunk;
  const int nb = s_hi > s_lo ? (int)min((int64_t)kJoinChunk, m_big - e0) : 0;
  int64_t *bk = sm.bk + st * kJoinChunk;
  const int b_even = nb & ~1;
  int s_head = 0, s_even = 0;
  int64_t *sk = small_at(sm, st, s_lo);
  const int ns = s_hi - s_lo <= kJoinTile ? (int)(s_hi - s_lo) : 0;
  if (ns) {
    s_head = (int)(s_lo & 1);
    s_even = (ns - s_head) & ~1;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  bar_expect(sm.bar + st, 8u * (b_even + s_even));
  bulk_copy(bk, bkeys + e0, 8u * b_even, sm.bar + st);
  bulk_copy(sk + s_head, skeys + s_lo + s_head, 8u * s_even, sm.bar + st);
  if (nb & 1) bk[nb - 1] = bkeys[e0 + nb - 1];
  if (s_head) sk[0] = skeys[s_lo];
  if (s_head + s_even < ns) sk[ns - 1] = skeys[s_lo + ns - 1];
}

// Chunk k (its keys landed in stage st, the table empty) against the
// small side's elements [s_lo, s_hi) of the buckets it touches, own from
// own_lo on: counts[k], its records and n_rec[k], and the links of its
// own buckets; leaves the table empty
__device__ __forceinline__ void count_chunk(
    const JoinSmem &sm, int st, const int64_t *__restrict__ skeys,
    int64_t m_big, int64_t k, int64_t s_lo, int64_t s_hi, int64_t own_lo,
    int64_t *__restrict__ counts, int64_t *__restrict__ rec,
    int32_t *__restrict__ n_rec, int32_t *__restrict__ links) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t e0 = k * kJoinChunk;
  const int nb = (int)min((int64_t)kJoinChunk, m_big - e0);
  const int64_t *bk = sm.bk + st * kJoinChunk;
  const bool tiled = s_hi - s_lo > kJoinTile;
  // a tiled span: tile after tile at the stage's start
  int64_t *sk = tiled ? sm.sk + st * (kJoinTile + 2) : small_at(sm, st, s_lo);
  int cnt[kJoinPer];
  int32_t head[kJoinPer];
#pragma unroll
  for (int j = 0; j < kJoinPer; ++j) {
    cnt[j] = 0;
    head[j] = -1;
  }
  int bits = 0;
  for (int64_t tile_lo = s_lo; tile_lo < s_hi; tile_lo += kJoinTile) {
    const int n = (int)min((int64_t)kJoinTile, s_hi - tile_lo);
    if (tiled) {  // a span beyond one table: tile after tile
      __syncthreads();  // the previous tile is done with
      if (bits) clear_table(sm, bits);
      for (int i = threadIdx.x; i < n; i += kJoinThreads)
        sk[i] = skeys[tile_lo + i];
      __syncthreads();
    }
    bits = 6;
    while ((1 << bits) < 2 * n) ++bits;
    const bool repeats = build_table(sm, sk, n, bits);
#pragma unroll
    for (int j = 0; j < kJoinPer; ++j) {
      const int p = j * kJoinThreads + threadIdx.x;
      if (p < nb) {
        const int h = find_slot(sm, sk, bk[p], bits);
        if (h >= 0) {
          cnt[j] += sm.cnt[h] + 1;
          if (head[j] < 0)
            head[j] = (int32_t)(tile_lo + (sm.table[h] & kElemMask));
        }
      }
    }
    if ((repeats || tiled) && tile_lo + n > own_lo)
      link_tile(sm, sk, skeys, tile_lo, n,
                (int)max(own_lo - tile_lo, (int64_t)0), bits, tiled,
                max(tile_lo + n, own_lo), s_hi, links);
  }
  bool any = false;
#pragma unroll
  for (int j = 0; j < kJoinPer; ++j) any |= cnt[j] > 0;
  any = __syncthreads_or(any);  // and the table is done with
  if (bits) clear_table(sm, bits);  // for the next chunk
  if (!any) {
    if (threadIdx.x == 0) {
      n_rec[k] = 0;
      counts[k] = 0;
    }
    return;
  }

  // the records, compacted in place order: j, then warp, then lane
  unsigned found[kJoinPer];
  int64_t total = 0;
#pragma unroll
  for (int j = 0; j < kJoinPer; ++j) {
    found[j] = __ballot_sync(kFull, cnt[j] > 0);
    if (lane == 0) sm.wc[j * kJoinWarps + warp] = __popc(found[j]);
    total += cnt[j];
  }
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) total += __shfl_xor_sync(kFull, total, d);
  if (lane == 0) sm.sum[warp] = total;
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  int earlier = 0;  // the records of the rounds before j
#pragma unroll
  for (int j = 0; j < kJoinPer; ++j) {
    int at = earlier;
    for (int i = 0; i < warp; ++i) at += sm.wc[j * kJoinWarps + i];
    if (cnt[j] > 0)
      rec[e0 + at + __popc(found[j] & below)] =
          ((int64_t)head[j] << 32) |
          (int64_t)((min((uint32_t)cnt[j], kCountMax) << kPlaceBits) |
                    (uint32_t)(j * kJoinThreads + threadIdx.x));
    for (int i = 0; i < kJoinWarps; ++i) earlier += sm.wc[j * kJoinWarps + i];
  }
  if (threadIdx.x == 0) {
    int64_t pairs = 0;
    for (int w = 0; w < kJoinWarps; ++w) pairs += sm.sum[w];
    n_rec[k] = earlier;
    counts[k] = pairs;
  }
}

// The count pass: persistent blocks, block b taking chunks b, b + grid,
// ... of the big side in batches of kMetaBatch, each batch's small spans
// read once (first[k], last[k]: the buckets of chunk k's first and last
// big element), each chunk's keys fetched by cp.async while the previous
// one is probed.
__global__ void __launch_bounds__(kJoinThreads, kJoinBlocks)
    graft_join_count_kernel(const int64_t *__restrict__ skeys,
                            const int64_t *__restrict__ s_ends,
                            const int64_t *__restrict__ bkeys, int64_t m_big,
                            const int64_t *__restrict__ b_ends,
                            const int64_t *__restrict__ first,
                            const int64_t *__restrict__ last,
                            int64_t *__restrict__ counts,
                            int64_t *__restrict__ rec,
                            int32_t *__restrict__ n_rec,
                            int32_t *__restrict__ links) {
  extern __shared__ __align__(16) unsigned char smem[];
  const JoinSmem sm = join_smem(smem);
  const int64_t n_chunks = (m_big + kJoinChunk - 1) / kJoinChunk;
  const int64_t grid = gridDim.x;
  clear_table(sm, kJoinSlotBits);
  if (threadIdx.x == 0) {
    bar_init(sm.bar);
    bar_init(sm.bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  unsigned phases = 0u;  // each stage's mbarrier phase to wait for
  for (int64_t batch = blockIdx.x; batch < n_chunks;
       batch += grid * kMetaBatch) {
    // the batch's chunks: batch + j * grid; their spans
    const int mine =
        (int)min((int64_t)kMetaBatch, (n_chunks - batch + grid - 1) / grid);
    __syncthreads();  // the previous batch is done with
    for (int j = threadIdx.x; j < mine; j += kJoinThreads) {
      const int64_t k = batch + j * grid;
      const int64_t bf = first[k], bl = last[k];
      const int64_t s_lo = bf ? s_ends[bf - 1] : 0;
      sm.span[j] = s_lo;
      sm.span[kMetaBatch + j] = s_ends[bl];
      // the small elements of the buckets whose big side starts here
      sm.span[2 * kMetaBatch + j] =
          (bf ? b_ends[bf - 1] : 0) >= k * kJoinChunk ? s_lo : s_ends[bf];
    }
    __syncthreads();
    if (threadIdx.x == 0)
      fetch_chunk(sm, 0, skeys, bkeys, m_big, batch, sm.span[0],
                  sm.span[kMetaBatch]);
    for (int j = 0; j < mine; ++j) {
      bar_wait(sm.bar + (j & 1), (phases >> (j & 1)) & 1u);
      phases ^= 1u << (j & 1);
      __syncthreads();  // chunk j's keys have landed; chunk j - 1 is done
      if (j + 1 < mine && threadIdx.x == 0)  // the stage chunk j - 1 held
        fetch_chunk(sm, (j + 1) & 1, skeys, bkeys, m_big,
                    batch + (j + 1) * grid, sm.span[j + 1],
                    sm.span[kMetaBatch + j + 1]);
      count_chunk(sm, j & 1, skeys, m_big, batch + j * grid, sm.span[j],
                  sm.span[kMetaBatch + j], sm.span[2 * kMetaBatch + j],
                  counts, rec, n_rec, links);
    }
  }
}

// The emit pass: one warp a chunk, its records in rounds of 32, each
// record's pairs (its small chain from the head, along the links) from
// ends[k - 1] up to ends[k] (a warp scan of the counts places them; more
// pairs than the count pass gave trap). Reads only the records, the links
// and the payloads.
__global__ void __launch_bounds__(kJoinThreads)
    graft_join_emit_kernel(const int32_t *__restrict__ spays,
                           const int32_t *__restrict__ bpays, int64_t m_big,
                           const int64_t *__restrict__ rec,
                           const int32_t *__restrict__ n_rec,
                           const int32_t *__restrict__ links,
                           const int64_t *__restrict__ ends,
                           int64_t *__restrict__ pairs) {
  const int lane = threadIdx.x & 31;
  const int64_t k = ((int64_t)blockIdx.x * kJoinThreads + threadIdx.x) >> 5;
  if (k * kJoinChunk >= m_big) return;  // the whole warp
  const int n = n_rec[k];
  const int64_t e0 = k * kJoinChunk, end = ends[k];
  int64_t out = k ? ends[k - 1] : 0;
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int r = r0 + lane;
    int64_t cnt = 0;
    int32_t j = 0;
    uint32_t place = 0;
    if (r < n) {
      const int64_t v = rec[e0 + r];
      j = (int32_t)(v >> 32);
      place = (uint32_t)v & (kJoinChunk - 1);
      cnt = (uint32_t)v >> kPlaceBits;
      if (cnt == kCountMax)  // a longer chain: its length, walked
        for (int32_t i = links[j], walked = 1;; i = links[i], ++walked)
          if (i < 0) {
            cnt = walked;
            break;
          }
    }
    int64_t incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    const int64_t round = __shfl_sync(kFull, incl, 31);
    if (out + round > end) __trap();
    if (r < n) {
      const uint32_t pay = (uint32_t)bpays[e0 + place];
      int64_t at = out + incl - cnt;
      for (int64_t i = 0; i < cnt; ++i) {
        pairs[at + i] = ((int64_t)(uint32_t)spays[j] << 32) | pay;
        if (i + 1 < cnt) j = links[j];
      }
    }
    out += round;
  }
}

// ---- verify ----

constexpr int kVerifyLanes = 16;  // a pair's group of lanes
enum : int { kSub = 0, kDel = 1, kIns = 2 };

// A group of G lanes of a warp that works on one pair
template <int G>
struct Group {
  unsigned mask;  // its lanes in the warp
  int first;      // its first lane in the warp
  int lane;       // this lane's place in the group

  __device__ __forceinline__ Group() {
    const int w = threadIdx.x & 31;
    first = w & ~(G - 1);
    lane = w & (G - 1);
    mask = G == 32 ? kFull : ((1u << G) - 1u) << first;
  }
  // the group's lanes whose pred holds, bit i for its lane i
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    return (__ballot_sync(mask, pred) & mask) >> first;
  }
  template <class T>
  __device__ __forceinline__ T from(T v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
};

// The search for the row of a side (ends: inclusive cumsum of its rows'
// key counts) whose keys hold a payload: the first row whose end is past
// it, somewhere in [lo, hi] (hi == rows: past the side)
struct Find {
  const int64_t *ends;
  const int64_t *ids;
  int64_t rows, total, pay, lo, hi;  // total: the side's keys
};

// Lane s's pivot in [lo, hi) of the first round: around the row the
// payload would lie in if every row had as many keys (pay * rows /
// total), every G / 2 rows (for 16 lanes, -64 to +56), clamped; of a
// later round, G points splitting [lo, hi) in G + 1
template <int G>
__device__ __forceinline__ int64_t pivot(const Find &f, int s, bool guided) {
  if (!guided) return f.lo + (int64_t)(s + 1) * (f.hi - f.lo) / (G + 1);
  const int64_t guess =
      f.total > 0 ? (int64_t)((double)f.pay * f.rows / f.total) : 0;
  return min(max(guess + (s - G / 2) * (G / 2), f.lo), f.hi - 1);
}

// Both sides' rows, by a k-ary search: while G rows or more remain,
// each lane reads one pivot of each side's ends a round (the pivots
// rise with the lane) and a ballot counts those at or below the
// payload, whose neighbours become the new bounds; the first round's
// pivots sit around the payload's interpolated row, so that on rows of
// similar lengths one round leaves fewer than G, and the later ones
// split what is left evenly (n rows become ~n / (G + 1)). Then lane s
// takes row lo + s, reading its end, the end before it and its id at
// once, and the one row whose keys hold the payload is picked. The
// sides' loads of a round are issued together. amp[k], start[k]: the
// row's id and the index of its first key.
template <int G>
__device__ __forceinline__ void find_rows(Find (&f)[2], const Group<G> &g,
                                          int64_t (&amp)[2],
                                          int64_t (&start)[2]) {
  for (bool guided = true;; guided = false) {
    bool more[2];
    int64_t q[2], e[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      more[k] = f[k].hi - f[k].lo >= G;
      q[k] = more[k] ? pivot<G>(f[k], g.lane, guided) : 0;
      e[k] = more[k] ? __ldg(f[k].ends + q[k]) : 0;
    }
    if (!more[0] && !more[1]) break;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int below = __popc(g.ballot(more[k] && e[k] <= f[k].pay));
      if (!more[k]) continue;
      if (below > 0) f[k].lo = g.from(q[k], below - 1) + 1;
      if (below < G) f[k].hi = g.from(q[k], below);
    }
  }
  int64_t first[2], end[2], id[2];
  bool in[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int64_t r = f[k].lo + g.lane;
    in[k] = r <= f[k].hi && r < f[k].rows;
    first[k] = in[k] && r > 0 ? __ldg(f[k].ends + r - 1) : 0;
    end[k] = in[k] ? __ldg(f[k].ends + r) : 0;
    id[k] = in[k] ? __ldg(f[k].ids + r) : 0;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const unsigned hit =
        g.ballot(in[k] && first[k] <= f[k].pay && f[k].pay < end[k]);
    if (hit == 0u) __trap();  // a payload outside its side
    amp[k] = g.from(id[k], __ffs(hit) - 1);
    start[k] = g.from(first[k], __ffs(hit) - 1);
  }
}

// The position of the rank-th run start of a row of len > 0 bases: G
// words a pass, a lane a word, the popcounts of their run-start masks
// scanned across the group; traps past the row's run starts
template <int G>
__device__ int run_start(const uint32_t *src, int len, int64_t rank,
                         const Group<G> &g) {
  const int words = (len + 15) >> 4;
  for (int w0 = 0; w0 < words; w0 += G) {
    const int w = w0 + g.lane;
    const uint32_t x = w < words ? __ldg(src + w) : 0u;
    uint32_t prev = w >= 1 && w <= words ? __ldg(src + w - 1) >> 30 : 0u;
    const uint32_t starts = run_starts(x, w, len, &prev);
    const int c = __popc(starts);
    int incl = c;
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int u = __shfl_up_sync(g.mask, incl, d, G);
      if (g.lane >= d) incl += u;
    }
    const int total = g.from(incl, G - 1);
    if (rank < total) {
      const bool mine = rank >= incl - c && rank < incl;
      int pos = 0;
      if (mine) {
        uint32_t s = starts;
        for (int64_t r = rank - (incl - c); r > 0; --r) s &= s - 1u;
        pos = 16 * w + (__ffs(s) - 1) / 2;
      }
      return g.from(pos, __ffs(g.ballot(mine)) - 1);
    }
    rank -= total;
  }
  __trap();  // a deletion slot past the row's run starts
  return -1;
}

struct Variant {
  const uint32_t *src;  // the source row's words
  int src_words;        // those that hold its bases
  int type;             // kSub, kDel, kIns
  int pos;              // the edit's place in the variant
  uint32_t base;        // the base, or with from >= 0 k of o_k
  int from;             // the position whose code o_k is taken against
  int len;              // the variant's length
};

// key `slot` of a row of len bases (the slot order of the header); a
// substitution's or an insertion's base o_k = k + (x_p <= k) is left to
// variant_word, so that x_p is read with the words, not a round trip
// before them
template <int G>
__device__ __forceinline__ Variant decode(const uint32_t *src, int len,
                                          int64_t slot, const Group<G> &g) {
  Variant v;
  v.src = src;
  v.src_words = (len + 15) >> 4;
  v.base = 0u;
  v.from = -1;
  if (slot < 4) {  // insertion before position 0
    v.type = kIns;
    v.pos = 0;
    v.base = (uint32_t)slot;
  } else if (slot < 4 + 6 * (int64_t)len) {
    const int p = (int)((slot - 4) / 6), j = (int)((slot - 4) % 6);
    v.type = j < 3 ? kSub : kIns;
    v.pos = j < 3 ? p : p + 1;
    v.base = j % 3;
    v.from = p;
  } else {
    v.type = kDel;
    v.pos = run_start(src, len, slot - 4 - 6 * (int64_t)len, g);
  }
  v.len = len + (v.type == kDel ? -1 : v.type == kIns ? 1 : 0);
  return v;
}

__device__ __forceinline__ uint32_t src_word(const Variant &v, int w) {
  return (unsigned)w < (unsigned)v.src_words ? __ldg(v.src + w) : 0u;
}

// Word w of a variant, from the source's words w - 1, w and w + 1: a
// substitution replaces one field; a deletion takes the fields from its
// position on from the words shifted down one field, an insertion those
// after its base from the words shifted up one. Fields past the
// variant's length come out zero, as the source's are.
__device__ __forceinline__ uint32_t variant_word(const Variant &v, int w) {
  const uint32_t cur = src_word(v, w);
  const uint32_t below = field_mask(v.pos - 16 * w);  // fields before it
  if (v.type == kDel)
    return (cur & below) |
           (__funnelshift_r(cur, src_word(v, w + 1), 2) & ~below);
  const uint32_t at = field_mask(v.pos + 1 - 16 * w) & ~below;
  const uint32_t b =
      v.from < 0 ? v.base : v.base + (code_at(v.src, v.from) <= v.base);
  const uint32_t base = (b * kOdd) & at;
  if (v.type == kSub) return (cur & ~at) | base;
  return (cur & below) | base |
         (__funnelshift_l(src_word(v, w - 1), cur, 2) & ~(below | at));
}

// A group of kVerifyLanes lanes a pair: both rows found, both slots
// decoded, then the variants compared G words a pass, lengths first
template <int G>
__global__ void __launch_bounds__(kThreads)
    graft_verify_kernel(const uint32_t *__restrict__ words, int64_t n_words,
                        const int64_t *__restrict__ row_word,
                        const int32_t *__restrict__ lengths, int64_t n,
                        const int64_t *__restrict__ s_ids,
                        const int64_t *__restrict__ s_ends, int64_t s_rows,
                        const int64_t *__restrict__ b_ids,
                        const int64_t *__restrict__ b_ends, int64_t b_rows,
                        const int64_t *__restrict__ pairs, int64_t n_pairs,
                        int small_is_heavy, bool *__restrict__ ok,
                        int32_t *__restrict__ best) {
  const Group<G> g;
  const int64_t t = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / G;
  if (t >= n_pairs) return;  // the whole group
  const int64_t pr = __ldg(pairs + t);
  Find f[2] = {
      {s_ends, s_ids, s_rows, s_rows > 0 ? __ldg(s_ends + s_rows - 1) : 0,
       (int64_t)((uint64_t)pr >> 32), 0, s_rows},
      {b_ends, b_ids, b_rows, b_rows > 0 ? __ldg(b_ends + b_rows - 1) : 0,
       pr & 0xFFFFFFFF, 0, b_rows}};
  int64_t amp[2], start[2];
  find_rows(f, g, amp, start);
  int len[2];
  const uint32_t *src[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    src[k] = row_of(words, n_words, row_word, lengths, n, amp[k], &len[k]);
  Variant v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    v[k] = decode(src[k], len[k], f[k].pay - start[k], g);
  bool same = v[0].len == v[1].len;
  const int v_words = (v[0].len + 15) >> 4;
  for (int w0 = 0; same && w0 < v_words; w0 += G) {
    const int w = w0 + g.lane;
    same = __all_sync(g.mask, w >= v_words || variant_word(v[0], w) ==
                                                  variant_word(v[1], w));
  }
  if (g.lane == 0) {
    ok[t] = same;
    if (same)  // lowered to the heavy amplicon at the light one
      atomicMin(best + (small_is_heavy ? amp[1] : amp[0]),
                (int32_t)(small_is_heavy ? amp[0] : amp[1]));
  }
}

inline unsigned grid_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// after the launch, or the error of a launch attribute it sets
// (cudaErrorInvalidValue for words, keys, payloads or a join's big keys
// that are not 16-byte aligned, or a Zobrist table that is not 8-byte
// aligned). Nothing is launched for an empty input.

extern "C" int swarm_graft_join_chunk() { return kJoinChunk; }

extern "C" int swarm_graft_join_tile() { return kJoinTile; }

extern "C" int swarm_graft_keygen_count(const void *words, int64_t n_words,
                                        const void *row_word,
                                        const void *lengths, int64_t n,
                                        const void *ids, int64_t m,
                                        void *counts, void *stream) {
  if ((uintptr_t)words % 16) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  graft_count_kernel<<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words, n_words, (const int64_t *)row_word,
      (const int32_t *)lengths, n, (const int64_t *)ids, m,
      (int32_t *)counts);
  return (int)cudaGetLastError();
}

// a persistent grid: as many blocks of kThreads as are resident at once
// (dynamic shared memory `smem`), at most `work`
template <class Kernel>
static cudaError_t resident_grid(Kernel kernel, size_t smem, int64_t work,
                                 unsigned *grid) {
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  *grid = (unsigned)min(work, (int64_t)max(per_sm, 1) * sms);
  return cudaSuccess;
}

extern "C" int swarm_graft_keygen_emit(const void *words, int64_t n_words,
                                       const void *row_word,
                                       const void *lengths, int64_t n,
                                       const void *ids, int64_t m,
                                       const void *zob, int64_t z_rows,
                                       const void *ends, void *keys,
                                       void *pays, void *stream) {
  if ((uintptr_t)words % 16 || (uintptr_t)zob % 8 || (uintptr_t)keys % 16 ||
      (uintptr_t)pays % 16)
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  unsigned grid;  // one warp a row at most
  const cudaError_t err = resident_grid(graft_emit_kernel, 0,
                                        (m + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return (int)err;
  graft_emit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words, n_words, (const int64_t *)row_word,
      (const int32_t *)lengths, n, (const int64_t *)ids, m,
      (const uint2 *)zob, z_rows, (const int64_t *)ends, (int64_t *)keys,
      (int32_t *)pays);
  return (int)cudaGetLastError();
}

// first, last [n_chunks] int64: the buckets of each chunk's first and
// last big element; counts [n_chunks] int64, rec [m_big] int64, n_rec
// [n_chunks] int32 and links [m_small] int32 are written (links only
// where a repeated key's chain needs them). The big side's keys must be
// 16-byte aligned (cp.async).
extern "C" int swarm_graft_join_count(const void *skeys, const void *s_ends,
                                      const void *bkeys, int64_t m_big,
                                      const void *b_ends, const void *first,
                                      const void *last, void *counts,
                                      void *rec, void *n_rec, void *links,
                                      void *stream) {
  if ((uintptr_t)bkeys % 16 || (uintptr_t)skeys % 16)
    return (int)cudaErrorInvalidValue;
  if (m_big <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      graft_join_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kJoinSmem);
  unsigned grid;
  if (err == cudaSuccess)
    err = resident_grid(graft_join_count_kernel, kJoinSmem,
                        (m_big + kJoinChunk - 1) / kJoinChunk, &grid);
  if (err != cudaSuccess) return (int)err;
  graft_join_count_kernel<<<grid, kJoinThreads, kJoinSmem,
                            (cudaStream_t)stream>>>(
      (const int64_t *)skeys, (const int64_t *)s_ends, (const int64_t *)bkeys,
      m_big, (const int64_t *)b_ends, (const int64_t *)first,
      (const int64_t *)last, (int64_t *)counts, (int64_t *)rec,
      (int32_t *)n_rec, (int32_t *)links);
  return (int)cudaGetLastError();
}

// ends [n_chunks]: the inclusive cumsum of the count pass' counts
extern "C" int swarm_graft_join_emit(const void *spays, const void *bpays,
                                     int64_t m_big, const void *rec,
                                     const void *n_rec, const void *links,
                                     const void *ends, void *pairs,
                                     void *stream) {
  if (m_big <= 0) return 0;
  const int64_t chunks = (m_big + kJoinChunk - 1) / kJoinChunk;
  graft_join_emit_kernel<<<(unsigned)((chunks + kJoinWarps - 1) / kJoinWarps),
                           kJoinThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t *)spays, (const int32_t *)bpays, m_big,
      (const int64_t *)rec, (const int32_t *)n_rec, (const int32_t *)links,
      (const int64_t *)ends, (int64_t *)pairs);
  return (int)cudaGetLastError();
}

extern "C" int swarm_graft_verify(const void *words, int64_t n_words,
                                  const void *row_word, const void *lengths,
                                  int64_t n, const void *s_ids,
                                  const void *s_ends, int64_t s_rows,
                                  const void *b_ids, const void *b_ends,
                                  int64_t b_rows, const void *pairs,
                                  int64_t n_pairs, int small_is_heavy,
                                  void *ok, void *best, void *stream) {
  if ((uintptr_t)words % 16) return (int)cudaErrorInvalidValue;
  if (n_pairs <= 0) return 0;
  graft_verify_kernel<kVerifyLanes><<<grid_for(n_pairs * kVerifyLanes),
                                      kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words, n_words, (const int64_t *)row_word,
      (const int32_t *)lengths, n, (const int64_t *)s_ids,
      (const int64_t *)s_ends, s_rows, (const int64_t *)b_ids,
      (const int64_t *)b_ends, b_rows, (const int64_t *)pairs, n_pairs,
      small_is_heavy, (bool *)ok, (int32_t *)best);
  return (int)cudaGetLastError();
}
