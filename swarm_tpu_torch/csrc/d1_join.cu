// d=1 network by a radix-partitioned join over ragged rows: count and
// pack, keygen, partition by bucket, equal-key join a bucket, exact
// distance-1 verify.
//
// Replaces the XLA programs of swarm_tpu/ops/neighbors_sortjoin.py (the
// d=1 path had no Pallas source):
//   deletion_keys_poly (:142), and the
//   width-bucketed network_pairs_bucketed (:962) -> d1_count_pack_kernel,
//                                                  d1_keygen_kernel
//                                                  (swarm_d1_keygen_*)
//   join_pairs (:416): its global sort (:484)
//                      and its run walk (:486-596) -> d1_partition_*_kernel
//                                                  (swarm_d1_partition_*),
//                                                  d1_join_count_kernel,
//                                                  d1_join_emit_kernel
//                                                  (swarm_d1_join_*)
//   _verify_dist1_packed (:337), in
//   verify_pairs_compact (:282)        -> d1_verify_kernel (swarm_d1_verify)
// Plain PyTorch versions and the wrappers: swarm_tpu_torch/ops/
// neighbors_sortjoin.py. The keys are never sorted: the join needs equal
// keys together, not in order, so they are partitioned into buckets of
// ~1,000 by a hash of the key, and each bucket is joined in shared
// memory. The candidates are deduplicated by torch.sort and
// torch.unique_consecutive (a few hundred thousand pairs) before the
// verify.
//
// Ragged rows. The input is the database's code arena as it was read
// (one byte a base, codes 0..3, rows in parse order, so row i starts at
// any byte offsets[i]). Row i of length L takes 4 * ceil(L / 64) words
// of 2-bit codes (pack2bit: base j at bits 2 * (j % 16) of word j / 16,
// zero past L) from word row_word[i], the exclusive cumsum of those
// sizes: every row starts on a 16-byte boundary, so the verify reads it
// as whole uint4s, and a 5 kb read costs its own 316 words, not a
// longest-row stride for every row (JAX's answer to that was width
// buckets and one keygen program a bucket; here one set of kernels takes
// any mix of lengths). Every kernel refuses a row whose words do not
// fit the layout (a start not a multiple of 4, words past n_words, a
// last row that does not end at n_words, an arena span past n_codes, a
// pair id outside [0, n)) with __trap(): the launch fails, and the next
// synchronisation raises.
//
// Count and pack (keygen pass 1, fused). One warp a row, lane =
// position in a chunk of 32, as in the emit pass: the count of a row's
// keys is one plus its run starts (a ballot of code != the code before),
// and the same walk packs the codes it has read: two __reduce_or_sync of
// code << 2 * (lane % 16) give a chunk's two words, which lanes 2k and
// 2k + 1 hold until the trip of four chunks ends and stores up to 8
// words as one coalesced store. Packing here, not in a kernel of its
// own, saves one read of the arena (1 byte a base, 187 MB at 1M reads
// of 187 nt) and a launch; the packed words are what the emit pass and
// the verify read. What bounds it: bytes (the arena once, the words,
// four small per-row arrays). A trip's four byte loads a lane are
// issued before its first shuffle. Trips of eight chunks, which halve a
// 150-nt row's waits for memory, were 3% (1M rows of 150 nt) and 9%
// (1M rows of mixed lengths) slower on an H100.
//
// Keygen emit. A row x of length L has the keys h(x) (slot 0, when
// L > 0) and h(del_p(x)) for every run start p < L, where h is the pair
// of polynomial hashes h_r(x) = sum_q (x_q + 1) r^q mod 2^32 for the two
// r of _POLY_R, held as one 64-bit key (h_0 << 32) | h_1. Deleting p
// shifts the suffix down one power: h_r(del_p(x)) = pre_p + rinv * (tot
// - pre_p - (x_p + 1) r^p), pre_p the sum of the terms before p. After
// the count pass and torch.cumsum, the emit pass writes the keys and
// their owner (the row), compacted, in row order and slot order, so
// the partition takes about 114 keys a row of 150 nt and no sentinel.
// What bounds it: bytes (at 1M rows of 150 nt it reads 48 MB of words
// and writes 1.37 GB of keys and owners, against ~20 integer operations
// a base).
// Design: one warp a row reading the packed words, lane = position in a
// chunk of 32, each lane with its power r^lane and the chunk's r^base
// carried by one multiply by r^32. It first sums the row's terms (a
// shuffle reduction a chunk), then walks the chunks again: a shuffle
// scan of each half gives every lane its prefix, one shuffle the code
// before it (run starts), a ballot the place of its key among the
// chunk's, so that a chunk's keys go out as one coalesced store. The
// count pass walks the same chunks with the same run test on the same
// codes (the words it packed are the codes it counted), so its count is
// the emit pass's by construction.
//
// Partition. The bucket of a key is the top `bits` bits of ((h1 *
// 0x9E3779B1) ^ h0) * 0x85EBCA6B mod 2^32, with bits chosen so that a
// bucket holds 512-1,024 keys on average (17 bits at 113.6 M keys). The
// key's raw bits would not do: bit 0 of h_r is the parity of the row's sum
// of (code + 1), and a 1-nt row's keys are 1..4 and 0, so raw top bits put
// every short row in bucket 0. The bucket is a function of the key alone,
// so equal keys share one. The partition is stable (a bucket's elements
// keep the keygen's order) and deterministic, an LSD radix partition of the
// 12-byte (key, owner) pairs in passes of at most 9 bits (a pass's
// histogram is a tile's shared memory: 2^17 bins would not fit), always an
// even number of passes, so that the result lands in the input's buffers
// and one scratch pair serves as the other half of the ping-pong. Each pass
// is reduce-then-scan: the count kernel writes each tile's histogram
// (shared-memory atomics) digit-major, one torch.cumsum gives every (digit,
// tile) its end, the scatter kernel re-reads the tile, ranks it (warp
// order, chunk order, then the lanes of equal digits, found by one ballot a
// digit bit: the same order every run; a first version's __match_any_sync
// cost 2.3 ms a pass at d1_1m), stages it in shared memory by digit and
// stores each digit's elements as one run of consecutive addresses, so the
// writes coalesce (the hardware-conscious GPU partitioning of Sioulas et
// al., ICDE 2019, and CUB's onesweep, written here by hand). A bounds
// kernel then finds each bucket's end by a binary search of the partitioned
// keys. What bounds it: bytes, per pass 8 a key counted and 24 scattered,
// ~64 a key for two passes (torch.sort of int64 keys with int64 indices and
// torch.take of the owners moved ~256: eight 8-bit passes of 16-byte pairs,
// then the gather).
//
// Join. The count pass takes one block a bucket. A bucket of up to kJoinCap
// = 1,536 elements goes to shared memory (all of a thread's loads in flight
// before its first store): a table of its distinct keys (open addressing,
// another hash than the bucket's), each slot held by the element that won
// it (its key's head), and each head's number of elements. Most keys come
// once (at 1M reads ~1% of the elements share a key), so the elements whose
// key repeats are listed in element order (a ballot a chunk), and warp 0
// alone links each to the last earlier listed element of its key
// (__match_any_sync among a chunk's lanes), counts its pairs along that
// chain (every earlier element of its key and another owner; two slots of
// one run share an owner only by a hash collision), and leaves the list and
// its links in global memory (a 16-bit element and a 16-bit place a listed
// element, at the bucket's own span of an [m] int32 array, and their number
// a bucket). The emit pass reads only that record: one warp a bucket walks
// the listed elements in order (a warp scan of their counts places their
// pairs) and writes each one's pairs from the nearest back, as (min owner
// << 32) | max owner. A run of equal keys is never split, so a bucket can
// exceed the tile (a read with thousands of single insertions in the
// corpus: all share its key); such a bucket goes to the kernels' other
// variant, which walks it round against tile from global memory through the
// same shared memory, O(s^2) compares, in both passes (the emit pass counts
// again; a block scan places the pairs). Exact for any run length: no
// window, no cap. What bounds it: bytes (12 read a key, 8 written a pair).
// Variants tried at d1_1m on an H100 (count + emit): every element linked
// by one warp in both passes, 8.7 ms; only the repeated keys linked, both
// passes over the keys, 3.0 ms; that, but persistent blocks prefetching the
// next bucket by cp.async, 3.5 ms.
//
// Verify. One thread a candidate pair (a << 32) | b: both rows read as
// uint4 from their own starts. Equal lengths: XOR, one popcount of (x |
// x >> 1) & 0x55555555 a word, distance 1 iff exactly one field differs
// (the zero padding agrees). Lengths L + 1 (x) and L (y): one pass over
// the fields below L finds the first field f where x and y differ and
// the last field g where x shifted down one field (__funnelshift_r)
// differs from y; y is x less one base iff g < f (delete x_f: the prefix
// before f agrees, the shifted suffix from f on agrees). The shift's
// look-ahead vector stops at x's own last vector: past it lie the next
// row's words. Any other lengths: not a pair. What bounds it: bytes,
// the two rows of a pair.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kR0 = 0x9E3779B1u;     // _POLY_R
constexpr uint32_t kR1 = 0x85EBCA77u;
constexpr uint32_t kRinv0 = 0x0E8B2F51u;  // kR0 * kRinv0 == 1 mod 2^32
constexpr uint32_t kRinv1 = 0xB6C92F47u;
constexpr uint32_t kOdd = 0x55555555u;    // low bit of every 2-bit field
constexpr unsigned kFull = 0xFFFFFFFFu;   // every lane of a warp
constexpr int kTrip = 128;                // bases of a count-and-pack trip

// partition: a tile of kPartItems chunks of 32 elements a warp
constexpr int kPartThreads = 256;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kPartItems = 16;
constexpr int kPartTile = kPartThreads * kPartItems;  // elements a tile
constexpr int kMaxRadix = 1 << 9;                     // digits of a pass
constexpr uint32_t kMixA = 0x9E3779B1u;               // the bucket's mixer
constexpr uint32_t kMixB = 0x85EBCA6Bu;
constexpr size_t kPartSmem =
    (size_t)kPartTile * (8 + 4) + (size_t)(kPartWarps + 2) * kMaxRadix * 4;

// join: one block a bucket, buckets of up to kJoinCap in shared memory
constexpr int kJoinThreads = 256;
constexpr int kJoinWarps = kJoinThreads / 32;
constexpr int kJoinCap = 1536;  // five blocks an SM
constexpr int kJoinChunks = (kJoinCap + kJoinThreads - 1) / kJoinThreads;
constexpr int kJoinSlotBits = 11;
constexpr int kJoinSlots = 1 << kJoinSlotBits;  // 3/4 full at most
constexpr size_t kJoinSmem = (size_t)kJoinCap * (8 + 4 + 4 + 4) +
                             (size_t)kJoinSlots * 4 + kJoinWarps * (8 + 4);

// fields [0, k) of a word, for k of any sign
__device__ __forceinline__ uint32_t field_mask(int k) {
  return k >= 16 ? 0xFFFFFFFFu : k <= 0 ? 0u : (1u << (2 * k)) - 1u;
}

// one bit (the field's low bit) for every 2-bit field that is not zero
__device__ __forceinline__ uint32_t nonzero_fields(uint32_t x) {
  return (x | (x >> 1)) & kOdd;
}

__device__ __forceinline__ int64_t make_key(uint32_t h0, uint32_t h1) {
  return (int64_t)(((uint64_t)h0 << 32) | h1);
}

// words of a row of len bases: whole uint4s of 64 bases
__device__ __forceinline__ int64_t row_size(int len) {
  return 4 * (((int64_t)len + 63) / 64);
}

// row_word[row], after the layout's checks (see the note above)
__device__ __forceinline__ int64_t row_start(const int64_t *row_word,
                                             int64_t row, int64_t n, int len,
                                             int64_t n_words) {
  const int64_t start = row_word[row];
  const int64_t end = start + row_size(len);
  if (len < 0 || start < 0 || (start & 3) || end > n_words ||
      (row == n - 1 && end != n_words))
    __trap();
  return start;
}

// r^lane for this lane, and r^32 (five squarings of r)
__device__ __forceinline__ uint32_t lane_power(uint32_t r, int lane,
                                               uint32_t *r32) {
  uint32_t p = 1u;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    if ((lane >> b) & 1) p *= r;
    r *= r;
  }
  *r32 = r;
  return p;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// One warp a row: counts[row] = the row's number of keys, and its words
// packed from the arena (code 4 marks a position past the row).
__global__ void __launch_bounds__(kThreads)
    d1_count_pack_kernel(const uint8_t *__restrict__ codes, int64_t n_codes,
                         const int64_t *__restrict__ offsets,
                         const int32_t *__restrict__ lengths,
                         const int64_t *__restrict__ row_word, int64_t n,
                         uint32_t *__restrict__ words, int64_t n_words,
                         int32_t *__restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (row >= n) return;  // the whole warp: a warp holds one row
  const int len = lengths[row];
  const int64_t off = offsets[row];
  uint32_t *dst = words + row_start(row_word, row, n, len, n_words);
  if (off < 0 || off + len > n_codes) __trap();
  const uint8_t *src = codes + off;
  const int span = (int)(16 * row_size(len));  // bases of the row's words
  int count = len > 0;
  uint32_t before_chunk = 4u;  // no code: position 0 starts a run
  for (int base = 0; base < span; base += kTrip) {
    uint32_t code[kTrip / 32];
#pragma unroll
    for (int k = 0; k < kTrip / 32; ++k) {
      const int p = base + 32 * k + lane;
      code[k] = p < len ? __ldg(src + p) & 3u : 4u;
    }
    uint32_t word = 0u;  // lane j < kTrip / 16: word j of the trip
#pragma unroll
    for (int k = 0; k < kTrip / 32; ++k) {
      if (base + 32 * k >= span) break;  // the whole warp
      uint32_t before = __shfl_up_sync(kFull, code[k], 1);
      if (lane == 0) before = before_chunk;
      count += __popc(__ballot_sync(kFull, code[k] < 4u && code[k] != before));
      before_chunk = __shfl_sync(kFull, code[k], 31);
      const uint32_t bits = code[k] < 4u ? code[k] << (2 * (lane & 15)) : 0u;
      const uint32_t lo = __reduce_or_sync(kFull, lane < 16 ? bits : 0u);
      const uint32_t hi = __reduce_or_sync(kFull, lane < 16 ? 0u : bits);
      if (lane == 2 * k) word = lo;
      if (lane == 2 * k + 1) word = hi;
    }
    const int w = base / 16 + lane;
    if (lane < kTrip / 16 && 16 * w < span) dst[w] = word;
  }
  if (lane == 0) counts[row] = count;
}

// One warp a row, lane = position in a chunk of 32: the row's keys and
// owners from ends[row - 1] (ends = inclusive cumsum of the counts).
__global__ void __launch_bounds__(kThreads)
    d1_keygen_kernel(const uint32_t *__restrict__ words, int64_t n_words,
                     const int64_t *__restrict__ row_word,
                     const int32_t *__restrict__ lengths, int64_t n,
                     const int64_t *__restrict__ ends,
                     int64_t *__restrict__ keys,
                     int32_t *__restrict__ owners) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (row >= n) return;  // the whole warp: a warp holds one row
  const int len = lengths[row];
  const uint32_t *src = words + row_start(row_word, row, n, len, n_words);
  uint32_t r32_0, r32_1;
  const uint32_t pl0 = lane_power(kR0, lane, &r32_0);
  const uint32_t pl1 = lane_power(kR1, lane, &r32_1);

  // pass 1: the row's hashes, tot = sum of (code + 1) r^p
  uint32_t t0 = 0, t1 = 0;
  {
    uint32_t c0 = pl0, c1 = pl1;  // r^p of this lane's position
    for (int base = 0; base < len; base += 32) {
      const int p = base + lane;
      uint32_t s = 0;
      if (p < len) s = ((__ldg(src + (p >> 4)) >> (2 * (p & 15))) & 3u) + 1u;
      t0 += warp_sum(s * c0);
      t1 += warp_sum(s * c1);
      c0 *= r32_0;
      c1 *= r32_1;
    }
  }

  // pass 2: run starts by one shuffle (the code before lane 0 is the
  // last of the chunk before), compacted by a ballot; the deletion keys
  // from the exclusive prefix sums of the terms
  int64_t out = row ? ends[row - 1] : 0;
  if (len > 0 && lane == 0) {
    keys[out] = make_key(t0, t1);
    owners[out] = (int32_t)row;
  }
  out += len > 0;
  uint32_t before_chunk = 4u;  // no code: position 0 starts a run
  uint32_t pre0 = 0, pre1 = 0, c0 = pl0, c1 = pl1;
  for (int base = 0; base < len; base += 32) {
    const int p = base + lane;
    const bool in = p < len;
    const uint32_t code =
        in ? (__ldg(src + (p >> 4)) >> (2 * (p & 15))) & 3u : 4u;
    uint32_t before = __shfl_up_sync(kFull, code, 1);
    if (lane == 0) before = before_chunk;
    const bool start = in && code != before;
    const unsigned starts = __ballot_sync(kFull, start);
    const uint32_t term0 = in ? (code + 1u) * c0 : 0u;
    const uint32_t term1 = in ? (code + 1u) * c1 : 0u;
    const uint32_t inc0 = warp_inclusive_scan(term0, lane);
    const uint32_t inc1 = warp_inclusive_scan(term1, lane);
    if (start) {
      const uint32_t q0 = pre0 + inc0 - term0;  // sum before p
      const uint32_t q1 = pre1 + inc1 - term1;
      const int64_t at = out + __popc(starts & ((1u << lane) - 1u));
      keys[at] = make_key(q0 + kRinv0 * (t0 - q0 - term0),
                          q1 + kRinv1 * (t1 - q1 - term1));
      owners[at] = (int32_t)row;
    }
    pre0 += __shfl_sync(kFull, inc0, 31);
    pre1 += __shfl_sync(kFull, inc1, 31);
    c0 *= r32_0;
    c1 *= r32_1;
    out += __popc(starts);
    before_chunk = __shfl_sync(kFull, code, 31);
  }
}

// ---- partition: a stable radix partition of (key, owner) by bucket ----

// the bucket's mixer: the keys' raw bits are weak (bit 0 of h_r is the
// parity of the row's sum of codes + 1; a short row's hashes are small),
// so the top bits of a multiplicative mix of both halves name a bucket
__device__ __forceinline__ uint32_t key_mix(int64_t key) {
  const uint32_t h0 = (uint32_t)((uint64_t)key >> 32), h1 = (uint32_t)key;
  return ((h1 * kMixA) ^ h0) * kMixB;
}

__device__ __forceinline__ uint32_t bucket_of(int64_t key, int bits) {
  return bits ? key_mix(key) >> (32 - bits) : 0u;
}

__device__ __forceinline__ int digit_of(int64_t key, int bits, int shift,
                                        int radix) {
  return (int)((bucket_of(key, bits) >> shift) & (uint32_t)(radix - 1));
}

// the lanes holding this lane's digit d (d < 0: no element), by one
// ballot a digit bit (a multi-split: __match_any_sync costs more)
__device__ __forceinline__ unsigned digit_peers(int d, int dbits) {
  unsigned peers = __ballot_sync(kFull, d >= 0);
  for (int b = 0; b < dbits; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned bal = __ballot_sync(kFull, bit);
    peers &= bit ? bal : ~bal;
  }
  return peers;
}

// counts[d * n_tiles + tile] = the tile's elements of digit d
__global__ void __launch_bounds__(kPartThreads)
    d1_partition_count_kernel(const int64_t *__restrict__ keys, int64_t m,
                              int bits, int shift, int dbits, int n_tiles,
                              int32_t *__restrict__ counts) {
  __shared__ int32_t hist[kMaxRadix];
  const int radix = 1 << dbits;
  for (int d = threadIdx.x; d < radix; d += kPartThreads) hist[d] = 0;
  __syncthreads();
  const int64_t first = (int64_t)blockIdx.x * kPartTile;
  const int n_here = (int)min((int64_t)kPartTile, m - first);
  for (int e = threadIdx.x; e < n_here; e += kPartThreads)
    atomicAdd(&hist[digit_of(keys[first + e], bits, shift, radix)], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kPartThreads)
    counts[(int64_t)d * n_tiles + blockIdx.x] = hist[d];
}

// One tile a block: the tile's elements staged in shared memory by
// digit (stable), then stored as one run of consecutive addresses a
// digit from its offset. `ends` is the inclusive cumsum of the count
// kernel's counts, digit-major, so a tile's digit d starts at its end
// less the tile's own count.
__global__ void __launch_bounds__(kPartThreads)
    d1_partition_scatter_kernel(const int64_t *__restrict__ keys,
                                const int32_t *__restrict__ owners, int64_t m,
                                int bits, int shift, int dbits, int n_tiles,
                                const int32_t *__restrict__ ends,
                                int64_t *__restrict__ keys_out,
                                int32_t *__restrict__ owners_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t *skeys = (int64_t *)smem;
  int32_t *sown = (int32_t *)(skeys + kPartTile);
  int32_t *whist = sown + kPartTile;  // [warp][digit]
  int32_t *tstart = whist + kPartWarps * kMaxRadix;
  int32_t *gbase = tstart + kMaxRadix;
  const int radix = 1 << dbits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t first = (int64_t)blockIdx.x * kPartTile;
  const int n_here = (int)min((int64_t)kPartTile, m - first);
  for (int t = threadIdx.x; t < kPartWarps * kMaxRadix; t += kPartThreads)
    whist[t] = 0;
  __syncthreads();

  // each warp holds kPartItems chunks of 32 consecutive elements, warp w
  // the w-th span of the tile, so warp, chunk and lane order is the
  // elements' order; a chunk's equal digits find each other (digit_peers),
  // and the lowest of them adds their number. The elements stay in
  // registers until they are staged (keeping only the keys there, to fit
  // three blocks an SM, was 19% slower on an H100)
  int64_t key[kPartItems];
  int32_t own[kPartItems];
  int dig[kPartItems];
  unsigned peers[kPartItems];
  int32_t *mine = whist + warp * kMaxRadix;
#pragma unroll
  for (int c = 0; c < kPartItems; ++c) {
    const int e = (warp * kPartItems + c) * 32 + lane;
    const bool in = e < n_here;
    key[c] = in ? keys[first + e] : 0;
    own[c] = in ? owners[first + e] : 0;
    dig[c] = in ? digit_of(key[c], bits, shift, radix) : -1;
  }
#pragma unroll
  for (int c = 0; c < kPartItems; ++c) {
    peers[c] = digit_peers(dig[c], dbits);
    if (dig[c] >= 0 && (peers[c] & below) == 0)
      mine[dig[c]] += __popc(peers[c]);
    __syncwarp();
  }
  __syncthreads();

  // per digit: the warps' exclusive prefix, the tile's count, and where
  // the tile's run of the digit starts in the output
  for (int d = threadIdx.x; d < radix; d += kPartThreads) {
    int run = 0;
    for (int w = 0; w < kPartWarps; ++w) {
      const int v = whist[w * kMaxRadix + d];
      whist[w * kMaxRadix + d] = run;
      run += v;
    }
    tstart[d] = run;
    gbase[d] = ends[(int64_t)d * n_tiles + blockIdx.x] - run;
  }
  __syncthreads();
  if (warp == 0) {  // the counts' exclusive scan over the digits
    const int per = (radix + 31) / 32;
    const int d0 = min(lane * per, radix), d1 = min(d0 + per, radix);
    int sum = 0;
    for (int d = d0; d < d1; ++d) sum += tstart[d];
    int run = warp_inclusive_scan((uint32_t)sum, lane) - sum;
    for (int d = d0; d < d1; ++d) {
      const int v = tstart[d];
      tstart[d] = run;
      run += v;
    }
  }
  __syncthreads();

  // each element's place in the tile: its digit's start, the earlier
  // warps' and chunks' elements of the digit, its rank among its peers
#pragma unroll
  for (int c = 0; c < kPartItems; ++c) {
    const int base = dig[c] >= 0 ? mine[dig[c]] : 0;
    __syncwarp();
    if (dig[c] >= 0) {
      const int at = tstart[dig[c]] + base + __popc(peers[c] & below);
      skeys[at] = key[c];
      sown[at] = own[c];
      if ((peers[c] & below) == 0) mine[dig[c]] = base + __popc(peers[c]);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int e = threadIdx.x; e < n_here; e += kPartThreads) {
    const int64_t k = skeys[e];
    const int d = digit_of(k, bits, shift, radix);
    const int64_t at = (int64_t)gbase[d] + (e - tstart[d]);
    keys_out[at] = k;
    owners_out[at] = sown[e];
  }
}

// bucket_ends[b] = the first element of a bucket above b (keys partitioned)
__global__ void __launch_bounds__(kThreads)
    d1_partition_bounds_kernel(const int64_t *__restrict__ keys, int64_t m,
                               int bits, int64_t *__restrict__ bucket_ends) {
  const int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (b >= ((int64_t)1 << bits)) return;
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (bucket_of(keys[mid], bits) <= (uint64_t)b)
      lo = mid + 1;
    else
      hi = mid;
  }
  bucket_ends[b] = lo;
}

// ---- join: one block a bucket ----

struct JoinSmem {
  int64_t *keys;    // [kJoinCap]; once the table holds them, list and link
  int32_t *list;    // [kJoinCap] the elements whose key repeats, in order
  int32_t *link;    // [kJoinCap] a listed element's earlier one, or -1
  int32_t *own;     // [kJoinCap]
  int32_t *head;    // [kJoinCap] the element that holds its key's slot
  int32_t *cnt;     // [kJoinCap] a head's elements; then its key's last
  int32_t *table;   // [kJoinSlots] a slot's head, or -1
  int64_t *scan;    // [kJoinWarps]
  int32_t *wcount;  // [kJoinWarps]
};

__device__ __forceinline__ JoinSmem join_smem(unsigned char *base) {
  JoinSmem sm;
  sm.keys = (int64_t *)base;
  sm.list = (int32_t *)sm.keys;
  sm.link = sm.list + kJoinCap;
  sm.own = (int32_t *)(sm.keys + kJoinCap);
  sm.head = sm.own + kJoinCap;
  sm.cnt = sm.head + kJoinCap;
  sm.table = sm.cnt + kJoinCap;
  sm.scan = (int64_t *)(sm.table + kJoinSlots);
  sm.wcount = (int32_t *)(sm.scan + kJoinWarps);
  return sm;
}

// the table's slot: another mix than the bucket's (within a bucket the
// bucket's bits are all equal)
__device__ __forceinline__ uint32_t slot_of(int64_t key) {
  return (uint32_t)(((uint64_t)key * 0x9E3779B97F4A7C15ull) >>
                    (64 - kJoinSlotBits));
}

__device__ __forceinline__ int64_t pack_pair(int32_t a, int32_t b) {
  return ((int64_t)min(a, b) << 32) | (uint32_t)max(a, b);
}

// a listed element and the place in the list of the last earlier
// element of its key (kNoLink: none), as the count pass leaves them
constexpr uint32_t kNoLink = 0xFFFFu;

__device__ __forceinline__ int32_t pack_link(int t, int at) {
  return (int32_t)(((uint32_t)t << 16) | ((uint32_t)at & kNoLink));
}

// the sum of v over the block and, with `before`, the sum over the
// threads before this one (all threads call it)
__device__ int64_t block_sum(int64_t v, int64_t *scratch, int64_t *before) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int64_t all = 0, earlier = 0;
  for (int w = 0; w < kJoinWarps; ++w) {
    const int64_t t = scratch[w];
    if (w < warp) earlier += t;
    all += t;
  }
  __syncthreads();  // scratch is reused by the next call
  if (before) *before = earlier + incl - v;
  return all;
}

// The count pass on a bucket of s <= kJoinCap elements in shared memory:
// a table of its distinct keys (open addressing, linear probing; a slot
// holds the element that won it, its key's head) and each head's number
// of elements. Most keys come once. Those that repeat are listed in
// element order (a ballot a chunk, each warp over its own span), and
// warp 0 alone links each listed element to the last earlier one of its
// key (__match_any_sync on the head among a chunk's lanes, a key's last
// place so far in cnt[head]), counts each one's pairs along its chain,
// and leaves the list and its links at links[lo ..] and their number at
// n_listed[b], which is all the emit pass reads. Returns the bucket's
// pairs (in warp 0).
__device__ int64_t join_count_shared(const int64_t *__restrict__ keys,
                                     const int32_t *__restrict__ owners,
                                     int64_t b, int64_t lo, int s,
                                     int32_t *__restrict__ links,
                                     int32_t *__restrict__ n_listed,
                                     JoinSmem sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  {  // every load of the bucket in flight before the first store
    int64_t k[kJoinChunks];
    int32_t o[kJoinChunks];
#pragma unroll
    for (int c = 0; c < kJoinChunks; ++c) {
      const int t = threadIdx.x + c * kJoinThreads;
      k[c] = t < s ? keys[lo + t] : 0;
      o[c] = t < s ? owners[lo + t] : 0;
    }
#pragma unroll
    for (int c = 0; c < kJoinChunks; ++c) {
      const int t = threadIdx.x + c * kJoinThreads;
      if (t < s) {
        sm.keys[t] = k[c];
        sm.own[t] = o[c];
        sm.cnt[t] = 0;
      }
    }
  }
  for (int t = threadIdx.x; t < kJoinSlots; t += kJoinThreads)
    sm.table[t] = -1;
  __syncthreads();
  volatile int32_t *table = sm.table;
  for (int t = threadIdx.x; t < s; t += kJoinThreads) {
    const int64_t k = sm.keys[t];
    uint32_t h = slot_of(k);
    int head = t;
    for (;;) {
      int cur = table[h];
      if (cur < 0) {
        cur = atomicCAS(sm.table + h, -1, t);
        if (cur < 0) break;
      }
      if (sm.keys[cur] == k) {
        head = cur;
        break;
      }
      h = (h + 1) & (kJoinSlots - 1);
    }
    sm.head[t] = head;
    atomicAdd(sm.cnt + head, 1);
  }
  __syncthreads();

  // the repeated keys' elements, listed in element order
  const int chunks = (s + kJoinThreads - 1) / kJoinThreads;
  const int span = 32 * chunks;  // warp w: elements [w * span, ...)
  unsigned flags[kJoinChunks];
  int mine = 0;
#pragma unroll
  for (int c = 0; c < kJoinChunks; ++c) {
    const int t = warp * span + 32 * c + lane;
    flags[c] = __ballot_sync(
        kFull, c < chunks && t < s && sm.cnt[sm.head[t]] >= 2);
    mine += __popc(flags[c]);
  }
  if (lane == 0) sm.wcount[warp] = mine;
  __syncthreads();  // the keys are read: list and link take their place
  int at = 0, n = 0;
  for (int w = 0; w < kJoinWarps; ++w) {
    const int v = sm.wcount[w];
    if (w < warp) at += v;
    n += v;
  }
#pragma unroll
  for (int c = 0; c < kJoinChunks; ++c) {
    const int t = warp * span + 32 * c + lane;
    if ((flags[c] >> lane) & 1u) {
      sm.list[at + __popc(flags[c] & below)] = t;
      sm.cnt[sm.head[t]] = -1;  // from here on: the key's last place
    }
    at += __popc(flags[c]);
  }
  __syncthreads();
  if (warp != 0) return 0;

  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int t = i < n ? sm.list[i] : -1;
    const int g = t >= 0 ? sm.head[t] : -1 - lane;
    const unsigned peers = __match_any_sync(kFull, g);
    const unsigned lower = peers & below;
    if (t >= 0) sm.link[i] = lower ? base + 31 - __clz(lower) : sm.cnt[g];
    __syncwarp();
    if (t >= 0 && (peers >> lane) == 1u) sm.cnt[g] = i;
    __syncwarp();
  }
  int64_t total = 0;
  for (int i = lane; i < n; i += 32) {
    const int32_t own = sm.own[sm.list[i]];
    int cnt = 0;
    for (int j = sm.link[i]; j >= 0; j = sm.link[j])
      cnt += sm.own[sm.list[j]] != own;
    total += cnt;
    links[lo + i] = pack_link(sm.list[i], sm.link[i]);
  }
  if (lane == 0) n_listed[b] = n;
  return warp_sum((uint32_t)total);  // a bucket's pairs: < 2^21
}

// The emit pass on a bucket of s <= kJoinCap elements: warp 0 walks the
// count pass' list and links, element after element (a warp scan of
// their pairs places them), each one's chain from the nearest back.
__device__ void join_emit_listed(const int32_t *__restrict__ owners,
                                 int64_t b, int64_t lo, int64_t out,
                                 const int32_t *__restrict__ links,
                                 const int32_t *__restrict__ n_listed,
                                 int64_t *__restrict__ pairs) {
  const int lane = threadIdx.x & 31;
  const int n = n_listed[b];
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    int cnt = 0;
    int32_t own = 0;
    uint32_t first = kNoLink;
    if (i < n) {
      const uint32_t l = (uint32_t)links[lo + i];
      own = owners[lo + (l >> 16)];
      first = l & kNoLink;
      for (uint32_t j = first; j != kNoLink;) {
        const uint32_t lj = (uint32_t)links[lo + j];
        cnt += owners[lo + (lj >> 16)] != own;
        j = lj & kNoLink;
      }
    }
    const int incl = (int)warp_inclusive_scan((uint32_t)cnt, lane);
    int64_t o = out + incl - cnt;
    for (uint32_t j = first; j != kNoLink;) {
      const uint32_t lj = (uint32_t)links[lo + j];
      const int32_t other = owners[lo + (lj >> 16)];
      if (other != own) pairs[o++] = pack_pair(own, other);
      j = lj & kNoLink;
    }
    out += __shfl_sync(kFull, incl, 31);
  }
}

// The pairs element t of a bucket makes with the bucket's elements
// before it, walked from global memory tile by tile through shared
// memory (kJoinCap elements a tile), the nearest tile first. The tiles
// cover the round [r, r + kJoinThreads) of the whole block.
template <bool EMIT>
__device__ int oversized_walk(const int64_t *__restrict__ keys,
                              const int32_t *__restrict__ owners, int64_t lo,
                              int64_t s, int64_t r, int64_t t, int64_t key,
                              int32_t own, int64_t at,
                              int64_t *__restrict__ pairs, JoinSmem sm) {
  int cnt = 0;
  for (int64_t j1 = min(r + kJoinThreads, s); j1 > 0; j1 -= kJoinCap) {
    const int64_t j0 = max(j1 - kJoinCap, (int64_t)0);
    __syncthreads();
    for (int64_t j = j0 + threadIdx.x; j < j1; j += kJoinThreads) {
      sm.keys[j - j0] = keys[lo + j];
      sm.own[j - j0] = owners[lo + j];
    }
    __syncthreads();
    if (t < s)
      for (int64_t j = min(j1, t) - 1; j >= j0; --j)
        if (sm.keys[j - j0] == key && sm.own[j - j0] != own) {
          if (EMIT) pairs[at++] = pack_pair(own, sm.own[j - j0]);
          ++cnt;
        }
  }
  return cnt;
}

// A bucket of more than kJoinCap elements (a run of equal keys is never
// split, so one bucket can hold thousands): rounds of kJoinThreads
// elements, each walking the earlier elements (oversized_walk); the
// emit pass walks twice, to count and to write. O(s^2) compares.
template <bool EMIT>
__device__ int64_t join_oversized(const int64_t *__restrict__ keys,
                                  const int32_t *__restrict__ owners,
                                  int64_t lo, int64_t s, int64_t out,
                                  int64_t *__restrict__ pairs, JoinSmem sm) {
  int64_t total = 0;
  for (int64_t r = 0; r < s; r += kJoinThreads) {  // the whole block
    const int64_t t = r + threadIdx.x;
    const int64_t key = t < s ? keys[lo + t] : 0;
    const int32_t own = t < s ? owners[lo + t] : 0;
    const int cnt = oversized_walk<false>(keys, owners, lo, s, r, t, key, own,
                                          0, pairs, sm);
    if (EMIT) {
      int64_t at;
      const int64_t round = block_sum(cnt, sm.scan, &at);
      oversized_walk<true>(keys, owners, lo, s, r, t, key, own, out + at,
                           pairs, sm);
      out += round;
    }
    total += cnt;
  }
  return EMIT ? 0 : block_sum(total, sm.scan, nullptr);
}

// The count pass, one block a bucket: counts[b] = bucket b's pairs and,
// for a bucket in the tile, its listed elements and their links.
__global__ void __launch_bounds__(kJoinThreads)
    d1_join_count_kernel(const int64_t *__restrict__ keys,
                         const int32_t *__restrict__ owners,
                         const int64_t *__restrict__ bucket_ends,
                         int64_t *__restrict__ counts,
                         int32_t *__restrict__ links,
                         int32_t *__restrict__ n_listed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const JoinSmem sm = join_smem(smem);
  const int64_t b = blockIdx.x;
  const int64_t lo = b ? bucket_ends[b - 1] : 0;
  const int64_t s = bucket_ends[b] - lo;
  const int64_t total =
      s <= kJoinCap
          ? join_count_shared(keys, owners, b, lo, (int)s, links, n_listed,
                              sm)
          : join_oversized<false>(keys, owners, lo, s, 0, nullptr, sm);
  if (threadIdx.x == 0) counts[b] = total;
}

// The emit pass: bucket b's pairs from ends[b - 1] (ends = inclusive
// cumsum of the counts), element after element in partition order, each
// with its earlier equal keys of another owner from the nearest back. A
// block takes kJoinWarps buckets: each warp one in the tile (from the
// count pass' links), then the whole block each one over the tile.
__global__ void __launch_bounds__(kJoinThreads)
    d1_join_emit_kernel(const int64_t *__restrict__ keys,
                        const int32_t *__restrict__ owners,
                        const int64_t *__restrict__ bucket_ends,
                        int64_t n_buckets,
                        const int32_t *__restrict__ links,
                        const int32_t *__restrict__ n_listed,
                        const int64_t *__restrict__ ends,
                        int64_t *__restrict__ pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const JoinSmem sm = join_smem(smem);
  const int64_t b0 = (int64_t)blockIdx.x * kJoinWarps;
  const int64_t b = b0 + (threadIdx.x >> 5);
  if (b < n_buckets) {
    const int64_t lo = b ? bucket_ends[b - 1] : 0;
    if (bucket_ends[b] - lo <= kJoinCap)
      join_emit_listed(owners, b, lo, b ? ends[b - 1] : 0, links, n_listed,
                       pairs);
  }
  for (int64_t c = b0; c < min(b0 + kJoinWarps, n_buckets); ++c) {
    const int64_t lo = c ? bucket_ends[c - 1] : 0;
    const int64_t s = bucket_ends[c] - lo;
    if (s > kJoinCap)  // the whole block
      join_oversized<true>(keys, owners, lo, s, c ? ends[c - 1] : 0, pairs,
                           sm);
  }
}

__global__ void __launch_bounds__(kThreads)
    d1_verify_kernel(const uint32_t *__restrict__ words, int64_t n_words,
                     const int64_t *__restrict__ row_word,
                     const int32_t *__restrict__ lengths, int64_t n,
                     const int64_t *__restrict__ pairs, int64_t n_pairs,
                     bool *__restrict__ ok) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= n_pairs) return;
  const int64_t pr = pairs[t];
  const int64_t a = pr >> 32, b = pr & 0xFFFFFFFF;
  if (a < 0 || a >= n || b >= n) __trap();
  const int la = lengths[a], lb = lengths[b];
  const uint4 *xa =
      (const uint4 *)(words + row_start(row_word, a, n, la, n_words));
  const uint4 *xb =
      (const uint4 *)(words + row_start(row_word, b, n, lb, n_words));
  bool res = false;
  if (la == lb) {
    int mis = 0;
    for (int v = 0; v * 64 < la && mis < 2; ++v) {
      const uint4 p = __ldg(xa + v), q = __ldg(xb + v);
      mis += __popc(nonzero_fields(p.x ^ q.x)) +
             __popc(nonzero_fields(p.y ^ q.y)) +
             __popc(nonzero_fields(p.z ^ q.z)) +
             __popc(nonzero_fields(p.w ^ q.w));
    }
    res = mis == 1;
  } else if (la - lb == 1 || lb - la == 1) {
    const uint4 *x = la > lb ? xa : xb;  // longer
    const uint4 *y = la > lb ? xb : xa;
    const int ly = min(la, lb);
    const int x_vecs = (ly + 1 + 63) / 64;  // x's own vectors
    int f = ly;   // first field where x and y differ
    int g = -1;   // last field where x shifted down one field and y differ
    uint4 xv = __ldg(x);
    for (int v = 0; v * 64 < ly; ++v) {
      const uint4 yv = __ldg(y + v);
      const uint4 xn = v + 1 < x_vecs ? __ldg(x + v + 1)
                                      : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t xw[5] = {xv.x, xv.y, xv.z, xv.w, xn.x};
      const uint32_t yw[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int base = v * 64 + q * 16;
        const uint32_t below = field_mask(ly - base);
        const uint32_t md = nonzero_fields(xw[q] ^ yw[q]) & below;
        if (md != 0u && f == ly) f = base + (__ffs(md) - 1) / 2;
        const uint32_t xs = __funnelshift_r(xw[q], xw[q + 1], 2);
        const uint32_t ms = nonzero_fields(xs ^ yw[q]) & below;
        if (ms != 0u) g = base + (31 - __clz(ms)) / 2;
      }
      xv = xn;
    }
    res = g < f;
  }
  ok[t] = res;
}

inline dim3 grid_for(int64_t n) {
  return dim3((unsigned)((n + kThreads - 1) / kThreads));
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for words that are not
// 16-byte aligned). Nothing is launched for an empty input. The layout
// of the rows is checked by the kernels (see the note above).

extern "C" int swarm_d1_keygen_count(const void *codes, int64_t n_codes,
                                     const void *offsets, const void *lengths,
                                     const void *row_word, int64_t n,
                                     void *words, int64_t n_words,
                                     void *counts, void *stream) {
  if ((uintptr_t)words % 16) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  d1_count_pack_kernel<<<grid_for(32 * n), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t *)codes, n_codes, (const int64_t *)offsets,
      (const int32_t *)lengths, (const int64_t *)row_word, n,
      (uint32_t *)words, n_words, (int32_t *)counts);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d1_keygen_emit(const void *words, int64_t n_words,
                                    const void *row_word, const void *lengths,
                                    int64_t n, const void *ends, void *keys,
                                    void *owners, void *stream) {
  if ((uintptr_t)words % 16) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  d1_keygen_kernel<<<grid_for(32 * n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words, n_words, (const int64_t *)row_word,
      (const int32_t *)lengths, n, (const int64_t *)ends, (int64_t *)keys,
      (int32_t *)owners);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d1_partition_tile() { return kPartTile; }

extern "C" int swarm_d1_join_cap() { return kJoinCap; }

// one pass of the partition: the digit (bucket >> shift) & (2^dbits - 1)
extern "C" int swarm_d1_partition_count(const void *keys, int64_t m, int bits,
                                        int shift, int dbits, void *counts,
                                        void *stream) {
  if (m <= 0 || dbits < 1 || dbits > 9) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((m + kPartTile - 1) / kPartTile);
  d1_partition_count_kernel<<<n_tiles, kPartThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int64_t *)keys, m, bits, shift, dbits, n_tiles,
      (int32_t *)counts);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d1_partition_scatter(const void *keys, const void *owners,
                                          int64_t m, int bits, int shift,
                                          int dbits, const void *ends,
                                          void *keys_out, void *owners_out,
                                          void *stream) {
  if (m <= 0 || dbits < 1 || dbits > 9) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      d1_partition_scatter_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kPartSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (int)((m + kPartTile - 1) / kPartTile);
  d1_partition_scatter_kernel<<<n_tiles, kPartThreads, kPartSmem,
                                (cudaStream_t)stream>>>(
      (const int64_t *)keys, (const int32_t *)owners, m, bits, shift, dbits,
      n_tiles, (const int32_t *)ends, (int64_t *)keys_out,
      (int32_t *)owners_out);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d1_partition_bounds(const void *keys, int64_t m, int bits,
                                         void *bucket_ends, void *stream) {
  if (m <= 0 || bits < 1 || bits > 31) return (int)cudaErrorInvalidValue;
  d1_partition_bounds_kernel<<<grid_for((int64_t)1 << bits), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const int64_t *)keys, m, bits, (int64_t *)bucket_ends);
  return (int)cudaGetLastError();
}

static cudaError_t join_smem_attribute() {
  cudaError_t err = cudaFuncSetAttribute(
      d1_join_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kJoinSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(d1_join_emit_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kJoinSmem);
}

// links [m] int32 and n_listed [n_buckets] int32: the count pass' record
// of the repeated keys, which the emit pass reads
extern "C" int swarm_d1_join_count(const void *keys, const void *owners,
                                   const void *bucket_ends, int64_t n_buckets,
                                   void *counts, void *links, void *n_listed,
                                   void *stream) {
  if (n_buckets <= 0) return 0;
  const cudaError_t err = join_smem_attribute();
  if (err != cudaSuccess) return (int)err;
  d1_join_count_kernel<<<(unsigned)n_buckets, kJoinThreads, kJoinSmem,
                         (cudaStream_t)stream>>>(
      (const int64_t *)keys, (const int32_t *)owners,
      (const int64_t *)bucket_ends, (int64_t *)counts, (int32_t *)links,
      (int32_t *)n_listed);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d1_join_emit(const void *keys, const void *owners,
                                  const void *bucket_ends, int64_t n_buckets,
                                  const void *links, const void *n_listed,
                                  const void *ends, void *pairs,
                                  void *stream) {
  if (n_buckets <= 0) return 0;
  const cudaError_t err = join_smem_attribute();
  if (err != cudaSuccess) return (int)err;
  d1_join_emit_kernel<<<(unsigned)((n_buckets + kJoinWarps - 1) / kJoinWarps),
                        kJoinThreads, kJoinSmem, (cudaStream_t)stream>>>(
      (const int64_t *)keys, (const int32_t *)owners,
      (const int64_t *)bucket_ends, n_buckets, (const int32_t *)links,
      (const int32_t *)n_listed, (const int64_t *)ends, (int64_t *)pairs);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d1_verify(const void *words, int64_t n_words,
                               const void *row_word, const void *lengths,
                               int64_t n, const void *pairs, int64_t n_pairs,
                               void *ok, void *stream) {
  if ((uintptr_t)words % 16) return (int)cudaErrorInvalidValue;
  if (n_pairs <= 0) return 0;
  d1_verify_kernel<<<grid_for(n_pairs), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words, n_words, (const int64_t *)row_word,
      (const int32_t *)lengths, n, (const int64_t *)pairs, n_pairs,
      (bool *)ok);
  return (int)cudaGetLastError();
}
