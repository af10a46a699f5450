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
//                                           bucket bits, and the tile sort
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
// Keygen emit. One warp a row, lane = position in a chunk of 32. The
// first walk XORs each lane's terms and one butterfly gives the row's
// three totals: the hash, S_del = XOR_{q>=1} Z[q-1, x_q] and S_ins =
// XOR_q Z[q+1, x_q]. The second walk takes XOR scans of the chunk's terms
// (five shuffles of 64 bits each): a substitution at p is h ^ Z[p, x_p] ^
// Z[p, o]; a deletion the prefix before p ^ the S_del terms after p; an
// insertion after p the prefix through p ^ the S_ins terms after p ^
// Z[p+1, o]. Deletions are placed by a ballot of the run starts. What
// bounds it: bytes, 12 a key written (key and payload), against ~15
// integer operations a key.
//
// Join. One block a bucket b. The count pass sorts each tile of
// kJoinTile elements of the smaller side's bucket b in place by (key,
// payload), once, with a bitonic network in shared memory (JAX's
// build_graft_table sorted its small side): the side stays partitioned.
// Then every element of the strip's bucket b finds its key in each tile by
// a binary search and walks the equal keys: one pair (small payload << 32)
// | strip payload for each, in the strip's partition order, then in the
// small side's order as sorted (the partition's order, as keygen's
// payloads rise with it). A bucket of one tile is searched in shared memory;
// the tiles of a larger one where they lie, so no tile is sorted twice in
// a pass. Same-side equal keys never meet (a bucket of one side is never
// joined with itself), and a bucket that one side leaves empty costs one
// read of its bounds. No window, cap or retry: a run of any length is
// walked whole. The count pass writes each bucket's pairs; torch.cumsum
// and one readback size the emit pass, which reads the sorted tiles,
// repeats the walk and writes (more pairs than counted trap). What bounds
// it: bytes, 8 a key of both sides read, 4 a payload of a key that pairs,
// 8 a pair written.
//
// Verify. One thread a pair: each payload's row is found in its side's
// ends (binary search), its slot decoded (a deletion's position is the
// rank-th run start, counted by popcounts word by word), and the two
// variants compared base by base, each base read from the packed row. A
// pair of equal variants is a verified graft candidate: ok[pair] and an
// atomicMin of the heavy amplicon into best[light] (the smallest heavy
// amplicon a light one meets, JAX's lexsort and first-of-run). What bounds
// it: bytes, the two rows of a pair.
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
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kJoinThreads = 256;
constexpr int kJoinWarps = kJoinThreads / 32;
constexpr int kJoinTile = 2048;  // small-side elements a tile

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
__device__ __forceinline__ uint64_t zkey(const uint2 *zob, int p, uint32_t b) {
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

// One warp a row: the keys of row ids[r] and their payloads (their own
// index) from ends[r - 1] (ends = inclusive cumsum of the counts)
__global__ void __launch_bounds__(kThreads)
    graft_emit_kernel(const uint32_t *__restrict__ words, int64_t n_words,
                      const int64_t *__restrict__ row_word,
                      const int32_t *__restrict__ lengths, int64_t n,
                      const int64_t *__restrict__ ids, int64_t m,
                      const uint2 *__restrict__ zob, int64_t z_rows,
                      const int64_t *__restrict__ ends,
                      int64_t *__restrict__ keys,
                      int32_t *__restrict__ pays) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (r >= m) return;  // the whole warp: a warp holds one row
  int len;
  const uint32_t *src =
      row_of(words, n_words, row_word, lengths, n, ids[r], &len);
  if ((int64_t)len + 2 > z_rows) __trap();  // Z rows 0..len are read
  if (len == 0) return;
  const int64_t out = r ? ends[r - 1] : 0;

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
  if (lane < 4) {  // insertions before position 0
    keys[out + lane] = (int64_t)(zkey(zob, 0, lane) ^ s_ins);
    pays[out + lane] = (int32_t)(out + lane);
  }

  // walk 2: XOR scans of the chunk's terms; the deletions by a ballot
  uint64_t pre0 = 0, pre_del = 0, pre_ins = 0;  // over the earlier chunks
  uint32_t before_chunk = 4u;  // no code: position 0 starts a run
  int64_t del_at = out + 4 + 6 * (int64_t)len;
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
    if (in) {
      const int64_t at = out + 4 + 6 * (int64_t)p;
      const uint64_t sub = seq ^ g0;
      const uint64_t ins = prefix ^ g0 ^ ins_after;
#pragma unroll
      for (uint32_t k = 0; k < 3; ++k) {
        const uint32_t o = k + (c <= k);
        keys[at + k] = (int64_t)(sub ^ zkey(zob, p, o));
        keys[at + 3 + k] = (int64_t)(ins ^ zkey(zob, p + 1, o));
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) pays[at + k] = (int32_t)(at + k);
    }
    if (start) {
      const int64_t at = del_at + __popc(starts & ((1u << lane) - 1u));
      keys[at] = (int64_t)(prefix ^ del_after);
      pays[at] = (int32_t)at;
    }
    del_at += __popc(starts);
    pre0 ^= __shfl_sync(kFull, inc0, 31);
    pre_del ^= __shfl_sync(kFull, incd, 31);
    pre_ins ^= __shfl_sync(kFull, inci, 31);
    before_chunk = __shfl_sync(kFull, c, 31);
  }
}

// ---- join: one block a bucket ----

__device__ __forceinline__ void bucket_span(const int64_t *ends, int64_t b,
                                            int64_t *lo, int64_t *size) {
  *lo = b ? ends[b - 1] : 0;
  *size = ends[b] - *lo;
}

struct SortTile {
  int64_t key[kJoinTile];
  int32_t pay[kJoinTile];
};

// Elements [first, first + cnt) of the small side sorted in place by
// (key, payload): a bitonic network over the next power of two in shared
// memory (the padding sorts last), written back; t.key then holds the
// sorted keys (all threads call it)
__device__ void sort_tile(int64_t *skeys, int32_t *spays, int64_t first,
                          int cnt, SortTile &t) {
  int size = 32;
  while (size < cnt) size <<= 1;
  __syncthreads();  // the previous tile is written
  for (int i = threadIdx.x; i < size; i += kJoinThreads) {
    t.key[i] = i < cnt ? skeys[first + i] : INT64_MAX;
    t.pay[i] = i < cnt ? spays[first + i] : INT32_MAX;
  }
  __syncthreads();
  for (int k = 2; k <= size; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < size; i += kJoinThreads) {
        const int o = i ^ j;
        if (o > i) {
          const int64_t a = t.key[i], b = t.key[o];
          const bool greater = a > b || (a == b && t.pay[i] > t.pay[o]);
          if (greater == ((i & k) == 0)) {
            t.key[i] = b;
            t.key[o] = a;
            const int32_t x = t.pay[i];
            t.pay[i] = t.pay[o];
            t.pay[o] = x;
          }
        }
      }
      __syncthreads();
    }
  for (int i = threadIdx.x; i < cnt; i += kJoinThreads) {
    skeys[first + i] = t.key[i];
    spays[first + i] = t.pay[i];
  }
  __syncthreads();  // the block reads the tile back from global memory
}

// the first place of `key` among the cnt sorted keys tk
__device__ __forceinline__ int lower_bound(const int64_t *tk, int cnt,
                                           int64_t key) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tk[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The run of `key` among the size sorted keys tk: its length; with
// `emit`, also a pair (spays[p0 + i] << 32) | pay for each of its places
// i, written from *at (the payloads are read only then)
__device__ __forceinline__ int64_t walk_run(const int64_t *tk, int size,
                                            int64_t key, bool emit,
                                            const int32_t *spays, int64_t p0,
                                            uint32_t pay, int64_t *pairs,
                                            int64_t *at) {
  int i = lower_bound(tk, size, key);
  const int first = i;
  for (; i < size && tk[i] == key; ++i)
    if (emit)
      pairs[(*at)++] = ((int64_t)(uint32_t)spays[p0 + i] << 32) | pay;
  return i - first;
}

// the sum of v over the block and, in `before`, over the threads before
// this one (all threads call it)
__device__ int64_t block_sum(int64_t v, int64_t *scratch, int64_t *before) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  __syncthreads();  // scratch is free
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int64_t all = 0, earlier = 0;
  for (int w = 0; w < kJoinWarps; ++w) {
    if (w < warp) earlier += scratch[w];
    all += scratch[w];
  }
  if (before) *before = earlier + incl - v;
  return all;
}

// Bucket b of both sides, the small side's tiles sorted: the strip's
// elements in rounds of kJoinThreads, each finding its key in every tile.
// A bucket of one tile is searched in `tile` (its keys in shared memory),
// the tiles of a larger one where they lie in skeys. EMIT: write the
// pairs from `out` up to `end` (a second walk, after a block scan of the
// counts; more pairs than join_count gave traps); else return the
// bucket's count (in every thread).
template <bool EMIT>
__device__ __forceinline__ int64_t join_bucket(
    const int64_t *skeys, const int32_t *spays, int64_t s_lo, int64_t s_n,
    const int64_t *tile, const int64_t *__restrict__ bkeys,
    const int32_t *__restrict__ bpays, int64_t b_lo, int64_t b_n,
    int64_t out, int64_t end, int64_t *__restrict__ pairs, int64_t *scan) {
  const bool one_tile = s_n <= kJoinTile;
  int64_t total = 0;
  for (int64_t r = 0; r < b_n; r += kJoinThreads) {  // the whole block
    const int64_t e = r + threadIdx.x;
    const bool in = e < b_n;
    const int64_t key = in ? bkeys[b_lo + e] : 0;
    const uint32_t pay = EMIT && in ? (uint32_t)bpays[b_lo + e] : 0u;
    int64_t cnt = 0, round = 0, at = 0;
    for (int walk = 0; walk < (EMIT ? 2 : 1); ++walk) {
      const bool emit = walk == 1;
      if (emit) {  // the round's pairs before this thread's
        round = block_sum(cnt, scan, &at);
        if (out + round > end) __trap();
        at += out;
      }
      if (!in) continue;
      if (one_tile) {
        cnt = walk_run(tile, (int)s_n, key, emit, spays, s_lo, pay, pairs,
                       &at);
      } else {
        cnt = 0;
        for (int64_t first = s_lo; first < s_lo + s_n; first += kJoinTile)
          cnt += walk_run(skeys + first,
                          (int)min((int64_t)kJoinTile, s_lo + s_n - first),
                          key, emit, spays, first, pay, pairs, &at);
      }
    }
    out += round;
    total += cnt;
  }
  return EMIT ? 0 : block_sum(total, scan, nullptr);
}

// The count pass: every tile of the small side's bucket b sorted in place
// (each once), then the bucket's pairs counted. The payloads move with
// their keys and are not otherwise read.
__global__ void __launch_bounds__(kJoinThreads)
    graft_join_count_kernel(int64_t *skeys, int32_t *spays,
                            const int64_t *__restrict__ s_ends,
                            const int64_t *__restrict__ bkeys,
                            const int64_t *__restrict__ b_ends,
                            int64_t *__restrict__ counts) {
  __shared__ SortTile t;
  __shared__ int64_t scan[kJoinWarps];
  const int64_t b = blockIdx.x;
  int64_t s_lo, s_n, b_lo, b_n;
  bucket_span(s_ends, b, &s_lo, &s_n);
  bucket_span(b_ends, b, &b_lo, &b_n);
  for (int64_t first = s_lo; first < s_lo + s_n; first += kJoinTile)
    sort_tile(skeys, spays, first,
              (int)min((int64_t)kJoinTile, s_lo + s_n - first), t);
  int64_t total = 0;
  if (s_n > 0 && b_n > 0)  // the whole block
    total = join_bucket<false>(skeys, nullptr, s_lo, s_n, t.key, bkeys,
                               nullptr, b_lo, b_n, 0, 0, nullptr, scan);
  if (threadIdx.x == 0) counts[b] = total;
}

// The emit pass, on the small side as the count pass left it
__global__ void __launch_bounds__(kJoinThreads)
    graft_join_emit_kernel(const int64_t *__restrict__ skeys,
                           const int32_t *__restrict__ spays,
                           const int64_t *__restrict__ s_ends,
                           const int64_t *__restrict__ bkeys,
                           const int32_t *__restrict__ bpays,
                           const int64_t *__restrict__ b_ends,
                           const int64_t *__restrict__ ends,
                           int64_t *__restrict__ pairs) {
  __shared__ int64_t tile[kJoinTile];
  __shared__ int64_t scan[kJoinWarps];
  const int64_t b = blockIdx.x;
  const int64_t out = b ? ends[b - 1] : 0;
  if (ends[b] == out) return;  // no pair: the whole block
  int64_t s_lo, s_n, b_lo, b_n;
  bucket_span(s_ends, b, &s_lo, &s_n);
  bucket_span(b_ends, b, &b_lo, &b_n);
  if (s_n <= kJoinTile) {
    for (int i = threadIdx.x; i < s_n; i += kJoinThreads)
      tile[i] = skeys[s_lo + i];
    __syncthreads();
  }
  join_bucket<true>(skeys, spays, s_lo, s_n, tile, bkeys, bpays, b_lo, b_n,
                    out, ends[b], pairs, scan);
}

// ---- verify ----

struct Variant {
  const uint32_t *src;  // the source row's words
  int32_t amp;
  int type;  // 0 substitution, 1 deletion, 2 insertion
  int pos;   // the edit's place in the variant
  uint32_t base;
  int len;   // the variant's length
};

// the variant of key `pay` of a side (its rows ids, ends = inclusive cumsum
// of their key counts)
__device__ Variant decode(const uint32_t *words, int64_t n_words,
                          const int64_t *row_word, const int32_t *lengths,
                          int64_t n, const int64_t *ids, const int64_t *ends,
                          int64_t rows, int64_t pay) {
  int64_t lo = 0, hi = rows;  // the first row whose end is past pay
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ends[mid] <= pay)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (pay < 0 || lo >= rows) __trap();
  Variant v;
  int len;
  v.amp = (int32_t)ids[lo];
  v.src = row_of(words, n_words, row_word, lengths, n, ids[lo], &len);
  const int64_t slot = pay - (lo ? ends[lo - 1] : 0);
  if (slot < 4) {  // insertion before position 0
    v.type = 2;
    v.pos = 0;
    v.base = (uint32_t)slot;
  } else if (slot < 4 + 6 * (int64_t)len) {
    const int p = (int)((slot - 4) / 6), j = (int)((slot - 4) % 6);
    const uint32_t k = j % 3;
    v.type = j < 3 ? 0 : 2;
    v.pos = j < 3 ? p : p + 1;
    v.base = k + (code_at(v.src, p) <= k);
  } else {  // the rank-th run start
    int rank = (int)(slot - 4 - 6 * (int64_t)len);
    v.type = 1;
    v.pos = -1;
    v.base = 0u;
    uint32_t prev = 0u;
    for (int w = 0; 16 * w < len; ++w) {
      uint32_t starts = run_starts(__ldg(v.src + w), w, len, &prev);
      const int c = __popc(starts);
      if (rank < c) {
        for (; rank > 0; --rank) starts &= starts - 1u;
        v.pos = 16 * w + (__ffs(starts) - 1) / 2;
        break;
      }
      rank -= c;
    }
    if (v.pos < 0) __trap();
  }
  v.len = len + (v.type == 1 ? -1 : v.type == 2 ? 1 : 0);
  return v;
}

__device__ __forceinline__ uint32_t variant_at(const Variant &v, int i) {
  if (v.type == 0) return i == v.pos ? v.base : code_at(v.src, i);
  if (v.type == 1) return code_at(v.src, i < v.pos ? i : i + 1);
  return i < v.pos ? code_at(v.src, i) : i == v.pos ? v.base
                                                     : code_at(v.src, i - 1);
}

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
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= n_pairs) return;
  const int64_t pr = pairs[t];
  const Variant a = decode(words, n_words, row_word, lengths, n, s_ids,
                           s_ends, s_rows, (int64_t)((uint64_t)pr >> 32));
  const Variant b = decode(words, n_words, row_word, lengths, n, b_ids,
                           b_ends, b_rows, pr & 0xFFFFFFFF);
  bool same = a.len == b.len;
  for (int i = 0; same && i < a.len; ++i)
    same = variant_at(a, i) == variant_at(b, i);
  ok[t] = same;
  if (same)
    atomicMin(best + (small_is_heavy ? b.amp : a.amp),
              small_is_heavy ? a.amp : b.amp);
}

inline unsigned grid_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for words that are not 16-byte
// aligned or a Zobrist table that is not 8-byte aligned). Nothing is
// launched for an empty input.

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

extern "C" int swarm_graft_keygen_emit(const void *words, int64_t n_words,
                                       const void *row_word,
                                       const void *lengths, int64_t n,
                                       const void *ids, int64_t m,
                                       const void *zob, int64_t z_rows,
                                       const void *ends, void *keys,
                                       void *pays, void *stream) {
  if ((uintptr_t)words % 16 || (uintptr_t)zob % 8)
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  graft_emit_kernel<<<grid_for(32 * m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words, n_words, (const int64_t *)row_word,
      (const int32_t *)lengths, n, (const int64_t *)ids, m,
      (const uint2 *)zob, z_rows, (const int64_t *)ends, (int64_t *)keys,
      (int32_t *)pays);
  return (int)cudaGetLastError();
}

extern "C" int swarm_graft_join_count(void *skeys, void *spays,
                                      const void *s_ends, const void *bkeys,
                                      const void *b_ends, int64_t n_buckets,
                                      void *counts, void *stream) {
  if (n_buckets <= 0) return 0;
  graft_join_count_kernel<<<(unsigned)n_buckets, kJoinThreads, 0,
                            (cudaStream_t)stream>>>(
      (int64_t *)skeys, (int32_t *)spays, (const int64_t *)s_ends,
      (const int64_t *)bkeys, (const int64_t *)b_ends, (int64_t *)counts);
  return (int)cudaGetLastError();
}

extern "C" int swarm_graft_join_emit(const void *skeys, const void *spays,
                                     const void *s_ends, const void *bkeys,
                                     const void *bpays, const void *b_ends,
                                     int64_t n_buckets, const void *ends,
                                     void *pairs, void *stream) {
  if (n_buckets <= 0) return 0;
  graft_join_emit_kernel<<<(unsigned)n_buckets, kJoinThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int64_t *)skeys, (const int32_t *)spays, (const int64_t *)s_ends,
      (const int64_t *)bkeys, (const int32_t *)bpays, (const int64_t *)b_ends,
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
  graft_verify_kernel<<<grid_for(n_pairs), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t *)words, n_words, (const int64_t *)row_word,
      (const int32_t *)lengths, n, (const int64_t *)s_ids,
      (const int64_t *)s_ends, s_rows, (const int64_t *)b_ids,
      (const int64_t *)b_ends, b_rows, (const int64_t *)pairs, n_pairs,
      small_is_heavy, (bool *)ok, (int32_t *)best);
  return (int)cudaGetLastError();
}
