// d=1 network by one global sort-join over ragged rows: count and pack,
// keygen, equal-key join, exact distance-1 verify.
//
// Replaces the XLA programs of swarm_tpu/ops/neighbors_sortjoin.py (the
// d=1 path had no Pallas source):
//   deletion_keys_poly (:142), and the
//   width-bucketed network_pairs_bucketed (:962) -> d1_count_pack_kernel,
//                                                  d1_keygen_kernel
//                                                  (swarm_d1_keygen_*)
//   join_pairs (:416)                  -> d1_join_kernel   (swarm_d1_join_*)
//   _verify_dist1_packed (:337), in
//   verify_pairs_compact (:282)        -> d1_verify_kernel (swarm_d1_verify)
// Plain PyTorch versions and the wrappers: swarm_tpu_torch/ops/
// neighbors_sortjoin.py. Between keygen and join the keys are sorted by
// torch.sort (CUB radix sort); the candidates are deduplicated by one
// more torch.sort and torch.unique_consecutive before the verify.
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
// their owner (the row), compacted, in row order and slot order, so the
// sort takes about 114 keys a row of 150 nt and no sentinel. What bounds
// it: bytes (at 1M rows of 150 nt it reads 48 MB of words and writes
// 1.37 GB of keys and owners, against ~20 integer operations a base).
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
// Join. After the sort, equal 64-bit keys are adjacent. Each element at
// depth k of its run looks back at its k predecessors and emits (min
// owner, max owner), packed as (min << 32) | max, for each predecessor
// with another owner (two slots of one run share an owner only by a
// hash collision). The count pass writes each element's number of
// pairs, torch.cumsum places them, the emit pass writes them, element
// after element, predecessors from the nearest back. Exact for any run
// length: no window, no cap. What bounds it: bytes (12 bytes read an
// element, 8 written a pair); the looks back are reads of the
// neighbouring elements, which the same warp has just read.
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

// EMIT false: counts[i] = the pairs element i makes with its run's
// earlier elements. EMIT true: those pairs from ends[i - 1].
template <bool EMIT>
__global__ void __launch_bounds__(kThreads)
    d1_join_kernel(const int64_t *__restrict__ keys,
                   const int32_t *__restrict__ owners, int64_t m,
                   int32_t *__restrict__ counts,
                   const int64_t *__restrict__ ends,
                   int64_t *__restrict__ pairs) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t key = keys[i];
  const int32_t own = owners[i];
  int64_t out = 0;
  if (EMIT) out = i ? ends[i - 1] : 0;
  int32_t cnt = 0;
  for (int64_t j = i - 1; j >= 0 && keys[j] == key; --j) {
    const int32_t other = owners[j];
    if (other == own) continue;
    if (EMIT) {
      const int32_t a = min(own, other), b = max(own, other);
      pairs[out++] = ((int64_t)a << 32) | (uint32_t)b;
    } else {
      ++cnt;
    }
  }
  if (!EMIT) counts[i] = cnt;
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

extern "C" int swarm_d1_join_count(const void *keys, const void *owners,
                                   int64_t m, void *counts, void *stream) {
  if (m <= 0) return 0;
  d1_join_kernel<false><<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t *)keys, (const int32_t *)owners, m, (int32_t *)counts,
      nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d1_join_emit(const void *keys, const void *owners,
                                  int64_t m, const void *ends, void *pairs,
                                  void *stream) {
  if (m <= 0) return 0;
  d1_join_kernel<true><<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t *)keys, (const int32_t *)owners, m, nullptr,
      (const int64_t *)ends, (int64_t *)pairs);
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
