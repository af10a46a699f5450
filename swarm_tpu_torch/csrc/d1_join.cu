// d=1 network by one global sort-join: keygen, equal-key join, exact
// distance-1 verify.
//
// Replaces the XLA programs of swarm_tpu/ops/neighbors_sortjoin.py (the
// d=1 path had no Pallas source):
//   deletion_keys_poly (:142)          -> d1_keygen_kernel (swarm_d1_keygen_*)
//   join_pairs (:416)                  -> d1_join_kernel   (swarm_d1_join_*)
//   _verify_dist1_packed (:337), in
//   verify_pairs_compact (:282)        -> d1_verify_kernel (swarm_d1_verify)
// Plain PyTorch versions and the wrappers: swarm_tpu_torch/ops/
// neighbors_sortjoin.py. Between keygen and join the keys are sorted by
// torch.sort (CUB radix sort); the candidates are deduplicated by one
// more torch.sort and torch.unique_consecutive before the verify.
//
// Rows are 2-bit packed (pack2bit: base j at bits 2 * (j % 16) of word
// j / 16, zero past the length), row_words words a row, row_words a
// multiple of 4 so that the verify reads a row 16 bytes at a time.
//
// Keygen. A row x of length L has the keys h(x) (slot 0, when L > 0) and
// h(del_p(x)) for every run start p < L, where h is the pair of
// polynomial hashes h_r(x) = sum_q (x_q + 1) r^q mod 2^32 for the two r
// of _POLY_R, held as one 64-bit key (h_0 << 32) | h_1. Deleting p
// shifts the suffix down one power: h_r(del_p(x)) = pre_p + rinv * (tot
// - pre_p - (x_p + 1) r^p), pre_p the sum of the terms before p. Two
// passes of one kernel: the count pass writes each row's number of
// keys; after torch.cumsum the emit pass writes the keys and their
// owner (the row), compacted, in row order and slot order, so the sort
// takes about 114 keys a row of 150 nt and no sentinel. What bounds it:
// bytes. At 1M rows of 150 nt it reads 48 MB and writes 1.37 GB of keys
// and owners, against ~20 integer operations a base. Design: one warp a
// row, lane = position in a chunk of 32 positions, each lane with its
// power r^lane and the chunk's r^base carried by one multiply by r^32.
// The emit pass first sums the row's terms (a shuffle reduction a
// chunk), then walks the chunks again: a shuffle scan of each half
// gives every lane its prefix, one shuffle the code before it (run
// starts), a ballot the place of its key among the chunk's, so that a
// chunk's keys go out as one coalesced store. One thread a row, the
// first version, took 13.2 ms at d1_1m (31 times the bound): its stores
// were not coalesced, a warp's store touching 32 rows' runs of keys.
// The count pass runs the same walk without the hashes, so its count is
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
// uint4. Equal lengths: XOR, one popcount of (x | x >> 1) & 0x55555555 a
// word, distance 1 iff exactly one field differs (the zero padding
// agrees). Lengths L + 1 (x) and L (y): one pass over the fields below
// L finds the first field f where x and y differ and the last field g
// where x shifted down one field (__funnelshift_r) differs from y; y is
// x less one base iff g < f (delete x_f: the prefix before f agrees,
// the shifted suffix from f on agrees). Any other lengths: not a pair.
// What bounds it: bytes, the two rows of a pair.

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

// One warp a row, lane = position in a chunk of 32. EMIT false:
// counts[row] = the row's number of keys. EMIT true: its keys and owners
// from ends[row - 1] (ends = inclusive cumsum of the counts).
template <bool EMIT>
__global__ void __launch_bounds__(kThreads)
    d1_keygen_kernel(const uint32_t *__restrict__ packed, int64_t row_words,
                     const int32_t *__restrict__ lengths, int64_t n,
                     int32_t *__restrict__ counts,
                     const int64_t *__restrict__ ends,
                     int64_t *__restrict__ keys,
                     int32_t *__restrict__ owners) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (row >= n) return;  // the whole warp: a warp holds one row
  const int len = lengths[row];
  const uint32_t *src = packed + row * row_words;
  uint32_t r32_0, r32_1;
  const uint32_t pl0 = lane_power(kR0, lane, &r32_0);
  const uint32_t pl1 = lane_power(kR1, lane, &r32_1);

  // pass 1 (EMIT): the row's hashes, tot = sum of (code + 1) r^p
  uint32_t t0 = 0, t1 = 0;
  if (EMIT) {
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
  // last of the chunk before), compacted by a ballot; with EMIT the
  // deletion keys from the exclusive prefix sums of the terms
  int64_t out = 0;
  if (EMIT) {
    out = row ? ends[row - 1] : 0;
    if (len > 0 && lane == 0) {
      keys[out] = make_key(t0, t1);
      owners[out] = (int32_t)row;
    }
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
    if (EMIT) {
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
    }
    out += __popc(starts);
    before_chunk = __shfl_sync(kFull, code, 31);
  }
  if (!EMIT && lane == 0) counts[row] = (int32_t)out;
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
    d1_verify_kernel(const uint4 *__restrict__ packed, int64_t row_vecs,
                     const int32_t *__restrict__ lengths,
                     const int64_t *__restrict__ pairs, int64_t n_pairs,
                     bool *__restrict__ ok) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= n_pairs) return;
  const int64_t pr = pairs[t];
  const int64_t a = pr >> 32, b = pr & 0xFFFFFFFF;
  const int la = lengths[a], lb = lengths[b];
  bool res = false;
  if (la == lb) {
    const uint4 *xa = packed + a * row_vecs, *xb = packed + b * row_vecs;
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
    const uint4 *x = packed + (la > lb ? a : b) * row_vecs;  // longer
    const uint4 *y = packed + (la > lb ? b : a) * row_vecs;
    const int ly = min(la, lb);
    int f = ly;   // first field where x and y differ
    int g = -1;   // last field where x shifted down one field and y differ
    uint4 xv = __ldg(x);
    for (int v = 0; v * 64 < ly; ++v) {
      const uint4 yv = __ldg(y + v);
      const uint4 xn = v + 1 < row_vecs ? __ldg(x + v + 1)
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
// after the launch (cudaErrorInvalidValue for rows that are not whole
// uint4s or not 16-byte aligned). Nothing is launched for an empty input.

extern "C" int swarm_d1_keygen_count(const void *packed, int64_t row_words,
                                     const void *lengths, int64_t n,
                                     void *counts, void *stream) {
  if (row_words <= 0 || row_words % 4 || (uintptr_t)packed % 16)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  d1_keygen_kernel<false><<<grid_for(32 * n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t *)packed, row_words, (const int32_t *)lengths, n,
      (int32_t *)counts, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d1_keygen_emit(const void *packed, int64_t row_words,
                                    const void *lengths, int64_t n,
                                    const void *ends, void *keys,
                                    void *owners, void *stream) {
  if (row_words <= 0 || row_words % 4 || (uintptr_t)packed % 16)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  d1_keygen_kernel<true><<<grid_for(32 * n), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t *)packed, row_words, (const int32_t *)lengths, n,
      nullptr, (const int64_t *)ends, (int64_t *)keys, (int32_t *)owners);
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

extern "C" int swarm_d1_verify(const void *packed, int64_t row_words,
                               const void *lengths, const void *pairs,
                               int64_t n_pairs, void *ok, void *stream) {
  if (row_words <= 0 || row_words % 4 || (uintptr_t)packed % 16)
    return (int)cudaErrorInvalidValue;
  if (n_pairs <= 0) return 0;
  d1_verify_kernel<<<grid_for(n_pairs), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4 *)packed, row_words / 4, (const int32_t *)lengths,
      (const int64_t *)pairs, n_pairs, (bool *)ok);
  return (int)cudaGetLastError();
}
