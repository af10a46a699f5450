// The d>=2 network engine's directed CSR: the accepted diff tasks
// stably partitioned by source.
//
// Replaces no TPU kernel: the JAX engine builds its CSR on the host with
// np.lexsort (swarm_tpu/ops/d2_network.py:490), as the port did before.
// Added because that sort was 40-50% of a d = 2 or 3 run at 300k-500k
// amplicons while the tasks and their diffs already lay on the card
// (ops/d2_diffs.py: DeviceDiffEngine.diff_tasks). Where the native host
// diffs ran, the same partition runs on the host by its plain version
// (ops/d2_network.py: csr_partition_reference).
//
// No sort is needed, only a stable partition. The screen emits the pairs
// (pa, pb), pa < pb, in (tile step, row, column) order, steps I ascending,
// then J. So the forward tasks (source pa, target pb) of one source come
// with ascending targets (row a's steps (I_a, J) in J order, its columns
// ascending in each), and so do the reverse tasks (source pb, target pa)
// of one source (column b's steps (I, J_b) in I order, rows ascending in
// each); a source's reverse targets all lie below it, its forward targets
// above it. The tasks are laid out reverse block first, so a stable
// partition of the accepted tasks by source is exactly the CSR that a
// sort by (source, target) gives. That rests on the screen's order, so
// the last kernel checks it: every target strictly above the one before
// it in its source's segment, every source in [0, n) (and, in the first
// pass, every target, and every kept diff at most 255, its byte). A
// violation sets a flag that the wrapper reads back with the CSR, and the
// engine raises: a change to that order fails loudly, not as wrong
// clusters.
//
// Design: an LSD radix partition on the source id itself (no hash: the
// digits of a source id are already uniform enough, and the result must
// be ordered by source), passes of at most 8 bits (19 bits at 500k
// amplicons: passes of 7, 6 and 6), each reduce-then-scan as
// d1_partition in d1_join.cu: the count kernel writes each tile's digit
// histogram (shared-memory atomics) digit-major, one torch.cumsum gives
// every (digit, tile) its end, and the scatter kernel ranks its tile
// stably (warp, chunk, then lane order; the lanes of equal digits by one
// ballot a digit bit), stages it in shared memory by digit and stores
// each digit's run to consecutive addresses. The first pass reads the
// diff engine's int64 tasks and int32 diffs and drops the rejected ones
// (diff < 0): a rejected task takes no slot, so the compaction costs no
// pass of its own. Later passes move 9 bytes a task (int32 source and
// target, the diff as a byte). The finish kernel checks the order and
// finds each source's first task by a binary search of the partitioned
// sources (starts[s] = the tasks with a source below s, s = 0..n), so
// that adj_count is starts' difference.
//
// What bounds it: bytes. The function needs 20 a task read (int64
// source and target, int32 diff) and 5 a kept task written: 0.86 GB,
// 0.26 ms at 3.35 TB/s, at 3.4e7 tasks. By this file's design the
// passes move more (a count of the loads and stores as written, not a
// measurement): at three, the first pass' count reads 12 a task and its
// scatter 20 and writes 9, each later pass reads 4 + 9 and writes 9, the
// finish reads 8: ~93 bytes a task, 3.2 GB. On an H100 (PERF.md §6, row
// 12) the partition takes 2.2 ms there, against 4.3 ms for torch.sort
// of the (source, target) keys alone.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                     // chunks of 32 a warp
constexpr int kTile = kThreads * kItems;       // tasks a tile
constexpr int kMaxDigitBits = 8;
constexpr int kMaxRadix = 1 << kMaxDigitBits;
constexpr size_t kScatterSmem =
    (size_t)kTile * (4 + 4 + 1) + (size_t)(kWarps + 2) * kMaxRadix * 4 + 16;

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// the lanes holding this lane's digit d (d < 0: no task), by one ballot
// a digit bit
__device__ __forceinline__ unsigned digit_peers(int d, int dbits) {
  unsigned peers = __ballot_sync(kFull, d >= 0);
  for (int b = 0; b < dbits; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned bal = __ballot_sync(kFull, bit);
    peers &= bit ? bal : ~bal;
  }
  return peers;
}

__device__ __forceinline__ int digit_of(int32_t source, int shift, int radix) {
  return (int)(((uint32_t)source >> shift) & (uint32_t)(radix - 1));
}

// task i: false where it is rejected (first pass: diff < 0). The first
// pass reads the diff engine's int64 tasks and int32 diffs, later passes
// the int32 sources and targets and byte diffs of the pass before.
template <bool kFirst>
__device__ __forceinline__ bool load_task(const void *src, const void *dst,
                                          const void *diff, int64_t i,
                                          int64_t n, int32_t *s, int32_t *t,
                                          uint32_t *df, bool *bad) {
  if (kFirst) {
    const int32_t v = ((const int32_t *)diff)[i];
    if (v < 0) return false;
    const int64_t s64 = ((const int64_t *)src)[i];
    const int64_t t64 = ((const int64_t *)dst)[i];
    if (s64 < 0 || s64 >= n || t64 < 0 || t64 >= n || v > 255) *bad = true;
    *s = (int32_t)s64;
    *t = (int32_t)t64;
    *df = (uint32_t)v & 255u;
  } else {
    *s = ((const int32_t *)src)[i];
    *t = ((const int32_t *)dst)[i];
    *df = ((const uint8_t *)diff)[i];
  }
  return true;
}

template <bool kFirst>
__device__ __forceinline__ bool load_source(const void *src, const void *diff,
                                            int64_t i, int32_t *s) {
  if (kFirst) {
    if (((const int32_t *)diff)[i] < 0) return false;
    *s = (int32_t)((const int64_t *)src)[i];
  } else {
    *s = ((const int32_t *)src)[i];
  }
  return true;
}

// counts[d * n_tiles + tile] = the tile's kept tasks of digit d
template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
    d2_csr_count_kernel(const void *__restrict__ src,
                        const void *__restrict__ diff, int64_t m, int shift,
                        int dbits, int n_tiles, int32_t *__restrict__ counts) {
  __shared__ int32_t hist[kMaxRadix];
  const int radix = 1 << dbits;
  for (int d = threadIdx.x; d < radix; d += kThreads) hist[d] = 0;
  __syncthreads();
  const int64_t first = (int64_t)blockIdx.x * kTile;
  const int n_here = (int)min((int64_t)kTile, m - first);
  for (int e = threadIdx.x; e < n_here; e += kThreads) {
    int32_t s;
    if (load_source<kFirst>(src, diff, first + e, &s))
      atomicAdd(&hist[digit_of(s, shift, radix)], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kThreads)
    counts[(int64_t)d * n_tiles + blockIdx.x] = hist[d];
}

// One tile a block: the tile's kept tasks staged in shared memory by
// digit (stable), then stored as one run of consecutive addresses a
// digit from its offset. `ends` is the inclusive cumsum of the count
// kernel's counts, digit-major, so a tile's digit d starts at its end
// less the tile's own count.
template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
    d2_csr_scatter_kernel(const void *__restrict__ src,
                          const void *__restrict__ dst,
                          const void *__restrict__ diff, int64_t m, int64_t n,
                          int shift, int dbits, int n_tiles,
                          const int32_t *__restrict__ ends,
                          int32_t *__restrict__ src_out,
                          int32_t *__restrict__ dst_out,
                          uint8_t *__restrict__ diff_out,
                          int32_t *__restrict__ bad) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t *ssrc = (int32_t *)smem;
  int32_t *sdst = ssrc + kTile;
  int32_t *whist = sdst + kTile;  // [warp][digit]
  int32_t *tstart = whist + kWarps * kMaxRadix;
  int32_t *gbase = tstart + kMaxRadix;
  int32_t *kept = gbase + kMaxRadix;
  uint8_t *sdiff = (uint8_t *)(kept + 4);
  const int radix = 1 << dbits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t first = (int64_t)blockIdx.x * kTile;
  const int n_here = (int)min((int64_t)kTile, m - first);
  for (int t = threadIdx.x; t < kWarps * kMaxRadix; t += kThreads)
    whist[t] = 0;
  __syncthreads();

  // warp w holds the w-th span of kItems chunks of 32 consecutive tasks,
  // so warp, chunk and lane order is the tasks' order
  int32_t s[kItems], t[kItems];
  uint32_t df[kItems];
  int dig[kItems];
  unsigned peers[kItems];
  bool out_of_range = false;
  int32_t *mine = whist + warp * kMaxRadix;
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int e = (warp * kItems + c) * 32 + lane;
    s[c] = t[c] = 0;
    df[c] = 0u;
    const bool in = e < n_here &&
                    load_task<kFirst>(src, dst, diff, first + e, n, &s[c],
                                      &t[c], &df[c], &out_of_range);
    dig[c] = in ? digit_of(s[c], shift, radix) : -1;
  }
  if (out_of_range) atomicOr(bad, 1);
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    peers[c] = digit_peers(dig[c], dbits);
    if (dig[c] >= 0 && (peers[c] & below) == 0)
      mine[dig[c]] += __popc(peers[c]);
    __syncwarp();
  }
  __syncthreads();

  // per digit: the warps' exclusive prefix, the tile's count, and where
  // the tile's run of the digit starts in the output
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
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
    if (lane == 31) *kept = run;  // the tile's kept tasks
  }
  __syncthreads();

  // each task's place in the tile: its digit's start, the earlier warps'
  // and chunks' tasks of the digit, its rank among its peers
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int base = dig[c] >= 0 ? mine[dig[c]] : 0;
    __syncwarp();
    if (dig[c] >= 0) {
      const int at = tstart[dig[c]] + base + __popc(peers[c] & below);
      ssrc[at] = s[c];
      sdst[at] = t[c];
      sdiff[at] = (uint8_t)df[c];
      if ((peers[c] & below) == 0) mine[dig[c]] = base + __popc(peers[c]);
    }
    __syncwarp();
  }
  __syncthreads();

  const int n_kept = *kept;
  for (int e = threadIdx.x; e < n_kept; e += kThreads) {
    const int32_t v = ssrc[e];
    const int d = digit_of(v, shift, radix);
    const int64_t at = (int64_t)gbase[d] + (e - tstart[d]);
    src_out[at] = v;
    dst_out[at] = sdst[e];
    diff_out[at] = sdiff[e];
  }
}

// The partitioned tasks: bad |= 1 where a source lies outside [0, n) or
// a task does not follow the one before it by (source, target) strictly
// ascending; starts[s] (s = 0..n) = the tasks with a source below s.
__global__ void __launch_bounds__(kThreads)
    d2_csr_finish_kernel(const int32_t *__restrict__ src,
                         const int32_t *__restrict__ dst, int64_t m,
                         int64_t n, int32_t *__restrict__ starts,
                         int32_t *__restrict__ bad) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < m) {
    const int32_t s = src[i];
    bool ok = s >= 0 && s < n;
    if (i > 0) {
      const int32_t ps = src[i - 1];
      ok = ok && (ps < s || (ps == s && dst[i - 1] < dst[i]));
    }
    if (!ok) atomicOr(bad, 1);
  }
  if (i <= n) {
    int64_t lo = 0, hi = m;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (src[mid] < i)
        lo = mid + 1;
      else
        hi = mid;
    }
    starts[i] = (int32_t)lo;
  }
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a digit it does not take).
// Nothing is launched for no tasks. `first` selects the first pass'
// input: int64 sources and targets and int32 diffs (-1: rejected);
// otherwise int32 sources and targets and byte diffs, all kept.

extern "C" int swarm_d2_csr_tile() { return kTile; }

extern "C" int swarm_d2_csr_count(const void *src, const void *diff,
                                  int64_t m, int first, int shift, int dbits,
                                  void *counts, void *stream) {
  if (dbits < 1 || dbits > kMaxDigitBits) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  const int n_tiles = (int)((m + kTile - 1) / kTile);
  if (first)
    d2_csr_count_kernel<true><<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        src, diff, m, shift, dbits, n_tiles, (int32_t *)counts);
  else
    d2_csr_count_kernel<false><<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        src, diff, m, shift, dbits, n_tiles, (int32_t *)counts);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d2_csr_scatter(const void *src, const void *dst,
                                    const void *diff, int64_t m, int64_t n,
                                    int first, int shift, int dbits,
                                    const void *ends, void *src_out,
                                    void *dst_out, void *diff_out, void *bad,
                                    void *stream) {
  if (dbits < 1 || dbits > kMaxDigitBits) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  auto kernel =
      first ? d2_csr_scatter_kernel<true> : d2_csr_scatter_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kScatterSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (int)((m + kTile - 1) / kTile);
  kernel<<<n_tiles, kThreads, kScatterSmem, (cudaStream_t)stream>>>(
      src, dst, diff, m, n, shift, dbits, n_tiles, (const int32_t *)ends,
      (int32_t *)src_out, (int32_t *)dst_out, (uint8_t *)diff_out,
      (int32_t *)bad);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d2_csr_finish(const void *src, const void *dst,
                                   int64_t m, int64_t n, void *starts,
                                   void *bad, void *stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const int64_t threads = m > n + 1 ? m : n + 1;
  d2_csr_finish_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                         kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t *)src, (const int32_t *)dst, m, n, (int32_t *)starts,
      (int32_t *)bad);
  return (int)cudaGetLastError();
}
