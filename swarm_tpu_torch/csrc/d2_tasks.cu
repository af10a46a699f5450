// The d>=2 network engine's directed diff tasks, laid out on the card from
// the screen's pairs.
//
// Replaces no TPU kernel: the JAX engine lays its tasks out on the host in
// numpy (swarm_tpu/ops/d2_diffs_jax.py:209-212), as the port did before
// (ops/d2_diffs.py: directions, task_layout). Added because that host
// work, with the pairs' copy to the host before it and the tasks' copy up
// from pageable memory after it, took 27-40% of a d = 2 or 3 run on an
// H100 at 300k-500k amplicons while the pairs already lay on the card (the
// screen's extraction writes them there). The native host diffs keep the
// host's layout; the plain version, which the CPU takes, is
// ops/d2_network.py: tasks_reference.
//
// The function: the pairs (a, b), a < b, in the screen's (step, row,
// column) order; a pair gives the reverse task (b, a) where ab[b] >= ab[a]
// and the forward task (a, b) where ab[a] >= ab[b], both under no_break.
// The tasks are laid out reverse block first, each block stable in pair
// order: the order that d2_csr.cu's partition rests on.
//
// Design: a stable compaction into two blocks, reduce-then-scan as
// d2_csr's first pass. The count kernel writes each tile's reverse and
// forward task counts and a flag, block-major [reverse | forward | flag];
// the flag is set where a pair index lies outside [0, n) or a >= b, and
// such a pair reads no abundance and takes no direction. One torch.cumsum
// gives every tile its end in each block, and one readback the tasks'
// count and the flags'; the wrapper raises nothing itself, it hands the
// flag to the engine, which raises before the exact diffs launch. Where
// nothing is flagged, the emit kernel recomputes each pair's directions,
// ranks its tile stably (warp, chunk, then lane order; one ballot a
// direction) and stores each block's tasks to consecutive addresses from
// the tile's offset, int64 as the diffs kernel and the CSR take them.
//
// What bounds it: bytes. The function needs the pairs read once (8 bytes
// a pair), the abundances once (8 an amplicon) and the tasks written once
// (16 a task): 0.70 GB, 0.21 ms at 3.35 TB/s, at the d = 2 cell's 2.0e7
// pairs and 3.4e7 tasks. By this design each of the two passes reads a
// pair and gathers its two abundances (24 bytes a pair, the gathers from
// L2: 4 MB of abundances at 500k amplicons), and the emit writes 16 bytes
// a task: ~1.5 GB, ~0.45 ms.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // chunks of 32 pairs a warp
constexpr int kTile = kThreads * kItems;   // pairs a tile

// pair i's directions: bit 0 the reverse task (b, a), bit 1 the forward
// task (a, b); -1 where a pair index lies outside [0, n) or a >= b, with
// no abundance read
__device__ __forceinline__ int pair_directions(
    const int32_t *__restrict__ ga, const int32_t *__restrict__ gb,
    const int64_t *__restrict__ ab, int64_t i, int64_t n, int no_break,
    int32_t *a, int32_t *b) {
  *a = ga[i];
  *b = gb[i];
  if (*a < 0 || *a >= *b || *b >= n) return -1;
  if (no_break) return 3;
  const int64_t x = ab[*a], y = ab[*b];
  return (y >= x ? 1 : 0) | (x >= y ? 2 : 0);
}

// counts[tile], counts[n_tiles + tile]: the tile's reverse and forward
// tasks; counts[2 n_tiles + tile]: 1 where the tile holds a flagged pair
__global__ void __launch_bounds__(kThreads)
    d2_tasks_count_kernel(const int32_t *__restrict__ ga,
                          const int32_t *__restrict__ gb,
                          const int64_t *__restrict__ ab, int64_t m,
                          int64_t n, int no_break, int n_tiles,
                          int32_t *__restrict__ counts) {
  __shared__ int32_t sums[3];
  if (threadIdx.x < 3) sums[threadIdx.x] = 0;
  __syncthreads();
  const int64_t first = (int64_t)blockIdx.x * kTile;
  const int n_here = (int)min((int64_t)kTile, m - first);
  int rev = 0, fwd = 0;
  unsigned bad = 0u;
  for (int e = threadIdx.x; e < n_here; e += kThreads) {
    int32_t a, b;
    const int dir = pair_directions(ga, gb, ab, first + e, n, no_break, &a,
                                    &b);
    if (dir < 0) {
      bad = 1u;
    } else {
      rev += dir & 1;
      fwd += dir >> 1;
    }
  }
  rev = __reduce_add_sync(kFull, rev);
  fwd = __reduce_add_sync(kFull, fwd);
  bad = __reduce_or_sync(kFull, bad);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&sums[0], rev);
    atomicAdd(&sums[1], fwd);
    if (bad) atomicOr(&sums[2], 1);
  }
  __syncthreads();
  if (threadIdx.x < 3)
    counts[(int64_t)threadIdx.x * n_tiles + blockIdx.x] = sums[threadIdx.x];
}

// One tile a block. `ends` is the inclusive int64 cumsum of the count
// kernel's counts, so the tile's reverse tasks end at ends[tile] and its
// forward tasks at ends[n_tiles + tile] (past every reverse task).
__global__ void __launch_bounds__(kThreads)
    d2_tasks_emit_kernel(const int32_t *__restrict__ ga,
                         const int32_t *__restrict__ gb,
                         const int64_t *__restrict__ ab, int64_t m,
                         int64_t n, int no_break, int n_tiles,
                         const int64_t *__restrict__ ends,
                         int64_t *__restrict__ tq, int64_t *__restrict__ td) {
  __shared__ int32_t wrev[kWarps], wfwd[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t first = (int64_t)blockIdx.x * kTile;
  const int n_here = (int)min((int64_t)kTile, m - first);

  // warp w holds the w-th span of kItems chunks of 32 consecutive pairs,
  // so warp, chunk and lane order is the pairs' order
  int32_t a[kItems], b[kItems];
  unsigned rball[kItems], fball[kItems];
  int nrev = 0, nfwd = 0;
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int e = (warp * kItems + c) * 32 + lane;
    int dir = 0;
    a[c] = b[c] = 0;
    if (e < n_here)
      dir = max(pair_directions(ga, gb, ab, first + e, n, no_break, &a[c],
                                &b[c]),
                0);
    rball[c] = __ballot_sync(kFull, dir & 1);
    fball[c] = __ballot_sync(kFull, dir & 2);
    nrev += __popc(rball[c]);
    nfwd += __popc(fball[c]);
  }
  if (lane == 0) {
    wrev[warp] = nrev;
    wfwd[warp] = nfwd;
  }
  __syncthreads();

  // the tile's first task of each block, then the earlier warps' tasks
  int64_t rat = ends[blockIdx.x], fat = ends[(int64_t)n_tiles + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) {
    if (w >= warp) {
      rat -= wrev[w];
      fat -= wfwd[w];
    }
  }
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    if ((rball[c] >> lane) & 1u) {
      const int64_t at = rat + __popc(rball[c] & below);
      tq[at] = b[c];
      td[at] = a[c];
    }
    if ((fball[c] >> lane) & 1u) {
      const int64_t at = fat + __popc(fball[c] & below);
      tq[at] = a[c];
      td[at] = b[c];
    }
    rat += __popc(rball[c]);
    fat += __popc(fball[c]);
  }
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// after the launch; nothing is launched for no pairs. `m` pairs (ga, gb)
// int32, abundances `ab` int64 [n].

extern "C" int swarm_d2_tasks_tile() { return kTile; }

extern "C" int swarm_d2_tasks_count(const void *ga, const void *gb,
                                    const void *ab, int64_t m, int64_t n,
                                    int no_break, void *counts,
                                    void *stream) {
  if (m <= 0) return 0;
  const int n_tiles = (int)((m + kTile - 1) / kTile);
  d2_tasks_count_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t *)ga, (const int32_t *)gb, (const int64_t *)ab, m, n,
      no_break, n_tiles, (int32_t *)counts);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d2_tasks_emit(const void *ga, const void *gb,
                                   const void *ab, int64_t m, int64_t n,
                                   int no_break, const void *ends, void *tq,
                                   void *td, void *stream) {
  if (m <= 0) return 0;
  const int n_tiles = (int)((m + kTile - 1) / kTile);
  d2_tasks_emit_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t *)ga, (const int32_t *)gb, (const int64_t *)ab, m, n,
      no_break, n_tiles, (const int64_t *)ends, (int64_t *)tq,
      (int64_t *)td);
  return (int)cudaGetLastError();
}
