// Cost-only global alignment scores of one seed against many targets.
//
// Replaces the two TPU kernels of swarm_tpu/ops/pallas_nw.py:
//   make_banded_scores_pallas_band  -> nw_band_kernel (swarm_nw_banded_scores)
//   make_banded_scores_pallas       -> nw_full_kernel (swarm_nw_full_scores)
// Cost model of swarm_tpu/ops/search.py (src/search8.cc): Q = go + ge,
// R = ge, boundaries H[-1][i] = Q + iR, E init 2Q + iR, F row boundary
// 2go + (row+2)ge, diagonal boundary 0 at row 0 else go + row*ge.
//
// Both kernels take the resident [n, stride] code matrix, the lengths,
// one seed id and a list of target ids, and read the rows in place. The
// seed's row is the query of every pair of a launch.
//
// Band kernel. Contract of banded_scores_reference
// (swarm_tpu_torch/ops/nw_scores.py): the DP restricted to the 2B+1
// slots |i - row| <= B; exact wherever the true cost is at most the
// cutoff B was chosen for, above the cutoff elsewhere, INF when the
// final cell is outside the band. Design: one thread owns one pair and
// keeps the band (H, E per slot) in registers when B is a template
// constant (B <= 20); wider bands (up to 63) take one variant with the
// band in local memory. Each block stages the seed's row once in shared
// memory. F is a sequential min along the slots, and a pair stops at
// its own last target row. Bound: integer ALU work, about 12 int32 ops
// per cell over sum(tlen) * (2B+1) cells; a launch of a few thousand
// pairs fills only a few warps per SM, so it is latency that sets its
// time, not throughput.
//
// Full-row kernel. Bit-identical to ops/search.py for every pair. What
// bounds it on the card: a launch is a few thousand pairs of ~400 x 400
// cells, less than one wave of warps, so a pair's chain of dependent
// steps sets the time unless each step carries much independent work
// and little communication. Design: a skewed wavefront in registers.
// One warp owns one pair at a time and walks over the list's pairs.
// Lane l owns a strip of C consecutive query columns (C a template
// constant, 32 * C >= the row width), with the strip's H, E and query
// codes in registers. At step t lane l computes target row t - l over
// its strip, left to right, so F is a plain carried register updated
// by one DPX add-min (__viaddmin_s32): the sequential recurrence of
// ops/search.py itself, no prefix scan. After a step a lane hands its
// last column's new H and its F to lane l + 1: two shuffles per 32 * C
// cells, plus two that pass the target's codes (loaded 32 at a time,
// coalesced) down the lanes. A pair takes tlen + 31 steps, no shared
// memory, and the lane that owns column qlen - 1 reads the score at
// its step for row tlen - 1. Columns right of the query compute values
// nothing reads (dependencies run rightwards only). A row wider than
// 32 * 32 columns takes several passes of 1,024 columns; the last
// lane's hand-over of a pass is kept per row in scratch memory of the
// warp (allocated by the wrapper) and read by lane 0 of the next pass.
// F uses min(F + R, H + Q) for min(F + R, pre + Q), equal for
// Q >= R >= 0, which the cost model guarantees (gap open >= 0). A cell
// is a compare, a three-way min and two add-mins on the ALU pipe, which
// is what the kernel fills; its two plain adds (the mismatch, H + Q) are
// written as multiply-adds by a kernel argument that is 1 (fma_add), so
// they run on the FMA pipe beside them.

#include <cstdint>
#include <cuda_runtime.h>

#include "dpx.cuh"

namespace {

constexpr int kInf = 1 << 28;
constexpr int kBandThreads = 64;
constexpr int kMaxBand = 63;
constexpr int kMaxShared = 227 * 1024;  // bytes a block can use
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t target_id(const void *ids, int ids64,
                                             int64_t t) {
  return ids64 ? ((const int64_t *)ids)[t] : (int64_t)((const int32_t *)ids)[t];
}

// Stage the seed's row in shared memory; every thread of the block calls it.
__device__ __forceinline__ void stage_query(uint8_t *sq,
                                            const uint8_t *__restrict__ q,
                                            int ql) {
  for (int i = threadIdx.x; i < ql; i += blockDim.x) sq[i] = q[i];
  __syncthreads();
}

// Slot k of row `row` of the band (query index i = row + k - B).
template <int MAXW>
__device__ __forceinline__ void band_slot(int k, int W, int B, int row, int tl,
                                          int ql, int tc, const uint8_t *sq,
                                          int (&H)[MAXW], int (&E)[MAXW],
                                          int &F, int fb, int db, int mm,
                                          int Q, int R, int &score) {
  const int i = row + k - B;
  if (i < 0 || i >= ql) {  // no cell: nothing valid ever reads this slot
    H[k] = kInf;
    E[k] = kInf;
    return;
  }
  // E enters from the previous row's slot k+1 (not yet overwritten)
  const int e_in = k + 1 < W ? E[k + 1] : kInf;
  int diag_in = H[k];
  if (i == 0) {  // left boundary: H(row-1, -1) and F(row, 0)
    diag_in = db;
    F = fb;
  }
  const int diag = diag_in + (sq[i] == tc ? 0 : mm);
  const int pre = min(diag, e_in);
  const int h = min(min(pre, F), kInf);
  H[k] = h;
  E[k] = min(min(h + Q, e_in + R), kInf);
  F = min(min(F + R, pre + Q), kInf);
  if (row == tl - 1 && i == ql - 1) score = h;
}

// BAND is the compile-time half-width (slot loops unroll, the band stays
// in registers) or -1 (runtime B <= (MAXW-1)/2, band in local memory).
template <int BAND, int MAXW>
__global__ void __launch_bounds__(kBandThreads)
    nw_band_kernel(const uint8_t *__restrict__ codes, int64_t stride,
                   const int32_t *__restrict__ lens, int64_t seed,
                   const void *__restrict__ ids, int ids64, int64_t nb,
                   int B_rt, int mm, int go, int ge,
                   int32_t *__restrict__ out) {
  extern __shared__ uint8_t sq[];
  const int ql = lens[seed];
  stage_query(sq, codes + seed * stride, ql);
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb) return;
  const int64_t tid = target_id(ids, ids64, t);
  const int tl = lens[tid];
  const int B = BAND >= 0 ? BAND : B_rt;
  const int W = 2 * B + 1;
  const int kf = ql - tl + B;  // slot of the final cell at row tl-1
  if (ql <= 0 || tl <= 0 || kf < 0 || kf >= W) {
    out[t] = kInf;
    return;
  }
  const uint8_t *__restrict__ s = codes + tid * stride;
  const int Q = go + ge;
  const int R = ge;

  // row -1: slot k holds H[-1][i-1] and E entering row 0 at column i-1,
  // i = k - B
  int H[MAXW], E[MAXW];
  if constexpr (BAND >= 0) {
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
      const int im1 = k - B - 1;
      H[k] = im1 >= 0 ? Q + im1 * R : kInf;
      E[k] = im1 >= 0 ? 2 * Q + im1 * R : kInf;
    }
  } else {
    for (int k = 0; k < W; ++k) {
      const int im1 = k - B - 1;
      H[k] = im1 >= 0 ? Q + im1 * R : kInf;
      E[k] = im1 >= 0 ? 2 * Q + im1 * R : kInf;
    }
  }

  int score = kInf;
  for (int row = 0; row < tl; ++row) {
    const int tc = s[row];
    const int fb = 2 * go + (row + 2) * ge;
    const int db = row == 0 ? 0 : go + row * ge;
    int F = kInf;
    if constexpr (BAND >= 0) {
#pragma unroll
      for (int k = 0; k < MAXW; ++k)
        band_slot<MAXW>(k, W, B, row, tl, ql, tc, sq, H, E, F, fb, db, mm, Q,
                        R, score);
    } else {
      for (int k = 0; k < W; ++k)
        band_slot<MAXW>(k, W, B, row, tl, ql, tc, sq, H, E, F, fb, db, mm, Q,
                        R, score);
    }
  }
  out[t] = score;
}

template <int BAND>
void launch_band(dim3 grid, size_t shmem, cudaStream_t st, const uint8_t *codes,
                 int64_t stride, const int32_t *lens, int64_t seed,
                 const void *ids, int ids64, int64_t nb, int B, int mm, int go,
                 int ge, int32_t *out) {
  constexpr int MAXW = BAND >= 0 ? 2 * BAND + 1 : 2 * kMaxBand + 1;
  auto kernel = nw_band_kernel<BAND, MAXW>;
  if (shmem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)shmem);
  kernel<<<grid, kBandThreads, shmem, st>>>(codes, stride, lens, seed, ids,
                                            ids64, nb, B, mm, go, ge, out);
}

constexpr int kFullWarps = 4;  // warps of a block of the full-row kernel

// Strip widths C the full-row kernel is built for, ascending. The one
// list makes the table, the launch switch and what the library reports
// (swarm_nw_full_strips).
#define NW_FULL_STRIPS(X) \
  X(1) X(2) X(4) X(6) X(8) X(10) X(13) X(16) X(20) X(26) X(32)
#define NW_STRIP_ITEM(CC) CC,
constexpr int kStrips[] = {NW_FULL_STRIPS(NW_STRIP_ITEM)};
#undef NW_STRIP_ITEM
constexpr int kNumStrips = sizeof(kStrips) / sizeof(kStrips[0]);
constexpr int kMaxStrip = kStrips[kNumStrips - 1];  // widest strip of a lane

// One warp per pair, lane l on columns [pass * 32C + l * C, + C). MULTI:
// rows wider than 32 * C columns, several passes; scratch then holds
// 2 * scratch_stride ints per warp of the grid.
// Blocks per SM, so that the strip stays in registers: 5 (96 registers)
// up to C = 16, 4 at C = 20, 3 beyond. At C = 13, 8 blocks spilled the
// strip's query codes inside the step loop and ran slower than 5.
template <int C, bool MULTI>
__global__ void __launch_bounds__(kFullWarps * 32,
                                  C <= 16 ? 5 : (C <= 20 ? 4 : 3))
    nw_full_kernel(const uint8_t *__restrict__ codes, int64_t stride,
                   const int32_t *__restrict__ lens, int64_t seed,
                   const void *__restrict__ ids, int ids64, int64_t nb, int mm,
                   int go, int ge, int one, int32_t *__restrict__ out,
                   int *scratch, int64_t scratch_stride) {
  const int ql = lens[seed];
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kFullWarps + (threadIdx.x >> 5);
  const int64_t n_warps = (int64_t)gridDim.x * kFullWarps;
  const int Q = go + ge;
  const int R = ge;
  const int mm_reg = mm * one;  // held in a register, not re-read per cell
  const uint8_t *__restrict__ q = codes + seed * stride;
  const int n_pass = MULTI ? (ql + 32 * C - 1) / (32 * C) : 1;
  volatile int *sH = MULTI ? scratch + warp * 2 * scratch_stride : nullptr;
  volatile int *sF = sH + scratch_stride;

  for (int64_t pair = warp; pair < nb; pair += n_warps) {
    const int64_t tid = target_id(ids, ids64, pair);
    const int tl = lens[tid];
    if (ql <= 0 || tl <= 0) {
      if (lane == 0) out[pair] = kInf;
      continue;
    }
    const uint8_t *__restrict__ s = codes + tid * stride;
    for (int pass = 0; pass < n_pass; ++pass) {
      const int col0 = pass * 32 * C + lane * C;
      int H[C], E[C], qc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = col0 + c;
        qc[c] = col < ql ? q[col] : 0x100;  // no code right of the query
        H[c] = Q + col * R;                 // row -1
        E[c] = 2 * Q + col * R;
      }
      // the column left of the strip: H[row-1] there, for the diagonal
      int h_left = col0 == 0 ? 0 : Q + (col0 - 1) * R;
      const bool final_pass = pass == n_pass - 1;
      const int last = ql - 1 - pass * 32 * C;  // the pair's last column
      const int lane_q = final_pass ? last / C : 31;
      const int n_steps = tl + lane_q;
      int h_out = 0, f_out = 0, tc = 0, chunk = 0, score = 0;
      int chunk_next = lane < tl ? s[lane] : 0;  // loaded a chunk ahead
      for (int t = 0; t < n_steps; ++t) {
        if ((t & 31) == 0) {
          chunk = chunk_next;
          chunk_next = t + 32 + lane < tl ? s[t + 32 + lane] : 0;
        }
        const int tc_new = __shfl_sync(kFull, chunk, t & 31);
        tc = __shfl_up_sync(kFull, tc, 1);
        int h_in = __shfl_up_sync(kFull, h_out, 1);  // H[row] left of strip
        int f_in = __shfl_up_sync(kFull, f_out, 1);  // F entering the strip
        const int row = t - lane;
        if (lane == 0) {
          tc = tc_new;
          if (!MULTI || pass == 0) {  // the matrix' left boundary
            h_in = go + (row + 1) * ge;
            f_in = 2 * go + (row + 2) * ge;
          } else if (row < tl) {
            h_in = sH[row];
            f_in = sF[row];
          }
        }
        if (row >= 0 && row < tl) {
          int F = f_in;
          int diag_in = h_left;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            int diag = diag_in;
            if (qc[c] != tc) diag = fma_add(diag, mm_reg, one);
            diag_in = H[c];
            const int h = __vimin3_s32(diag, E[c], F);
            const int hq = fma_add(h, Q, one);
            E[c] = __viaddmin_s32(E[c], R, hq);
            F = __viaddmin_s32(F, R, hq);
            H[c] = h;
          }
          h_left = h_in;
          h_out = H[C - 1];
          f_out = F;
          if (MULTI && !final_pass) {
            if (lane == 31) {
              sH[row] = h_out;
              sF[row] = f_out;
            }
          } else if (lane == lane_q && row == tl - 1) {
            const int cq = last - lane_q * C;
#pragma unroll
            for (int c = 0; c < C; ++c)
              if (c == cq) score = H[c];
          }
        }
      }
      if (final_pass && lane == lane_q) out[pair] = score;
      if (MULTI) __syncwarp();  // scratch rows, before the next pass reads
    }
  }
}

// The strip width for rows of `width` columns: the smallest built C with
// 32 * C >= width, else kMaxStrip (several passes).
int strip_for_width(int64_t width) {
  for (int c : kStrips)
    if (32 * (int64_t)c >= width) return c;
  return kMaxStrip;
}

int64_t full_blocks(int64_t nb) {
  const int64_t blocks = (nb + kFullWarps - 1) / kFullWarps;
  return blocks < 132 * 16 ? blocks : 132 * 16;
}

}  // namespace

// Banded scores of row `seed` against rows ids[0..nb); returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a band
// or a query length no variant takes).
extern "C" int swarm_nw_banded_scores(const void *codes, int64_t stride,
                                      int64_t width, const void *lens,
                                      int64_t seed, const void *ids, int ids64,
                                      int64_t nb, int mm, int go, int ge,
                                      int B, void *out, void *stream) {
  if (B < 1 || B > kMaxBand) return (int)cudaErrorInvalidValue;
  if (width + 16 > kMaxShared) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return 0;
  const dim3 grid((unsigned)((nb + kBandThreads - 1) / kBandThreads));
  const size_t shmem = (size_t)((width + 15) / 16 * 16);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t *c = (const uint8_t *)codes;
  const int32_t *l = (const int32_t *)lens;
  int32_t *o = (int32_t *)out;
#define NW_CASE(BB) \
  case BB:          \
    launch_band<BB>(grid, shmem, st, c, stride, l, seed, ids, ids64, nb, B, mm, go, ge, o); \
    break;
  switch (B) {
    NW_CASE(1) NW_CASE(2) NW_CASE(3) NW_CASE(4) NW_CASE(5)
    NW_CASE(6) NW_CASE(7) NW_CASE(8) NW_CASE(9) NW_CASE(10)
    NW_CASE(11) NW_CASE(12) NW_CASE(13) NW_CASE(14) NW_CASE(15)
    NW_CASE(16) NW_CASE(17) NW_CASE(18) NW_CASE(19) NW_CASE(20)
    default:
      launch_band<-1>(grid, shmem, st, c, stride, l, seed, ids, ids64, nb, B,
                      mm, go, ge, o);
  }
#undef NW_CASE
  return (int)cudaGetLastError();
}

// The strip widths the full-row kernel is built for: writes the first
// `cap` of them to `out` and returns how many there are.
extern "C" int swarm_nw_full_strips(int *out, int cap) {
  for (int i = 0; i < kNumStrips && i < cap; ++i) out[i] = kStrips[i];
  return kNumStrips;
}

// ints of scratch memory swarm_nw_full_scores needs for nb pairs of rows
// of `width` columns (0 while one pass covers a row).
extern "C" int64_t swarm_nw_full_scratch_ints(int64_t width, int64_t nb) {
  if (nb <= 0 || width <= 32 * kMaxStrip) return 0;
  return full_blocks(nb) * kFullWarps * 2 * width;
}

// Exact scores of row `seed` against rows ids[0..nb); returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue when the
// rows need scratch memory and `scratch` holds fewer ints than
// swarm_nw_full_scratch_ints says).
extern "C" int swarm_nw_full_scores(const void *codes, int64_t stride,
                                    int64_t width, const void *lens,
                                    int64_t seed, const void *ids, int ids64,
                                    int64_t nb, int mm, int go, int ge,
                                    void *out, void *scratch,
                                    int64_t scratch_ints, void *stream) {
  if (nb <= 0) return 0;
  if (go < 0 || ge < 0) return (int)cudaErrorInvalidValue;
  if (scratch_ints < swarm_nw_full_scratch_ints(width, nb))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)full_blocks(nb));
  const dim3 block(kFullWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
#define NW_FULL(CC)                                                        \
  case CC:                                                                 \
    nw_full_kernel<CC, false><<<grid, block, 0, st>>>(                     \
        (const uint8_t *)codes, stride, (const int32_t *)lens, seed, ids,  \
        ids64, nb, mm, go, ge, 1, (int32_t *)out, (int *)scratch, width);  \
    break;
  if (width > 32 * kMaxStrip) {
    nw_full_kernel<kMaxStrip, true><<<grid, block, 0, st>>>(
        (const uint8_t *)codes, stride, (const int32_t *)lens, seed, ids,
        ids64, nb, mm, go, ge, 1, (int32_t *)out, (int *)scratch, width);
    return (int)cudaGetLastError();
  }
  switch (strip_for_width(width)) {
    NW_FULL_STRIPS(NW_FULL)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NW_FULL
  return (int)cudaGetLastError();
}
