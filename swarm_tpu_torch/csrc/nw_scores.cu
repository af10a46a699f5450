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
// seed's row is the query of every pair of a launch, so each block
// stages it once in shared memory.
//
// Band kernel. Contract of banded_scores_reference
// (swarm_tpu_torch/ops/nw_scores.py): the DP restricted to the 2B+1
// slots |i - row| <= B; exact wherever the true cost is at most the
// cutoff B was chosen for, above the cutoff elsewhere, INF when the
// final cell is outside the band. Design: one thread owns one pair and
// keeps the band (H, E per slot) in registers when B is a template
// constant (B <= 20); wider bands (up to 63) take one variant with the
// band in local memory. F is a sequential min along the slots, and a
// pair stops at its own last target row. Bound: integer ALU work, about
// 12 int32 ops per cell over sum(tlen) * (2B+1) cells; a launch of a
// few thousand pairs fills only a few warps per SM, so it is latency
// that sets its time, not throughput.
//
// Full-row kernel. Bit-identical to ops/search.py for every pair. One
// warp owns one pair; the row state (H, E over the query's columns)
// lives in shared memory, and a lane only ever touches the columns
// congruent to its lane id, so the warp needs no barrier. A row is
// walked in tiles of 32 columns: `pre` depends on the previous row
// only, and F, the one dependency along the row, is the min-plus
// prefix scan F[c] = min(fb, min_{j<c} pre[j] + Q - (j+1)R) + cR,
// taken with warp shuffles inside a tile and carried between tiles.
// Bound: integer ALU work over tlen * qlen cells per pair.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 28;
constexpr int kBandThreads = 64;
constexpr int kMaxBand = 63;
constexpr int kMaxShared = 227 * 1024;
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

// One warp per pair; dynamic shared memory: H and E rows of ql ints for
// each warp of the block, then the staged query.
__global__ void nw_full_kernel(const uint8_t *__restrict__ codes,
                               int64_t stride,
                               const int32_t *__restrict__ lens, int64_t seed,
                               const void *__restrict__ ids, int ids64,
                               int64_t nb, int mm, int go, int ge,
                               int32_t *__restrict__ out) {
  extern __shared__ int smem[];
  const int ql = lens[seed];
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int *Hs = smem + (size_t)w * 2 * ql;
  int *Es = Hs + ql;
  uint8_t *sq = (uint8_t *)(smem + (size_t)warps * 2 * ql);
  stage_query(sq, codes + seed * stride, ql);
  const int Q = go + ge;
  const int R = ge;

  for (int64_t pair = (int64_t)blockIdx.x * warps + w; pair < nb;
       pair += (int64_t)gridDim.x * warps) {
    const int64_t tid = target_id(ids, ids64, pair);
    const int tl = lens[tid];
    if (ql <= 0 || tl <= 0) {
      if (lane == 0) out[pair] = kInf;
      continue;
    }
    const uint8_t *__restrict__ s = codes + tid * stride;
    for (int col = lane; col < ql; col += 32) {
      Hs[col] = Q + col * R;
      Es[col] = 2 * Q + col * R;
    }
    for (int row = 0; row < tl; ++row) {
      const int tc = s[row];
      // carried along the row: the running min of the scan (seeded by
      // the F boundary) and the previous tile's last H of the row above
      int carry_run = 2 * go + (row + 2) * ge;
      int carry_diag = row == 0 ? 0 : go + row * ge;
      for (int base = 0; base < ql; base += 32) {
        const int col = base + lane;
        const bool act = col < ql;
        const int hold = act ? Hs[col] : 0;
        const int eold = act ? Es[col] : 0;
        int dprev = __shfl_up_sync(kFull, hold, 1);
        if (lane == 0) dprev = carry_diag;
        const int V = (act && sq[col] == tc) ? 0 : mm;
        const int pre = min(dprev + V, eold);
        // inclusive prefix min over the tile of a[j] = pre[j] + Q - (j+1)R;
        // idle lanes (right of the query) hold a value that never wins
        int incl = act ? pre + Q - (col + 1) * R : (1 << 30);
#pragma unroll
        for (int sh = 1; sh < 32; sh <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, sh);
          if (lane >= sh) incl = min(incl, v);
        }
        const int excl = __shfl_up_sync(kFull, incl, 1);
        const int run = lane == 0 ? carry_run : min(carry_run, excl);
        const int F = run + col * R;
        const int h = min(pre, F);
        if (act) {
          Hs[col] = h;
          Es[col] = min(h + Q, eold + R);
        }
        carry_run = min(carry_run, __shfl_sync(kFull, incl, 31));
        carry_diag = __shfl_sync(kFull, hold, 31);
      }
    }
    // the lane that owns the last column wrote it itself
    if (lane == ((ql - 1) & 31)) out[pair] = Hs[ql - 1];
  }
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

// Exact scores of row `seed` against rows ids[0..nb); returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue when one
// warp's rows of `width` columns do not fit in shared memory).
extern "C" int swarm_nw_full_scores(const void *codes, int64_t stride,
                                    int64_t width, const void *lens,
                                    int64_t seed, const void *ids, int ids64,
                                    int64_t nb, int mm, int go, int ge,
                                    void *out, void *stream) {
  if (nb <= 0) return 0;
  // shared memory is sized for the widest row; the kernel uses ql <= width
  const int64_t per_warp = 8 * width;
  const int64_t query = (width + 15) / 16 * 16;
  int64_t warps = per_warp > 0 ? (kMaxShared - query) / per_warp : 8;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  if (warps > 8) warps = 8;
  // several blocks per SM while the rows are short
  while (warps > 1 && warps * per_warp + query > 48 * 1024) warps >>= 1;
  const size_t shmem = (size_t)(warps * per_warp + query);
  if (shmem > 48 * 1024)
    cudaFuncSetAttribute(nw_full_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)shmem);
  int64_t blocks = (nb + warps - 1) / warps;
  if (blocks > 132 * 16) blocks = 132 * 16;
  nw_full_kernel<<<dim3((unsigned)blocks), dim3((unsigned)(warps * 32)), shmem,
                   (cudaStream_t)stream>>>(
      (const uint8_t *)codes, stride, (const int32_t *)lens, seed, ids, ids64,
      nb, mm, go, ge, (int32_t *)out);
  return (int)cudaGetLastError();
}
