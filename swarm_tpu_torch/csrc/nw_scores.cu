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
// Band kernel (replaces make_banded_scores_pallas_band, the TPU's
// 128-lane sliding window with a log-step scan for F). Contract of
// banded_scores_reference (swarm_tpu_torch/ops/nw_scores.py): the DP
// restricted to the 2B+1 slots |i - row| <= B, query index i = row + k
// - B in slot k; exact wherever the true cost is at most the cutoff B
// was chosen for, above the cutoff elsewhere, INF when the final cell is
// outside the band or a length is 0. What bounds it on the card depends
// on the list. A short list (the seed loop's few thousand targets) is
// less than one warp per scheduler, so its time is one thread's chain of
// dependent instructions over its ~400 rows; a long list fills the card
// and its time is cells x instructions on the SMs' ALU pipe (mins,
// add-mins, the mismatch test), the bytes being a hundredth of that.
// Design, for B <= 20 (band as a template constant, H and E of every
// slot in registers):
// - One thread owns one pair, in blocks of one warp, so that a list of
//   4,096 pairs reaches 128 SMs and each warp has a scheduler to itself.
// - The cell of the full-row kernel: a mismatch test, a three-way min
//   (DPX __vimin3_s32) and two add-mins (__viaddmin_s32) on the ALU
//   pipe, the two plain adds as multiply-adds by a kernel argument that
//   is 1 (fma_add) on the FMA pipe beside them. F is a register carried
//   along the slots, as min(F + R, H + Q), equal to min(F + R, pre + Q)
//   for Q >= R >= 0. The penalties sit in registers the compiler cannot
//   re-read from the arguments at every cell (in_register).
// - A cell's three instructions depend on each other, and a short list
//   leaves a scheduler no second warp to switch to. So the main loop
//   takes 8 rows a trip as one basic block: slot k of a row needs slot
//   k+1 of the row before, not the end of that row's chain, and the
//   instruction scheduler interleaves the rows as a wavefront (one row
//   a trip took 1.9 times as long; writing the wavefront order out by
//   hand gained 2% more and was not kept).
// - No clamp inside the recurrence: values born from INF only grow
//   (penalties are not negative), a min never prefers them to a finite
//   one, and the score is clamped to INF once at the end, which equals
//   clamping every cell. The host function checks that INF plus the
//   longest path's growth stays below 2^31 (band_fits).
// - No load and no test inside the chain. Both rows are read 16 bytes
//   at a time through the read-only path, a chunk of 16 rows ahead of
//   use, and kept as 2-bit codes (the alphabet is 0..3; codes are
//   compared modulo 4). The query is held as the stream S[j] = q[j - B],
//   whose chunks change with the target's; a row's band window is one
//   funnel shift of two neighbouring chunks for each 16 slots, and one
//   XOR with the target's code leaves two bits a slot that are zero
//   where the codes match. Only the first B+1 rows hold slots left of
//   column 0 or the boundary column, and which slots depends on the row
//   alone: they are peeled; every later row is 2B+1 cells with no test.
//   Slots right of the query compute values nothing reads (a cell
//   depends on its own column and the one to its left only). The final
//   cell is read from slot qlen - tlen + B after the pair's last row.
// What is left at a long list: a quarter of the lanes idle where the
// list's targets lie outside the band (they leave at once, their warp
// does not), and the mismatch tests are a quarter of the ALU work.
// Bands 21..63 take one general variant: runtime band in local memory,
// the seed's row staged in shared memory, every slot tested and clamped.
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
#include <type_traits>
#include <cuda_runtime.h>

#include "dpx.cuh"

namespace {

constexpr int kInf = 1 << 28;
constexpr int kBandThreads = 32;     // register variants: one warp a block
constexpr int kGeneralThreads = 64;  // general band variant
constexpr int kMaxRegBand = 20;      // widest band kept in registers
constexpr int kBandRows = 8;  // rows a trip of its main loop; divides 16
constexpr int kMaxBand = 63;
constexpr int kMaxShared = 227 * 1024;  // bytes a block can use
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t target_id(const void *ids, int ids64,
                                             int64_t t) {
  return ids64 ? ((const int64_t *)ids)[t] : (int64_t)((const int32_t *)ids)[t];
}

// ---------------------------------------------------------------------
// Band kernel, register variants (B <= kMaxRegBand).
// ---------------------------------------------------------------------

// Whether no state of such a launch can reach 2^31 without the clamps:
// a path takes at most one step a row and a column, each adds at most
// max(mm, Q), and it starts at INF or at a boundary value.
bool band_fits(int64_t width, int mm, int go, int ge) {
  if (mm < 0 || go < 0 || ge < 0) return false;
  const int64_t big = (mm > go + ge ? mm : (int64_t)go + ge) + 1;
  return kInf + (3 * width + 2 * kMaxBand + 16) * big < ((int64_t)1 << 31);
}

// One row of the code matrix, 16 codes (one 16-byte load, 2 bits a code
// once packed) at a time; chunks past the row's stride read as zeros.
struct CodeRow {
  const uint4 *row;
  int n_chunks;
  __device__ __forceinline__ CodeRow(const uint8_t *p, int n)
      : row((const uint4 *)p), n_chunks(n) {}
  __device__ __forceinline__ uint4 fetch(int c) const {
    return c < n_chunks ? __ldg(row + c) : make_uint4(0, 0, 0, 0);
  }
};

// The query as the band sees it: the stream S[j] = q[j - B], whose codes
// S[row .. row + 2B] are the band's window at `row`, so that its chunks
// of 16 codes change with the target's, every 16 rows. s[0..NW] are the
// packed chunks c .. c + NW of the current chunk c of rows; a window is
// NW 32-bit words, each one funnel shift of two neighbouring chunks.
template <int B>
struct QueryStream {
  static constexpr int W = 2 * B + 1;
  static constexpr int NW = (W + 15) / 16;
  static constexpr int kSkip = B / 16;   // leading chunks of S before q[0]
  static constexpr int kShift = B % 16;  // codes a chunk of S lags one of q
  CodeRow q;
  uint32_t s[NW + 1];
  uint32_t last = 0;  // the packed chunk of q before `ahead`
  uint4 ahead;        // the next chunk of q, loaded a chunk of rows early
  int next = 1;       // the chunk of q to load after `ahead`
  __device__ __forceinline__ QueryStream(const uint8_t *p, int n) : q(p, n) {
    ahead = q.fetch(0);
    s[0] = 0;
#pragma unroll
    for (int x = 1; x <= NW; ++x) s[x] = x - 1 < kSkip ? 0u : advance();
  }
  // the next chunk of S
  __device__ __forceinline__ uint32_t advance() {
    const uint32_t fresh = pack_codes16(ahead);
    ahead = q.fetch(next++);
    const uint32_t word =
        kShift ? __funnelshift_r(last, fresh, 32 - 2 * kShift) : fresh;
    last = fresh;
    return word;
  }
  // on to the next 16 rows (called at row 0 too)
  __device__ __forceinline__ void enter_chunk() {
#pragma unroll
    for (int x = 0; x < NW; ++x) s[x] = s[x + 1];
    s[NW] = advance();
  }
};

// Blocks of one warp an SM should hold: the band takes 2W registers,
// the rest of a pair about 44.
constexpr int band_blocks(int B) {
  const int k = 65536 / (kBandThreads * (2 * (2 * B + 1) + 44));
  return k > 32 ? 32 : (k < 1 ? 1 : k);
}

template <int B>
__global__ void __launch_bounds__(kBandThreads, band_blocks(B))
    nw_band_kernel(const uint8_t *__restrict__ codes, int64_t stride,
                   const int32_t *__restrict__ lens, int64_t seed,
                   const void *__restrict__ ids, int ids64, int64_t nb, int mm,
                   int go, int ge, int one_arg, int32_t *__restrict__ out) {
  constexpr int W = 2 * B + 1;
  constexpr int NW = QueryStream<B>::NW;
  constexpr int U = kBandRows;
  const int64_t t = (int64_t)blockIdx.x * kBandThreads + threadIdx.x;
  if (t >= nb) return;
  const int ql = lens[seed];
  const int64_t tid = target_id(ids, ids64, t);
  const int tl = lens[tid];
  const int kf = ql - tl + B;  // slot of the final cell at row tl-1
  if (ql <= 0 || tl <= 0 || kf < 0 || kf >= W) {
    out[t] = kInf;
    return;
  }
  // held in registers, not re-read from the arguments at every cell
  const int Q = in_register(go + ge);
  const int R = in_register(ge);
  const int mm_reg = in_register(mm);
  const int one = in_register(one_arg);

  // row -1: slot k holds H[-1][i-1] and E entering row 0 at column i-1,
  // i = k - B
  int H[W], E[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int im1 = k - B - 1;
    H[k] = im1 >= 0 ? Q + im1 * R : kInf;
    E[k] = im1 >= 0 ? 2 * Q + im1 * R : kInf;
  }

  const int n_chunks = (int)(stride >> 4);
  QueryStream<B> qs(codes + seed * stride, n_chunks);
  const CodeRow target(codes + tid * stride, n_chunks);
  uint4 t_ahead = target.fetch(0);
  uint32_t t_codes = 0;  // the target's 16 codes of the current chunk
  int t_next = 1;
  auto enter_chunk = [&]() {
    t_codes = pack_codes16(t_ahead);
    t_ahead = target.fetch(t_next++);
    qs.enter_chunk();
  };

  auto cell = [&](int k, bool is_mm, int &F) {
    // E enters from the previous row's slot k+1 (not yet overwritten)
    const int e_in = k + 1 < W ? E[k + 1] : kInf;
    int diag = H[k];
    if (is_mm) diag = fma_add(diag, mm_reg, one);
    const int h = __vimin3_s32(diag, e_in, F);
    const int hq = fma_add(h, Q, one);
    E[k] = __viaddmin_s32(e_in, R, hq);
    F = __viaddmin_s32(F, R, hq);  // = min(F + R, pre + Q): Q >= R >= 0
    H[k] = h;
  };

  // Two bits a slot of row `row`'s window, zero where the query's code
  // equals the target's.
  auto row_differs = [&](int row, uint32_t (&x)[NW]) {
    const int sh = 2 * (row & 15);
    const uint32_t tc = ((t_codes >> sh) & 3u) * 0x55555555u;
#pragma unroll
    for (int v = 0; v < NW; ++v)
      x[v] = __funnelshift_r(qs.s[v], qs.s[v + 1], sh) ^ tc;
  };
  auto differs_at = [](const uint32_t (&x)[NW], int k) {
    return (x[k / 16] & (3u << (2 * (k % 16)))) != 0;
  };

  // One row of the band, slot by slot. CHECKED rows (the first B + 1)
  // may hold slots left of the matrix, which keep their state, and the
  // slot of column 0, which takes the boundary; both depend on the row
  // alone, so a warp does not diverge on them. Later rows have neither.
  auto do_row = [&](int row, auto checked) {
    uint32_t x[NW];
    row_differs(row, x);
    int F = kInf;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if constexpr (decltype(checked)::value) {
        const int i = row + k - B;
        if (i < 0) continue;
        if (i == 0) {  // left boundary: H(row-1, -1) and F(row, 0)
          H[k] = row == 0 ? 0 : go + row * ge;
          F = 2 * go + (row + 2) * ge;
        }
      }
      cell(k, differs_at(x, k), F);
    }
  };

  int row = 0;
  auto single_rows = [&](int until, auto checked) {
#pragma unroll 1
    for (; row < until; ++row) {
      if ((row & 15) == 0) enter_chunk();
      do_row(row, checked);
    }
  };
  single_rows(min(tl, B + 1), std::true_type{});
  single_rows(min(tl, (row + U - 1) / U * U), std::false_type{});
  // U rows a trip, one basic block: slot k of a row needs slot k+1 of
  // the row before, not the end of its chain, so the instruction
  // scheduler overlaps a row's late slots with the next rows' early ones
  // and the one warp a scheduler holds keeps issuing
#pragma unroll 1
  for (; row + U <= tl; row += U) {
    if ((row & 15) == 0) enter_chunk();
#pragma unroll
    for (int j = 0; j < U; ++j) do_row(row + j, std::false_type{});
  }
  single_rows(tl, std::false_type{});

  int score = kInf;
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k == kf) score = H[k];
  out[t] = min(score, kInf);
}

// ---------------------------------------------------------------------
// Band kernel, general variant: runtime band B <= kMaxBand in local
// memory, the seed's row staged in shared memory.
// ---------------------------------------------------------------------

constexpr int kMaxW = 2 * kMaxBand + 1;

__global__ void __launch_bounds__(kGeneralThreads)
    nw_band_general_kernel(const uint8_t *__restrict__ codes, int64_t stride,
                           const int32_t *__restrict__ lens, int64_t seed,
                           const void *__restrict__ ids, int ids64, int64_t nb,
                           int B, int mm, int go, int ge,
                           int32_t *__restrict__ out) {
  extern __shared__ uint8_t sq[];
  const int ql = lens[seed];
  // every thread of the block stages and reaches the barrier
  for (int i = threadIdx.x; i < ql; i += blockDim.x)
    sq[i] = codes[seed * stride + i];
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb) return;
  const int64_t tid = target_id(ids, ids64, t);
  const int tl = lens[tid];
  const int W = 2 * B + 1;
  const int kf = ql - tl + B;  // slot of the final cell at row tl-1
  if (ql <= 0 || tl <= 0 || kf < 0 || kf >= W) {
    out[t] = kInf;
    return;
  }
  const uint8_t *__restrict__ s = codes + tid * stride;
  const int Q = go + ge;
  const int R = ge;

  int H[kMaxW], E[kMaxW];
  for (int k = 0; k < W; ++k) {  // row -1, as in the register variants
    const int im1 = k - B - 1;
    H[k] = im1 >= 0 ? Q + im1 * R : kInf;
    E[k] = im1 >= 0 ? 2 * Q + im1 * R : kInf;
  }

  int score = kInf;
  for (int row = 0; row < tl; ++row) {
    const int tc = s[row];
    int F = kInf;
    for (int k = 0; k < W; ++k) {
      const int i = row + k - B;
      if (i < 0 || i >= ql) {  // no cell: nothing valid ever reads this slot
        H[k] = kInf;
        E[k] = kInf;
        continue;
      }
      // E enters from the previous row's slot k+1 (not yet overwritten)
      const int e_in = k + 1 < W ? E[k + 1] : kInf;
      int diag_in = H[k];
      if (i == 0) {  // left boundary: H(row-1, -1) and F(row, 0)
        diag_in = row == 0 ? 0 : go + row * ge;
        F = 2 * go + (row + 2) * ge;
      }
      const int diag = diag_in + (sq[i] == tc ? 0 : mm);
      const int pre = min(diag, e_in);
      const int h = min(min(pre, F), kInf);
      H[k] = h;
      E[k] = min(min(h + Q, e_in + R), kInf);
      F = min(min(F + R, pre + Q), kInf);
      if (row == tl - 1 && i == ql - 1) score = h;
    }
  }
  out[t] = score;
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

// 1 when the band kernel takes rows of `width` columns under these
// penalties (band_fits above), else 0.
extern "C" int swarm_nw_band_fits(int64_t width, int mm, int go, int ge) {
  return band_fits(width, mm, go, ge) ? 1 : 0;
}

// Banded scores of row `seed` against rows ids[0..nb); returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a band,
// a row width or penalties no variant takes, or for a band up to 20 on a
// code matrix that is not laid out in 16-byte chunks).
extern "C" int swarm_nw_banded_scores(const void *codes, int64_t stride,
                                      int64_t width, const void *lens,
                                      int64_t seed, const void *ids, int ids64,
                                      int64_t nb, int mm, int go, int ge,
                                      int B, void *out, void *stream) {
  if (B < 1 || B > kMaxBand) return (int)cudaErrorInvalidValue;
  if (!band_fits(width, mm, go, ge)) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t *c = (const uint8_t *)codes;
  const int32_t *l = (const int32_t *)lens;
  int32_t *o = (int32_t *)out;
  if (B > kMaxRegBand) {
    if (width + 16 > kMaxShared) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((nb + kGeneralThreads - 1) / kGeneralThreads));
    const size_t shmem = (size_t)((width + 15) / 16 * 16);
    if (shmem > 48 * 1024)
      cudaFuncSetAttribute(nw_band_general_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shmem);
    nw_band_general_kernel<<<grid, kGeneralThreads, shmem, st>>>(
        c, stride, l, seed, ids, ids64, nb, B, mm, go, ge, o);
    return (int)cudaGetLastError();
  }
  if (stride % 16 != 0 || (uintptr_t)codes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nb + kBandThreads - 1) / kBandThreads));
#define NW_CASE(BB)                                                          \
  case BB:                                                                   \
    nw_band_kernel<BB><<<grid, kBandThreads, 0, st>>>(c, stride, l, seed,    \
                                                      ids, ids64, nb, mm, go, \
                                                      ge, 1, o);             \
    break;
  switch (B) {
    NW_CASE(1) NW_CASE(2) NW_CASE(3) NW_CASE(4) NW_CASE(5)
    NW_CASE(6) NW_CASE(7) NW_CASE(8) NW_CASE(9) NW_CASE(10)
    NW_CASE(11) NW_CASE(12) NW_CASE(13) NW_CASE(14) NW_CASE(15)
    NW_CASE(16) NW_CASE(17) NW_CASE(18) NW_CASE(19) NW_CASE(20)
    default:  // B <= kMaxRegBand has a case each
      return (int)cudaErrorInvalidValue;
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
