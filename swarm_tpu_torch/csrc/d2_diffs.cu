// Forward-diff banded DP for the d>=2 network engine's exact diffs.
//
// Replaces the TPU kernel swarm_tpu/ops/pallas_d2_diffs.py:
// d2_diffs_pallas (kernel body _make_kernel). Semantics are those of
// swarm_tpu/ops/d2_diffs_jax.py: d2_diffs_program: a banded (H, E, F)
// cost DP over directed pair tasks (query row tq[t], target row td[t])
// that carries, beside each cost, the difference count of the path the
// native backtrack would choose, with the same tie-break order
// (bits 1/2/4/8). A task's result is that count, or -1 when the cost
// exceeds d * max(mismatch, go + ge), the count exceeds d, the lengths
// differ by more than B, or a row is empty.
//
// What bounds it on the card: integer instruction rate. A task is a serial chain of
// dlen rows of W = 2B+1 cells; with 2^20 tasks in flight the card is
// full, so the time is cells x instructions per cell over the SMs'
// instruction rate (the bytes, each row read once, are a tenth of that).
// The design therefore spends as few instructions per cell, and as few
// registers per slot, as the recurrence allows:
//
// - One thread owns one task. The register variants (B <= 20, which
//   covers default scores at every d of the 8-bit regime) keep one
//   32-bit word per state: cost << 11 | priority << 9 | count. The
//   scan's "E wins ties over the diagonal, the diagonal over F" is a
//   three-way min (DPX __vimin3_s32) of words whose priority fields are
//   1, 2 and 3, and the winner's count rides along; "the H-derived
//   candidate wins ties" in the E and F updates is a fused add-min
//   (DPX __viaddmin_s32) against a word of priority 0. One logic
//   operation after each min sets the field back. That is the scan's
//   tie-break order word for word, in a third of the instructions and
//   half the registers of a version that carries costs, counts and
//   the four tie-break bits apart.
// - Why the packed word is exact: costs never fall along a path, so a
//   cell on an accepted path costs at most the cutoff, and each counted
//   difference costs at least min(mismatch, ge) >= 1, so such a cell's
//   count fits 9 bits when cutoff <= 500 * min(mismatch, ge). Cells
//   above the cutoff may overflow their count into the fields above,
//   which only makes them dearer. No state is clamped to INF: INF is
//   2^18 in a 20-bit cost field, and the host function takes the
//   packed variants only when (stride + 2B + 8) * (max(mismatch,
//   go + ge) + 1) leaves that field room (packed_fits below).
// - The query's band window (codes q[row-B .. row+B]) is a register of
//   2-bit codes that slides by one code a row; the row's mismatch bits
//   come from one XOR of the window with the target code. Both rows are
//   read 16 bytes at a time through the read-only path (uint4), each
//   byte once, so the code matrix needs a row stride that is a
//   multiple of 16 and a 16-byte aligned base (the wrapper sees to it).
//   Codes are compared modulo 4: the alphabet is 0..3.
// - Rows are peeled: only the first B+1 rows hold slots left of the
//   matrix or in column 0, and which slots those are depends on the row
//   alone, so a warp does not diverge on the test. Every later row is
//   a straight run of W cells with no test at all: slots right of the
//   query compute values that nothing reads, since a cell depends on
//   its own column and the one to its left only. A task stops at its
//   own last target row and reads its final cell (column qlen - 1)
//   from the band once, after the loop.
// - Mins and logic run on an SM's ALU pipe, which is what this kernel
//   fills. The two adds of a cell that feed no fused add-min are
//   written as multiply-adds by a kernel argument that is 1 (fma_add),
//   so they run on the FMA pipe beside the ALU work: 6 ALU and 2 FMA
//   instructions a cell.
// - __launch_bounds__(128, k): k blocks per SM chosen per B so that the
//   band (2W words) fits the register file without spills.
//
// Any band or penalty set outside those limits (B > 20, which small
// penalties at large d produce; a cost field too narrow) takes the
// general variant: costs, counts and tie-break bits apart, clamped to
// INF = 2^28 as the scan does, the band in local memory.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "dpx.cuh"

namespace {

constexpr int kThreads = 128;

// ---------------------------------------------------------------------
// General variant: runtime band, states apart, band in local memory.
// ---------------------------------------------------------------------

constexpr int kInf = 1 << 28;

// One cell of the band: row `row`, query index i = row + k - B (slot k).
// Updates the slot's H/E state and the row's running F state in place.
__device__ __forceinline__ void d2_cell(int &H, int &E, int &Hd, int &Ed,
                                        int &F, int &Fd, int E_in,
                                        int E_in_d, int i, int row,
                                        int dchar, int qchar, int mismatch,
                                        int go, int ge, int Q, int R) {
  int diag_in = H;
  int diag_d = Hd;
  if (i == 0) {  // left boundary: H(row-1, -1) and F(row, 0)
    diag_in = row == 0 ? 0 : go + row * ge;
    diag_d = row;
    F = 2 * go + (row + 2) * ge;
    Fd = row + 2;
  }
  const bool is_mm = dchar != qchar;
  // the scan's clamp (d2_diffs_jax.py), which the Pallas kernel drops:
  // with it every state stays <= INF + mismatch, whatever the row count
  const int diag = diag_in >= kInf ? kInf : diag_in + (is_mm ? mismatch : 0);
  diag_d += is_mm ? 1 : 0;
  const int pre = min(diag, E_in);
  const int Hn = min(pre, F);
  const bool b1 = diag <= F;
  const bool b2 = E_in <= min(diag, F);
  const int hq = Hn + Q;
  const bool b4 = hq <= F + R;
  const bool b8 = hq <= E_in + R;
  const int Hdn = b2 ? E_in_d : (b1 ? diag_d : Fd);
  const int En = min(min(hq, E_in + R), kInf);
  const int Edn = b8 ? Hdn + 1 : E_in_d + 1;
  const int Fn = min(min(F + R, pre + Q), kInf);
  const int Fdn = b4 ? Hdn + 1 : Fd + 1;
  H = Hn;
  E = En;
  Hd = Hdn;
  Ed = Edn;
  F = Fn;
  Fd = Fdn;
}

// The band loop of one task, band half-width B <= (MAXW-1)/2.
template <int MAXW>
__device__ int d2_task_general(const uint8_t *__restrict__ q,
                               const uint8_t *__restrict__ s, int ql, int dl,
                               int B, int mismatch, int go, int ge, int d) {
  const int W = 2 * B + 1;
  const int Q = go + ge;
  const int R = ge;
  const int cutoff = d * max(mismatch, Q);

  int H[MAXW], E[MAXW], Hd[MAXW], Ed[MAXW];
  for (int k = 0; k < W; ++k) {  // row -1: slot k is query index k - B - 1
    const int im1 = k - B - 1;
    const bool ok = im1 >= 0 && im1 < ql;
    H[k] = ok ? Q + im1 * R : kInf;
    E[k] = ok ? 2 * Q + im1 * R : kInf;
    Hd[k] = im1 >= 0 ? im1 + 1 : 0;
    Ed[k] = im1 >= 0 ? im1 + 2 : 0;
  }

  int score = kInf;
  int sdiff = 0;
  for (int row = 0; row < dl; ++row) {
    const int dchar = s[row];
    int F = kInf;
    int Fd = 0;
    for (int k = 0; k < W; ++k) {
      // slots left of the matrix keep their state; slots right of the
      // query hold no cell
      const int i = row + k - B;
      if (i < 0) continue;
      if (i >= ql) {
        H[k] = kInf;
        E[k] = kInf;
        continue;
      }
      // E enters from the previous row's slot k+1 (not yet overwritten)
      const int E_in = k + 1 < W ? E[k + 1] : kInf;
      const int E_in_d = k + 1 < W ? Ed[k + 1] : 0;
      d2_cell(H[k], E[k], Hd[k], Ed[k], F, Fd, E_in, E_in_d, i, row, dchar,
              q[i], mismatch, go, ge, Q, R);
      if (row == dl - 1 && i == ql - 1) {
        score = H[k];
        sdiff = Hd[k];
      }
    }
  }
  return (score <= cutoff && sdiff <= d) ? sdiff : -1;
}

// ---------------------------------------------------------------------
// Register variants: one packed word per state.
// ---------------------------------------------------------------------

constexpr int kDiffBits = 9;
constexpr int kPrioShift = kDiffBits;
constexpr int kCostShift = kDiffBits + 2;
constexpr int kDiffMask = (1 << kDiffBits) - 1;
constexpr int kPrioMask = 3 << kPrioShift;
constexpr int kInfCost = 1 << 18;
constexpr int kCostLimit = 1 << 20;  // the cost field's range

__host__ __device__ constexpr int pack(int cost, int prio, int diff) {
  return (cost << kCostShift) | (prio << kPrioShift) | diff;
}

constexpr int kInfH = pack(kInfCost, 2, 0);
constexpr int kInfE = pack(kInfCost, 1, 0);
constexpr int kInfF = pack(kInfCost, 3, 0);

// Whether the packed word holds every state of such tasks exactly.
bool packed_fits(int B, int64_t stride, int mismatch, int go, int ge, int d) {
  if (B > 20 || mismatch < 1 || ge < 1 || go < 0) return false;
  const int64_t Q = go + ge;
  const int64_t big = mismatch > Q ? mismatch : Q;
  const int64_t cutoff = d * big;
  const int64_t unit = mismatch < ge ? mismatch : ge;
  if (cutoff > 500 * unit || cutoff + 4 * big >= kInfCost) return false;
  const int64_t growth = (stride + 2 * B + 8) * (big + 1) + 4 * Q;
  return kInfCost + growth < kCostLimit;
}

// (a & keep) | set in one logic operation (both masks in registers).
__device__ __forceinline__ int and_or(int a, int keep, int set) {
  int r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(a), "r"(keep), "r"(set));
  return r;
}

// 16 codes of a row, 2 bits each, lowest index in the lowest bits;
// chunks past the row's stride read as zeros.
__device__ __forceinline__ uint32_t load_codes16(const uint4 *__restrict__ row,
                                                 int chunk, int n_chunks) {
  if (chunk >= n_chunks) return 0;
  return pack_codes16(__ldg(row + chunk));
}

// The codes of one row, in order, 16 loaded at a time.
struct CodeStream {
  const uint4 *row;
  int n_chunks;
  int chunk;
  int left;
  uint32_t buf;
  __device__ __forceinline__ CodeStream(const uint8_t *p, int n)
      : row((const uint4 *)p), n_chunks(n), chunk(0), left(0), buf(0) {}
  __device__ __forceinline__ uint32_t pop() {
    if (left == 0) {
      buf = load_codes16(row, chunk++, n_chunks);
      left = 16;
    }
    const uint32_t c = buf & 3u;
    buf >>= 2;
    --left;
    return c;
  }
};

// The band's window of W query codes, 2 bits a slot, slot 0 lowest.
template <int W>
struct Window {
  uint64_t lo = 0, hi = 0;  // hi holds slots 32.. (W > 32 only)
  __device__ __forceinline__ void push(uint32_t code) {  // slide by one slot
    lo >>= 2;
    if constexpr (W > 32) {
      lo |= hi << 62;
      hi >>= 2;
      hi |= (uint64_t)code << (2 * (W - 1) - 64);
    } else {
      lo |= (uint64_t)code << (2 * (W - 1));
    }
  }
};

// Bit 2k of the result is set where slot k differs from `code`.
__device__ __forceinline__ uint64_t mismatch_bits(uint64_t window,
                                                  uint32_t code) {
  const uint64_t x = window ^ (code * 0x5555555555555555ull);
  return (x | (x >> 1)) & 0x5555555555555555ull;
}

template <int B>
__device__ __forceinline__ int d2_task_packed(const uint8_t *__restrict__ q,
                                              const uint8_t *__restrict__ s,
                                              int ql, int dl, int n_chunks,
                                              int mismatch, int go, int ge,
                                              int d, int one) {
  constexpr int W = 2 * B + 1;
  const int Q = go + ge;
  const int R = ge;
  const int cutoff = d * max(mismatch, Q);
  const int mm_word = (mismatch << kCostShift) + 1;  // a counted mismatch
  // H-derived candidate of the E and F updates: + Q, one more
  // difference, priority 2 -> 0
  const int open_word = (Q << kCostShift) + 1 - (2 << kPrioShift);
  const int ext_word = (R << kCostShift) + 1;  // a gap extended by one
  const int keep_mask = ~(kPrioMask * one);
  const int prio_2 = (2 << kPrioShift) * one;

  int H[W], E[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {  // row -1: slot k is query index k - B - 1
    const int im1 = k - B - 1;
    const bool ok = im1 >= 0 && im1 < ql;
    H[k] = ok ? pack(Q + im1 * R, 2, im1 + 1) : kInfH;
    E[k] = ok ? pack(2 * Q + im1 * R, 1, im1 + 2) : kInfE;
  }

  CodeStream qs(q, n_chunks), ss(s, n_chunks);
  Window<W> win;
#pragma unroll
  for (int k = 0; k < B; ++k) win.push(qs.pop());  // q[0..B) in slots B+1..

  auto cell = [&](int k, bool is_mm, int &F) {
    // E enters from the previous row's slot k+1 (not yet overwritten)
    const int e_in = k + 1 < W ? E[k + 1] : kInfE;
    int diag = H[k];
    if (is_mm) diag = fma_add(diag, mm_word, one);
    const int hn = __vimin3_s32(e_in, diag, F);
    const int hst = and_or(hn, keep_mask, prio_2);
    const int open = fma_add(hst, open_word, one);
    E[k] = __viaddmin_s32(e_in, ext_word, open) | (1 << kPrioShift);
    F = __viaddmin_s32(F, ext_word, open) | (3 << kPrioShift);
    H[k] = hst;
  };

  // One row of the band. CHECKED rows (the first B + 1) may hold slots
  // left of the matrix, which keep their state, and the slot of column
  // 0, which takes the boundary; both depend on the row alone, so a
  // warp does not diverge on them. Later rows have neither.
  auto do_row = [&](int row, auto checked) {
    const uint32_t dchar = ss.pop();
    win.push(qs.pop());  // q[row + B] enters slot 2B
    const uint64_t mlo = mismatch_bits(win.lo, dchar);
    const uint64_t mhi = W > 32 ? mismatch_bits(win.hi, dchar) : 0;
    int F = kInfF;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if constexpr (decltype(checked)::value) {
        const int i = row + k - B;
        if (i < 0) continue;
        if (i == 0) {  // left boundary: H(row-1, -1) and F(row, 0)
          H[k] = pack(row == 0 ? 0 : go + row * ge, 2, row);
          F = pack(2 * go + (row + 2) * ge, 3, row + 2);
        }
      }
      const bool is_mm = k < 32 ? ((mlo >> (2 * k)) & 1) != 0
                                : ((mhi >> (2 * k - 64)) & 1) != 0;
      cell(k, is_mm, F);
    }
  };
  const int n_checked = min(dl, B + 1);
#pragma unroll 1
  for (int row = 0; row < n_checked; ++row) do_row(row, std::true_type{});
#pragma unroll 1
  for (int row = n_checked; row < dl; ++row) do_row(row, std::false_type{});

  // the final cell (dl-1, ql-1) sits in slot ql - dl + B of the last row
  const int kf = ql - dl + B;
  int last = kInfH;
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k == kf) last = H[k];
  const int score = last >> kCostShift;
  const int sdiff = last & kDiffMask;
  return (score <= cutoff && sdiff <= d) ? sdiff : -1;
}

// Blocks of kThreads an SM should hold: the band takes 2W registers;
// with 46 for the rest of the task ptxas spills next to nothing, and
// the 2^20-task sample ran fastest (30 and 62 were tried).
constexpr int min_blocks(int B) {
  const int regs = 2 * (2 * B + 1) + 46;
  const int k = 65536 / (kThreads * regs);
  return k > 12 ? 12 : (k < 1 ? 1 : k);
}

// BAND >= 0: packed register variant; -1: general variant, runtime B.
template <int BAND, int MAXW>
__global__ void __launch_bounds__(kThreads, BAND >= 0 ? min_blocks(BAND) : 1)
    d2_diffs_kernel(const uint8_t *__restrict__ codes, int64_t stride,
                    const int32_t *__restrict__ lens,
                    const int64_t *__restrict__ tq,
                    const int64_t *__restrict__ td, int64_t n_tasks, int B,
                    int mismatch, int go, int ge, int d, int one,
                    int32_t *__restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tasks) return;
  const int64_t qa = tq[t];
  const int64_t da = td[t];
  const int ql = lens[qa];
  const int dl = lens[da];
  const int band = BAND >= 0 ? BAND : B;
  if (ql <= 0 || dl <= 0 || abs(ql - dl) > band) {
    out[t] = -1;
    return;
  }
  const uint8_t *q = codes + qa * stride;
  const uint8_t *s = codes + da * stride;
  if constexpr (BAND >= 0)
    out[t] = d2_task_packed<BAND>(q, s, ql, dl, (int)(stride >> 4), mismatch,
                                  go, ge, d, one);
  else
    out[t] = d2_task_general<MAXW>(q, s, ql, dl, B, mismatch, go, ge, d);
}

}  // namespace

// Widest band any variant takes: 8-bit mode keeps d*max(mm, go+ge)
// <= 255, so B = ceil((cutoff + 2ge + 1) / ge) <= 258.
#define D2_MAX_W 520

extern "C" int swarm_d2_max_w(void) { return D2_MAX_W; }

// 1 when these tasks take a packed register variant, which needs a
// 16-byte aligned code matrix with a row stride that is a multiple of 16.
extern "C" int swarm_d2_packed(int64_t stride, int B, int mismatch, int go,
                               int ge, int d) {
  return packed_fits(B, stride, mismatch, go, ge, d) ? 1 : 0;
}

// diffs for n_tasks directed tasks; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a band no variant takes, or for a
// packed variant on a code matrix that is not laid out in 16-byte chunks).
extern "C" int swarm_d2_diffs(const void *codes, int64_t stride,
                              const void *lens, const void *tq,
                              const void *td, int64_t n_tasks, int B,
                              int mismatch, int go, int ge, int d, void *out,
                              void *stream) {
  if (B < 1 || 2 * B + 1 > D2_MAX_W) return (int)cudaErrorInvalidValue;
  if (n_tasks <= 0) return 0;
  const dim3 grid((unsigned)((n_tasks + kThreads - 1) / kThreads));
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t *c = (const uint8_t *)codes;
  const int32_t *l = (const int32_t *)lens;
  const int64_t *a = (const int64_t *)tq;
  const int64_t *b = (const int64_t *)td;
  int32_t *o = (int32_t *)out;
  if (!packed_fits(B, stride, mismatch, go, ge, d)) {
    d2_diffs_kernel<-1, D2_MAX_W><<<grid, kThreads, 0, st>>>(
        c, stride, l, a, b, n_tasks, B, mismatch, go, ge, d, 1, o);
    return (int)cudaGetLastError();
  }
  if (stride % 16 != 0 || (uintptr_t)codes % 16 != 0)
    return (int)cudaErrorInvalidValue;
#define D2_CASE(BB)                                             \
  case BB:                                                      \
    d2_diffs_kernel<BB, 2 * BB + 1><<<grid, kThreads, 0, st>>>( \
        c, stride, l, a, b, n_tasks, BB, mismatch, go, ge, d, 1, o); \
    break;
  switch (B) {
    D2_CASE(1) D2_CASE(2) D2_CASE(3) D2_CASE(4) D2_CASE(5)
    D2_CASE(6) D2_CASE(7) D2_CASE(8) D2_CASE(9) D2_CASE(10)
    D2_CASE(11) D2_CASE(12) D2_CASE(13) D2_CASE(14) D2_CASE(15)
    D2_CASE(16) D2_CASE(17) D2_CASE(18) D2_CASE(19) D2_CASE(20)
    default:  // packed_fits admits no other band
      return (int)cudaErrorInvalidValue;
  }
#undef D2_CASE
  return (int)cudaGetLastError();
}
