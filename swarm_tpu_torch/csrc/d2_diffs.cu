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
// Design: one thread owns one task. Rows of the two sequences are read
// through the task's indices from the device-resident [n, stride] code
// matrix, so no per-task copy of the rows is made. The band of W = 2B+1
// slots (H, E, Hd, Ed) lives in registers when B is a template constant
// (B <= 20, which covers default scores at every d of the 8-bit
// regime); wider bands, which small penalties at large d produce,
// take a variant that keeps the band in local memory. A task stops at
// its own last target row: its score is taken there and no later row
// can change it.
//
// Bound on the card: integer ALU work, about 30 int32 ops per cell over
// N * dlen * W cells, plus one uncoalesced byte read of each code per
// cell, since neighbouring threads own unrelated rows. Packing codes in
// 2 bits and staging rows in shared memory would cut the reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 28;
constexpr int kThreads = 128;

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

// Row -1 boundary of slot k (query index k - B - 1).
__device__ __forceinline__ void d2_init_slot(int k, int B, int ql, int Q,
                                             int R, int &H, int &E, int &Hd,
                                             int &Ed) {
  const int im1 = k - B - 1;
  if (im1 >= 0) {
    const bool ok = im1 < ql;
    H = ok ? Q + im1 * R : kInf;
    E = ok ? 2 * Q + im1 * R : kInf;
    Hd = im1 + 1;
    Ed = im1 + 2;
  } else {
    H = kInf;
    E = kInf;
    Hd = 0;
    Ed = 0;
  }
}

// Slot k of row `row` (query index i = row + k - B). Slots left of the
// matrix keep their state; slots right of the query hold no cell.
template <int MAXW>
__device__ __forceinline__ void d2_slot(int k, int W, int B, int row,
                                        int dl, int ql, int dchar,
                                        const uint8_t *__restrict__ q,
                                        int (&H)[MAXW], int (&E)[MAXW],
                                        int (&Hd)[MAXW], int (&Ed)[MAXW],
                                        int &F, int &Fd, int mismatch, int go,
                                        int ge, int Q, int R, int &score,
                                        int &sdiff) {
  const int i = row + k - B;
  if (i < 0) return;
  if (i >= ql) {
    H[k] = kInf;
    E[k] = kInf;
    return;
  }
  // E enters from the previous row's slot k+1 (not yet overwritten)
  int E_in = kInf;
  int E_in_d = 0;
  if (k + 1 < W) {
    E_in = E[k + 1];
    E_in_d = Ed[k + 1];
  }
  d2_cell(H[k], E[k], Hd[k], Ed[k], F, Fd, E_in, E_in_d, i, row, dchar, q[i],
          mismatch, go, ge, Q, R);
  if (row == dl - 1 && i == ql - 1) {
    score = H[k];
    sdiff = Hd[k];
  }
}

// The band loop of one task. BAND is the compile-time band half-width
// (register variant: every slot loop unrolls, so the arrays stay in
// registers) or -1 (runtime B <= (MAXW-1)/2, arrays in local memory).
template <int BAND, int MAXW>
__device__ __forceinline__ int d2_task(const uint8_t *__restrict__ q,
                                       const uint8_t *__restrict__ s, int ql,
                                       int dl, int B_rt, int mismatch, int go,
                                       int ge, int d) {
  const int B = BAND >= 0 ? BAND : B_rt;
  const int W = 2 * B + 1;
  const int Q = go + ge;
  const int R = ge;
  const int cutoff = d * max(mismatch, Q);

  int H[MAXW], E[MAXW], Hd[MAXW], Ed[MAXW];
  if constexpr (BAND >= 0) {
#pragma unroll
    for (int k = 0; k < MAXW; ++k)
      d2_init_slot(k, B, ql, Q, R, H[k], E[k], Hd[k], Ed[k]);
  } else {
    for (int k = 0; k < W; ++k)
      d2_init_slot(k, B, ql, Q, R, H[k], E[k], Hd[k], Ed[k]);
  }

  int score = kInf;
  int sdiff = 0;
  for (int row = 0; row < dl; ++row) {
    const int dchar = s[row];
    int F = kInf;
    int Fd = 0;
    if constexpr (BAND >= 0) {
#pragma unroll
      for (int k = 0; k < MAXW; ++k)
        d2_slot<MAXW>(k, W, B, row, dl, ql, dchar, q, H, E, Hd, Ed, F, Fd,
                      mismatch, go, ge, Q, R, score, sdiff);
    } else {
      for (int k = 0; k < W; ++k)
        d2_slot<MAXW>(k, W, B, row, dl, ql, dchar, q, H, E, Hd, Ed, F, Fd,
                      mismatch, go, ge, Q, R, score, sdiff);
    }
  }
  return (score <= cutoff && sdiff <= d) ? sdiff : -1;
}

template <int BAND, int MAXW>
__global__ void __launch_bounds__(kThreads)
    d2_diffs_kernel(const uint8_t *__restrict__ codes, int64_t stride,
                    const int32_t *__restrict__ lens,
                    const int64_t *__restrict__ tq,
                    const int64_t *__restrict__ td, int64_t n_tasks, int B,
                    int mismatch, int go, int ge, int d,
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
  out[t] = d2_task<BAND, MAXW>(codes + qa * stride, codes + da * stride, ql,
                               dl, B, mismatch, go, ge, d);
}

template <int BAND>
void launch_regs(dim3 grid, cudaStream_t st, const uint8_t *codes,
                 int64_t stride, const int32_t *lens, const int64_t *tq,
                 const int64_t *td, int64_t n, int mismatch, int go, int ge,
                 int d, int32_t *out) {
  d2_diffs_kernel<BAND, 2 * BAND + 1><<<grid, kThreads, 0, st>>>(
      codes, stride, lens, tq, td, n, BAND, mismatch, go, ge, d, out);
}

}  // namespace

// Widest band any variant takes: 8-bit mode keeps d*max(mm, go+ge)
// <= 255, so B = ceil((cutoff + 2ge + 1) / ge) <= 258.
#define D2_MAX_W 520

extern "C" int swarm_d2_max_w(void) { return D2_MAX_W; }

// diffs for n_tasks directed tasks; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a band no variant takes).
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
#define D2_CASE(BB) \
  case BB:          \
    launch_regs<BB>(grid, st, c, stride, l, a, b, n_tasks, mismatch, go, ge, d, o); \
    break;
  switch (B) {
    D2_CASE(1) D2_CASE(2) D2_CASE(3) D2_CASE(4) D2_CASE(5)
    D2_CASE(6) D2_CASE(7) D2_CASE(8) D2_CASE(9) D2_CASE(10)
    D2_CASE(11) D2_CASE(12) D2_CASE(13) D2_CASE(14) D2_CASE(15)
    D2_CASE(16) D2_CASE(17) D2_CASE(18) D2_CASE(19) D2_CASE(20)
    default:
      d2_diffs_kernel<-1, D2_MAX_W><<<grid, kThreads, 0, st>>>(
          c, stride, l, a, b, n_tasks, B, mismatch, go, ge, d, o);
  }
#undef D2_CASE
  return (int)cudaGetLastError();
}
