// The d>=2 network engine's qgram screen and the ordered extraction of
// its survivors.
//
// Replaces the XLA programs of swarm_tpu/ops/d2_network.py:
// _screen_words_body (jitted as qgram_screen_words) and
// _extract_pairs_body (jitted as extract_pairs). What they compute:
//
// - the screen: for each tile-pair step k = (ti, tj >= ti) over tiles of
//   T profiles, a pair (gi, gj) = (ti*T + r, tj*T + c) survives when
//   the Hamming distance of the two 1024-bit qgram parity profiles is at
//   most 10d (JAX: dot(+-1 a, +-1 b) >= 1024 - 20d, and dot = 1024 -
//   2 * Hamming), gi < gj < n and |len a - len b| <= d. The survivors of
//   a step are bit-packed by flat position r*T + c into T*T/32 words,
//   least significant bit first: word (r*T + c) / 32, bit c % 32 (T is
//   a multiple of 32, so a word is 32 columns of one row);
// - the extraction: every step's words compacted into (ga, gb) in
//   (step, row, column) order.
//
// d2_screen_kernel: a block takes 32 rows of a step's first tile and
// 32 * W columns of its second (W warps, up to 8). The rows' profiles
// and lengths sit in shared memory; each thread holds its column's
// profile in registers (16 words of 64 bits), so a profile is read from
// device memory once a block, not once a pair, and nothing of the
// [T, T] product is ever stored. A row is tested against a lane's column
// by XOR and __popcll a 64-bit word at a time, stopping once the count
// passes 10d (the profiles of unrelated amplicons differ in a few words
// already); pairs the cheaper tests reject (triangle, padding, lengths)
// count nothing. A warp's ballot is the row's word for its 32 columns,
// lane i's column at bit i, as JAX packs it. Lane 0 writes the word and,
// when it is not 0, adds its popcount to the row's survivor count
// (counts: one int32 a row of a step, [C * T], zeroed by the wrapper).
//
// d2_extract_kernel: after an exclusive scan of the row counts (int64)
// and one readback of the total, a warp takes one row of one step: a
// row without survivors returns at once; otherwise it reads the row's
// T/32 words 32 at a time, one a lane, scans their popcounts across the
// lanes, and each lane writes its word's pairs at its offset, bit by
// bit. Words in order, then bits in order: JAX's order exactly. A row
// whose words do not hold its count, or that would write past the
// total, traps.
//
// What bounds it on the card: the screen's integer work. XOR and
// popcount run on the CUDA cores (POPC at 16 a clock an SM), so the
// full 1024 bits of every pair would take ~47 ms at d2_100k (5.45e9
// pairs); the early stop leaves ~2-4 words a pair. The same dot in int8
// on the tensor cores (2 * 1024 operations a pair at 1,979 Tops/s) would
// take ~5.6 ms: that form, with the masks fused into the epilogue of an
// int8 mma, is later work. The words (T*T/8 bytes a step) are written
// once and read once by the extraction, which reads only rows that hold
// survivors. Indices of words are 64-bit: at 1M amplicons a chunk's
// words pass 2^31 (JAX's int32 wrap, the "round-4 regression", decoded
// per step for that reason).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kProfileWords = 16;  // 1024 bits
constexpr int kRowsPerBlock = 32;
constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kMaxWarps)
d2_screen_kernel(const uint64_t *__restrict__ prof,
                 const int32_t *__restrict__ lengths,
                 const int32_t *__restrict__ tis,
                 const int32_t *__restrict__ tjs, int T, int col_blocks,
                 int64_t n, int d, uint32_t *__restrict__ words,
                 int32_t *__restrict__ counts) {
  __shared__ uint64_t rows[kRowsPerBlock][kProfileWords];
  __shared__ int32_t row_len[kRowsPerBlock];
  const int64_t k = blockIdx.x / col_blocks;
  const int c = (blockIdx.x % col_blocks) * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int64_t ti = tis[k], tj = tjs[k];
  const uint64_t *arow = prof + (ti * T + r0) * kProfileWords;
  for (int i = threadIdx.x; i < kRowsPerBlock * kProfileWords;
       i += blockDim.x)
    rows[i / kProfileWords][i % kProfileWords] = __ldg(arow + i);
  for (int i = threadIdx.x; i < kRowsPerBlock; i += blockDim.x)
    row_len[i] = __ldg(lengths + ti * T + r0 + i);

  const int64_t gj = tj * T + c;
  const bool col_ok = gj < n;
  uint64_t b[kProfileWords];
  const ulonglong2 *bp =
      reinterpret_cast<const ulonglong2 *>(prof + gj * kProfileWords);
#pragma unroll
  for (int w = 0; w < kProfileWords / 2; ++w) {
    const ulonglong2 v = __ldg(bp + w);
    b[2 * w] = v.x;
    b[2 * w + 1] = v.y;
  }
  const int lb = __ldg(lengths + gj);
  __syncthreads();

  const int lim = 10 * d;
  const bool diag = ti == tj;
  const int64_t words_per_row = T / 32;
  uint32_t *out = words + (k * T + r0) * words_per_row + c / 32;
  int32_t *cnt = counts + k * T + r0;
  for (int rr = 0; rr < kRowsPerBlock; ++rr) {
    bool pass = col_ok && (!diag || r0 + rr < c) &&
                abs(row_len[rr] - lb) <= d;
    if (pass) {
      int h = 0;
#pragma unroll
      for (int w = 0; w < kProfileWords; ++w) {
        h += __popcll(rows[rr][w] ^ b[w]);
        if (h > lim) break;
      }
      pass = h <= lim;
    }
    const uint32_t word = __ballot_sync(kFull, pass);
    if ((threadIdx.x & 31) == 0) {
      out[rr * words_per_row] = word;
      if (word) atomicAdd(cnt + rr, __popc(word));
    }
  }
}

__global__ void d2_extract_kernel(const uint32_t *__restrict__ words,
                                  const int32_t *__restrict__ counts,
                                  const int64_t *__restrict__ offsets,
                                  const int32_t *__restrict__ tis,
                                  const int32_t *__restrict__ tjs, int T,
                                  int64_t n_rows, int64_t total,
                                  int32_t *__restrict__ ga,
                                  int32_t *__restrict__ gb) {
  const int64_t q = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (q >= n_rows) return;
  const int count = counts[q];
  if (count == 0) return;  // the same for the whole warp
  const int lane = threadIdx.x & 31;
  const int64_t k = q / T;
  const int32_t a = tis[k] * T + (int32_t)(q % T);
  const int32_t b0 = tjs[k] * T;
  const int words_per_row = T / 32;
  const uint32_t *row = words + q * words_per_row;
  const int64_t start = offsets[q];
  int64_t base = start;
  for (int w0 = 0; w0 < words_per_row; w0 += 32) {
    const int w = w0 + lane;
    uint32_t word = w < words_per_row ? row[w] : 0u;
    const int bits = __popc(word);
    int incl = bits;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += v;
    }
    int64_t pos = base + incl - bits;
    if (pos + bits > total) __trap();
    while (word) {
      const int bit = __ffs(word) - 1;
      word &= word - 1;
      ga[pos] = a;
      gb[pos] = b0 + w * 32 + bit;
      ++pos;
    }
    base += __shfl_sync(kFull, incl, 31);
  }
  if (base != start + count) __trap();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a tile the kernel does not
// take: T a positive multiple of 32). Nothing is launched for no steps.

// warps a screen block: the most of 8, 4, 2, 1 that divides T / 32
static int screen_warps(int T) {
  int w = kMaxWarps;
  while ((T / 32) % w) w /= 2;
  return w;
}

extern "C" int swarm_d2_screen(const void *prof, const void *lengths,
                               const void *tis, const void *tjs,
                               int64_t n_steps, int T, int64_t n, int d,
                               void *words, void *counts, void *stream) {
  if (T <= 0 || T % 32 || (uintptr_t)prof % 16)
    return (int)cudaErrorInvalidValue;
  if (n_steps <= 0) return 0;
  const int threads = 32 * screen_warps(T);
  const int col_blocks = T / threads;
  const dim3 grid((unsigned)(n_steps * col_blocks),
                  (unsigned)(T / kRowsPerBlock));
  d2_screen_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t *)prof, (const int32_t *)lengths,
      (const int32_t *)tis, (const int32_t *)tjs, T, col_blocks, n, d,
      (uint32_t *)words, (int32_t *)counts);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d2_extract(const void *words, const void *counts,
                                const void *offsets, const void *tis,
                                const void *tjs, int64_t n_steps, int T,
                                int64_t total, void *ga, void *gb,
                                void *stream) {
  if (T <= 0 || T % 32) return (int)cudaErrorInvalidValue;
  if (n_steps <= 0 || total <= 0) return 0;
  const int64_t n_rows = n_steps * T;
  constexpr int kThreads = 256;
  const int64_t per_block = kThreads / 32;
  d2_extract_kernel<<<(unsigned)((n_rows + per_block - 1) / per_block),
                      kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words, (const int32_t *)counts,
      (const int64_t *)offsets, (const int32_t *)tis, (const int32_t *)tjs, T,
      n_rows, total, (int32_t *)ga, (int32_t *)gb);
  return (int)cudaGetLastError();
}
