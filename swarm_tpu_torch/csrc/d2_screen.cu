// The d>=2 network engine's qgram screen and the ordered extraction of
// its survivors.
//
// Replaces the XLA programs of swarm_tpu/ops/d2_network.py:
// _screen_words_body (:52, jitted as qgram_screen_words) and
// _extract_pairs_body (:107, jitted as extract_pairs). What they compute:
//
// - the screen: for each tile-pair step k = (ti, tj >= ti) over tiles of
//   T profiles, a pair (gi, gj) = (ti*T + r, tj*T + c) survives when
//   dot(+-1 a, +-1 b) >= 1024 - 20d over the two 1024-bit qgram parity
//   profiles (a set bit is -1; dot = 1024 - 2 * Hamming), gi < gj < n
//   and |len a - len b| <= d. The survivors of a step are bit-packed by
//   flat position r*T + c into T*T/32 words, least significant bit
//   first: word (r*T + c) / 32, bit c % 32 (T is a multiple of 32, so a
//   word is 32 columns of one row);
// - the extraction: every step's words compacted into (ga, gb) in
//   (step, row, column) order.
//
// d2_screen_kernel: the dot as JAX and the MXU compute it, int8 products
// of +-1 profiles, on the tensor cores (wgmma.mma_async m64n128k32
// .s32.s8.s8; an int32 sum of at most 1024 products of +-1 is exact),
// with the masks in the epilogue. Persistent blocks of three warpgroups,
// one an SM, walk items (step, run of row tiles, 128 columns),
// neighbouring blocks on neighbouring columns of one step, so that they
// share its rows in L2. A block expands its item's 128 columns once, from
// the packed profiles (128 bytes a column), into 128 KB of shared memory
// as +-1 bytes in the layout the wgmma descriptors read (K-major, 128-byte
// swizzle); then each warpgroup takes every third row tile of 64 of the
// item's run, builds its A fragments in registers straight from the rows'
// packed words, and issues the 32 k-steps of the dot in batches of 4: a
// batch's fragments are built while the batch before runs (two register
// sets; the wait leaves one batch in flight), each batch's words are
// loaded a batch ahead, the last batch's load fetching the next tile's
// first. Nothing of the [T, 1024] +-1 tiles or of the [T, T] product is
// ever in device memory. The dot does not change under one permutation
// of K applied to both sides, so a k-step takes one 32-bit profile word
// w, and byte 4q + i of the step holds bit q + 8i of w: four bytes are
// (w >> q) & 0x01010101, made +-1 by one multiply-add. Epilogue: a warp
// whose 16 x 128 sums all lie below the threshold (nearly every one)
// stores zero words and no count; in the others the accumulator gives a
// thread columns 8j + 2t and 8j + 2t + 1 of two rows, so the thread
// builds the dot test's bits of its rows' four 32-column words, a quad
// ORs them with two shuffles, thread t keeps word t of each row, clears
// the set bits that fail the length or triangle test and stores it, and
// a row's count (the quad's popcounts summed) is added once an item, one
// atomicAdd. Items that the masks decide alone skip the product and
// still store their zero words: rows of a diagonal step (ti == tj)
// wholly on or below the diagonal of the item's columns, and columns
// wholly at or past n. The kernel writes every word of every step
// exactly once; `words` needs no zeroing. The ragged edge (T not a
// multiple of 64 or 128) is masked: rows and columns past T read no
// profile and store no word. Where the items would leave the last wave
// of the 132 resident blocks short, the launch cuts each step's row
// tiles into 2-4 runs (screen_parts).
//
// d2_extract_kernel: after an exclusive scan of the row counts (int64)
// and one readback of the total, persistent warps walk groups of 32 rows
// (all steps' rows in order): one coalesced load of the group's counts
// and offsets (the next group's in flight while a group is walked) and
// a ballot of the rows that hold survivors; only those rows are read,
// the first 128 words of four of them loaded at once. A row's T/32
// words are read 4 a lane (16-byte loads where T is a multiple of 128),
// 128 a pass; the lanes' popcounts are scanned, and each lane stores its
// pairs at its slots, or, in a pass of more than 32 pairs, they are
// staged in shared memory (windows of kStage) and stored coalesced.
// Words in order, then bits in order: JAX's order exactly. A row whose
// words do not hold its count, or that would write past the total,
// traps.
//
// What bounds them on the card: the screen, its operations: 2 * 1024
// int8 products a pair gi < gj < n at the data sheet's dense 1,979
// Tops/s, 5.2 ms for the 5.0e9 pairs of a 100k-amplicon corpus; the
// words (T*T/8 bytes a step) are 0.2 ms of device-memory time beside
// it, and the packed profiles stay in L2 (512 KB a tile). The B side's
// expansion, 3 operations a 4 bytes, is paid once an item and read from
// shared memory by every row tile of the item; the A side's, in
// registers, costs 12 integer operations a thread and k-step, beside a
// k-step's 64 clocks of tensor work an SM. The extraction, its bytes:
// the counts, the offsets, the words of the rows with survivors and the
// pairs. Indices of words are 64-bit: at 1M amplicons a chunk's words
// pass 2^31 (JAX's int32 wrap, the "round-4 regression", decoded per
// step for that reason).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- d2_screen ----
constexpr int kCols = 128;                   // an item's columns: wgmma N
constexpr int kRows = 64;                    // a warpgroup's rows: wgmma M
constexpr int kGroups = 3;                   // warpgroups a block
constexpr int kScreenThreads = 128 * kGroups;
constexpr int kSteps = 32;                   // k-steps: a profile word each
constexpr int kBatch = 4;                    // k-steps between waits
constexpr int kLoads = kBatch / 4;           // 16-byte loads a row a batch
constexpr int kChunk = kCols * 128;          // 4 k-steps of every column
constexpr int kBBytes = 8 * kChunk;          // the item's +-1 columns
constexpr int kScreenSmem = kBBytes + kCols * 4 + 1024;  // + lengths, align
constexpr int kNoLength = 1 << 30;           // a column that takes no pair

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// bytes 0..3: bits 0, 8, 16 and 24 of w as +1 (clear) or -1 (set)
__device__ __forceinline__ uint32_t pm1_bytes(uint32_t w) {
  return (w & 0x01010101u) * 0xFEu + 0x01010101u;
}

// wgmma descriptor of a K-major operand in 128-byte swizzled rows, 8 rows
// (1,024 bytes) a core-matrix group
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// waits until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous product
__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= a * b: a 64 x 32 int8 fragment of the warpgroup in registers, b
// 128 x 32 int8 K-major in shared memory; d[4j + 2h + e] is row g + 8h,
// column 8j + 2t + e of the warp's 16 rows (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// The item's columns c0 .. c0 + 127 of tile tj as +-1 bytes: column c's
// k-steps 4kc .. 4kc + 3 fill its 128-byte row of chunk kc, 16-byte unit
// u of the row at u ^ (c % 8). A thread takes a column's 16 bytes of
// profile (lanes: 8 columns x 4 chunks, so that a warp's loads cover
// whole profiles and each quarter-warp's stores hit distinct banks).
__device__ void expand_columns(const uint4 *__restrict__ prof, int64_t tj,
                               int c0, int T, uint8_t *bsm) {
  for (int x = threadIdx.x; x < kCols * 8; x += kScreenThreads) {
    const int c = (x / 64) * 8 + x % 8;
    const int kc = (x % 64) / 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c0 + c < T) v = __ldg(prof + (tj * T + c0 + c) * 8 + kc);
    uint8_t *row = bsm + kc * kChunk + c * 128;
    const int sw = c & 7;
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w = w4[i];
      *reinterpret_cast<uint4 *>(row + (((2 * i) ^ sw) << 4)) =
          make_uint4(pm1_bytes(w), pm1_bytes(w >> 1), pm1_bytes(w >> 2),
                     pm1_bytes(w >> 3));
      *reinterpret_cast<uint4 *>(row + (((2 * i + 1) ^ sw) << 4)) =
          make_uint4(pm1_bytes(w >> 4), pm1_bytes(w >> 5), pm1_bytes(w >> 6),
                     pm1_bytes(w >> 7));
    }
  }
}

// the 16-byte loads of k-step batch `batch` of a row (zeros for a row
// past T)
__device__ __forceinline__ void batch_words(const uint4 *row, bool valid,
                                            int batch, uint4 (&x)[kLoads]) {
#pragma unroll
  for (int h = 0; h < kLoads; ++h)
    x[h] = valid ? __ldg(row + kLoads * batch + h)
                 : make_uint4(0u, 0u, 0u, 0u);
}

// word s of a batch's loads
__device__ __forceinline__ uint32_t word_of(const uint4 (&x)[kLoads],
                                            int s) {
  const uint4 v = x[s / 4];
  return s % 4 == 0 ? v.x : s % 4 == 1 ? v.y : s % 4 == 2 ? v.z : v.w;
}

// a batch's A fragments from the words of the thread's two rows: byte i
// of register q holds bit q + 8i of the step's word, and the thread
// holds groups t and t + 4
__device__ __forceinline__ void build_a(const uint4 (&wa)[kLoads],
                                        const uint4 (&wb)[kLoads], int t,
                                        uint32_t (&a)[kBatch][4]) {
#pragma unroll
  for (int s = 0; s < kBatch; ++s) {
    const uint32_t xa = word_of(wa, s), xb = word_of(wb, s);
    a[s][0] = pm1_bytes(xa >> t);
    a[s][1] = pm1_bytes(xb >> t);
    a[s][2] = pm1_bytes(xa >> (t + 4));
    a[s][3] = pm1_bytes(xb >> (t + 4));
  }
}

// The bits of a row's word (columns c .. c + 31 of the step's tile,
// their lengths `len`) that also pass the length test and, on a
// diagonal step, lie right of the diagonal: only the set bits are tested
__device__ __forceinline__ uint32_t mask_word(uint32_t word, int la, int r,
                                              int c, bool diag, int d,
                                              const int32_t *len) {
  uint32_t out = 0u;
  while (word) {
    const int bit = __ffs(word) - 1;
    word &= word - 1;
    if (abs(la - len[bit]) <= d && (!diag || r < c + bit)) out |= 1u << bit;
  }
  return out;
}

// Rows: the thread's two (ra, rb = ra + 8) of a warpgroup's 64. A row
// tile's dot against the item's 128 columns: batches of kBatch k-steps, the
// A fragments in two register sets, so that a batch's are built while
// the batch before runs (wait for all but the last group), each batch's
// words loaded one batch ahead, and the last batch loading the first of
// the warpgroup's next row tile (rows na, nb: the words of batch 0 on
// entry, the next tile's on return).
struct Rows {
  const uint4 *a, *b;
  bool va, vb;
};

__device__ __forceinline__ void dot_tile(Rows rows, Rows next, int t,
                                         uint32_t b_base,
                                         uint4 (&na)[kLoads],
                                         uint4 (&nb)[kLoads],
                                         int32_t (&acc)[64]) {
  uint32_t a[2][kBatch][4];
#pragma unroll
  for (int batch = 0; batch < kSteps / kBatch; ++batch) {
    uint4 wa[kLoads], wb[kLoads];
#pragma unroll
    for (int h = 0; h < kLoads; ++h) {
      wa[h] = na[h];
      wb[h] = nb[h];
    }
    if (batch + 1 < kSteps / kBatch) {
      batch_words(rows.a, rows.va, batch + 1, na);
      batch_words(rows.b, rows.vb, batch + 1, nb);
    } else {
      batch_words(next.a, next.va, 0, na);
      batch_words(next.b, next.vb, 0, nb);
    }
    build_a(wa, wb, t, a[batch % 2]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int step = batch * kBatch + s;
      wgmma_s8(acc, a[batch % 2][s],
               swizzled_desc(b_base + (step / 4) * kChunk + (step % 4) * 32),
               step > 0);
    }
    wgmma_commit();
    if (batch + 1 == kSteps / kBatch)
      wgmma_wait<0>();
    else if (batch > 0)
      wgmma_wait<1>();  // the batch before is done: its registers are free
  }
  fence_acc(acc);
}

// Items: (step k, row part, 128 columns), neighbouring items on
// neighbouring columns; a step's row tiles of 64 are cut into `parts`
// runs (more than one where the items would leave the resident blocks'
// last wave short), a warpgroup taking every kGroups-th tile of its run.
__global__ void __launch_bounds__(kScreenThreads, 1)
d2_screen_kernel(const uint4 *__restrict__ prof,
                 const int32_t *__restrict__ lengths,
                 const int32_t *__restrict__ tis,
                 const int32_t *__restrict__ tjs, int64_t n_items,
                 int col_blocks, int parts, int T, int64_t n, int d,
                 uint32_t *__restrict__ words, int32_t *__restrict__ counts) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t *bsm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int32_t *col_len = reinterpret_cast<int32_t *>(bsm + kBBytes);
  const uint32_t b_base = smem_u32(bsm);
  const int group = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int thr = 1024 - 20 * d;
  const int64_t wpr = T / 32;
  const int row_tiles = (T + kRows - 1) / kRows;
  const int per_part = (row_tiles + parts - 1) / parts;

  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int64_t kp = item / col_blocks;
    const int64_t k = kp / parts;
    const int part = (int)(kp % parts);
    const int c0 = (int)(item % col_blocks) * kCols;
    const int c_end = min(c0 + kCols, T);
    const int64_t ti = tis[k], tj = tjs[k];
    const bool diag = ti == tj;
    const bool none = ti > tj || tj * T + c0 >= n;  // no pair can pass
    __syncthreads();  // every warpgroup is done with the last item's columns
    if (!none) {
      expand_columns(prof, tj, c0, T, bsm);
      for (int c = threadIdx.x; c < kCols; c += kScreenThreads) {
        const int64_t gj = tj * T + c0 + c;
        col_len[c] = c0 + c < T && gj < n ? lengths[gj] : kNoLength;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();

    uint32_t *out = words + k * T * wpr + c0 / 32 + t;
    const bool col_ok = c0 + 32 * t < T;  // the thread's word of a row
    const int rt_end = min((part + 1) * per_part, row_tiles);
    // the thread's rows of the warpgroup's row tile rt
    auto rows_of = [&](int rt) {
      const int r = rt * kRows + warp * 16 + g;
      const bool in = !none && rt < rt_end;
      return Rows{prof + (ti * T + r) * 8, prof + (ti * T + r + 8) * 8,
                  in && r < T, in && r + 8 < T};
    };
    uint4 na[kLoads], nb[kLoads];  // batch 0 of the warpgroup's next tile
    Rows cur = rows_of(part * per_part + group);
    batch_words(cur.a, cur.va, 0, na);
    batch_words(cur.b, cur.vb, 0, nb);
    for (int rt = part * per_part + group; rt < rt_end; rt += kGroups) {
      const int ra = rt * kRows + warp * 16 + g, rb = ra + 8;
      const bool va = ra < T, vb = rb < T;
      const Rows next = rows_of(rt + kGroups);
      // a diagonal step's rows at or past every column of the item
      const bool skip = none || (diag && rt * kRows >= c_end - 1);
      int32_t acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      bool any = false;
      if (!skip) {
        dot_tile(cur, next, t, b_base, na, nb, acc);
        int m = acc[0];
#pragma unroll
        for (int i = 1; i < 64; ++i) m = max(m, acc[i]);
        any = m >= thr;
      } else {
        batch_words(next.a, next.va, 0, na);
        batch_words(next.b, next.vb, 0, nb);
      }
      cur = next;
      // the dot's bits of the thread's columns, ORed over the quad into
      // the rows' 4 words; thread t keeps word t of each row and clears
      // the bits the length and triangle tests refuse
      uint32_t oa = 0u, ob = 0u;
      if (__any_sync(kFull, any)) {
        uint32_t xa[4] = {0u, 0u, 0u, 0u}, xb[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int sh = 8 * (j % 4) + 2 * t;
          xa[j / 4] |= (uint32_t)(acc[4 * j] >= thr) << sh |
                       (uint32_t)(acc[4 * j + 1] >= thr) << (sh + 1);
          xb[j / 4] |= (uint32_t)(acc[4 * j + 2] >= thr) << sh |
                       (uint32_t)(acc[4 * j + 3] >= thr) << (sh + 1);
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          xa[w] |= __shfl_xor_sync(kFull, xa[w], 1);
          xa[w] |= __shfl_xor_sync(kFull, xa[w], 2);
          xb[w] |= __shfl_xor_sync(kFull, xb[w], 1);
          xb[w] |= __shfl_xor_sync(kFull, xb[w], 2);
        }
        oa = t == 0 ? xa[0] : t == 1 ? xa[1] : t == 2 ? xa[2] : xa[3];
        ob = t == 0 ? xb[0] : t == 1 ? xb[1] : t == 2 ? xb[2] : xb[3];
        oa = mask_word(oa, va ? lengths[ti * T + ra] : 0, ra, c0 + 32 * t,
                       diag, d, col_len + 32 * t);
        ob = mask_word(ob, vb ? lengths[ti * T + rb] : 0, rb, c0 + 32 * t,
                       diag, d, col_len + 32 * t);
        int ca = __popc(oa), cb = __popc(ob);  // the rows' counts
        ca += __shfl_xor_sync(kFull, ca, 1);
        ca += __shfl_xor_sync(kFull, ca, 2);
        cb += __shfl_xor_sync(kFull, cb, 1);
        cb += __shfl_xor_sync(kFull, cb, 2);
        if (t == 0 && va && ca) atomicAdd(counts + k * T + ra, ca);
        if (t == 0 && vb && cb) atomicAdd(counts + k * T + rb, cb);
      }
      if (va && col_ok) out[ra * wpr] = oa;
      if (vb && col_ok) out[rb * wpr] = ob;
    }
  }
}

// ---- d2_extract ----
constexpr int kExtractWarps = 8;
constexpr int kDirect = 32;    // pairs of a pass that lanes store directly
constexpr int kStage = 1024;   // pairs a warp stages at a time
constexpr int kRowBatch = 4;   // rows of a group whose words load at once

// words w .. w + 3 of a row (0 past its end)
__device__ __forceinline__ void row_words4(const uint32_t *row, int w,
                                           int wpr, uint32_t (&x)[4]) {
  if (wpr % 4 == 0) {  // the row starts on 16 bytes
    const uint4 v = w < wpr ? __ldg(reinterpret_cast<const uint4 *>(row + w))
                            : make_uint4(0u, 0u, 0u, 0u);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = w + i < wpr ? __ldg(row + w + i) : 0u;
  }
}

// The pairs of row q (all steps' rows in order; global row a, columns
// from b0) at offsets start .. start + count: a pass takes 128 words, 4
// a lane (x: the first pass', loaded by the caller), scans the lanes'
// popcounts, and each lane stores its pairs at its slots, or, for a pass
// of more than kDirect pairs, stages each window of kStage slots in
// shared memory before it is stored in order.
__device__ __forceinline__ void extract_row(
    const uint32_t *__restrict__ row, int wpr, int32_t a, int32_t b0,
    int count, int64_t start, int64_t total, uint32_t (&x)[4],
    int32_t *stage, int32_t *__restrict__ ga, int32_t *__restrict__ gb) {
  const int lane = threadIdx.x & 31;
  int64_t base = start;
  for (int w0 = 0; w0 < wpr; w0 += 128) {
    const int w = w0 + 4 * lane;
    if (w0 > 0) row_words4(row, w, wpr, x);
    const int bits =
        __popc(x[0]) + __popc(x[1]) + __popc(x[2]) + __popc(x[3]);
    int incl = bits;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += v;
    }
    const int pass = __shfl_sync(kFull, incl, 31);
    if (base + pass > total) __trap();
    // the lane's pairs are slots incl - bits .. incl - 1 of the pass: a
    // pass of at most kDirect pairs (nearly all) spans a few sectors, and
    // each lane stores its own; a larger one is staged
    if (pass <= kDirect) {
      int64_t pos = base + incl - bits;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t word = x[i];
        while (word) {
          const int bit = __ffs(word) - 1;
          word &= word - 1;
          ga[pos] = a;
          gb[pos] = b0 + (w + i) * 32 + bit;
          ++pos;
        }
      }
    }
    for (int win = 0; pass > kDirect && win < pass; win += kStage) {
      int slot = incl - bits;
      if (slot < win + kStage && incl > win) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t word = x[i];
          while (word) {
            const int bit = __ffs(word) - 1;
            word &= word - 1;
            if (slot >= win && slot < win + kStage)
              stage[slot - win] = b0 + (w + i) * 32 + bit;
            ++slot;
          }
        }
      }
      __syncwarp();
      const int span = min(pass - win, kStage);
      for (int s = lane; s < span; s += 32) {
        ga[base + win + s] = a;
        gb[base + win + s] = stage[s];
      }
      __syncwarp();
    }
    base += pass;
  }
  if (base != start + count) __trap();
}

// Group grp of 32 rows (nothing past the last): the lane's row's count
// and offset, the group's first global row a0 and first column b0. T is
// a multiple of 32, so a group is 32 rows of one step; groups number
// fewer than 2^32 (their words would not fit in memory).
__device__ __forceinline__ void group_rows(
    const int32_t *__restrict__ counts, const int64_t *__restrict__ offsets,
    const int32_t *__restrict__ tis, const int32_t *__restrict__ tjs, int T,
    int64_t n_rows, int64_t grp, int &count, int64_t &start, int &a0,
    int &b0) {
  const int64_t mine = grp * 32 + (threadIdx.x & 31);
  count = 0;
  start = 0;
  a0 = b0 = 0;
  if (mine < n_rows) {
    count = counts[mine];
    start = offsets[mine];
  }
  if (grp * 32 < n_rows) {
    const uint32_t wpr = T / 32, k = (uint32_t)grp / wpr;
    a0 = tis[k] * T + (int)((uint32_t)grp % wpr) * 32;
    b0 = tjs[k] * T;
  }
}

// Persistent warps walk groups of 32 rows: one load of their counts and
// offsets (the next group's in flight while a group is walked), a ballot
// of the rows that hold survivors, and those rows' first words loaded
// kRowBatch rows at a time before their pairs are written.
__global__ void __launch_bounds__(32 * kExtractWarps)
d2_extract_kernel(const uint32_t *__restrict__ words,
                  const int32_t *__restrict__ counts,
                  const int64_t *__restrict__ offsets,
                  const int32_t *__restrict__ tis,
                  const int32_t *__restrict__ tjs, int T, int64_t n_rows,
                  int64_t total, int32_t *__restrict__ ga,
                  int32_t *__restrict__ gb) {
  __shared__ int32_t stages[kExtractWarps][kStage];
  int32_t *stage = stages[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  const int wpr = T / 32;
  const int64_t n_groups = (n_rows + 31) / 32;
  const int64_t n_warps = (int64_t)gridDim.x * kExtractWarps;
  int64_t grp = (int64_t)blockIdx.x * kExtractWarps + threadIdx.x / 32;
  int count, a0, b0;  // the lane's row's count; the group's rows, columns
  int64_t start;      // the lane's row's offset
  group_rows(counts, offsets, tis, tjs, T, n_rows, grp, count, start, a0,
             b0);
  for (; grp < n_groups; grp += n_warps) {
    const int my_count = count, my_a0 = a0, my_b0 = b0;
    const int64_t my_start = start;
    // the next group's, in flight while this one is walked
    group_rows(counts, offsets, tis, tjs, T, n_rows, grp + n_warps, count,
               start, a0, b0);
    unsigned rows = __ballot_sync(kFull, my_count != 0);
    while (rows) {
      int src[kRowBatch];
      uint32_t x[kRowBatch][4];
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        src[j] = rows ? __ffs(rows) - 1 : -1;
        rows &= rows - 1;
        if (src[j] >= 0)
          row_words4(words + (grp * 32 + src[j]) * wpr, 4 * lane, wpr, x[j]);
      }
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j)
        if (src[j] >= 0)
          extract_row(words + (grp * 32 + src[j]) * wpr, wpr, my_a0 + src[j],
                      my_b0, __shfl_sync(kFull, my_count, src[j]),
                      __shfl_sync(kFull, my_start, src[j]), total, x[j],
                      stage, ga, gb);
    }
  }
}

// the blocks of `threads` (dynamic shared memory `smem`) resident at once
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            int64_t *slots) {
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *slots = (int64_t)max(per_sm, 1) * sms;
  return err;
}

// row parts of a screen item: of 1..4 (at most the row tiles), the
// fewest whose items fill the last wave of `slots` blocks best (by more
// than 2%)
int screen_parts(int64_t items, int row_tiles, int64_t slots) {
  int parts = 1;
  double best = 0.0;
  for (int p = 1; p <= 4 && p <= row_tiles; ++p) {
    const int64_t m = items * p;
    const double fill = (double)m / (double)(((m + slots - 1) / slots) * slots);
    if (fill > best + 0.02) {
      parts = p;
      best = fill;
    }
  }
  return parts;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// after the launch, or the error of the set-up it needs
// (cudaErrorInvalidValue for a tile the kernel does not take: T a
// positive multiple of 32; profiles and words on 16 bytes). Nothing is
// launched for no steps.

extern "C" int swarm_d2_screen(const void *prof, const void *lengths,
                               const void *tis, const void *tjs,
                               int64_t n_steps, int T, int64_t n, int d,
                               void *words, void *counts, void *stream) {
  if (T <= 0 || T % 32 || (uintptr_t)prof % 16)
    return (int)cudaErrorInvalidValue;
  if (n_steps <= 0) return 0;
  const int col_blocks = (T + kCols - 1) / kCols;
  int64_t slots;
  cudaError_t err = cudaFuncSetAttribute(
      d2_screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kScreenSmem);
  if (err == cudaSuccess)
    err = resident_blocks(d2_screen_kernel, kScreenThreads, kScreenSmem,
                          &slots);
  if (err != cudaSuccess) return (int)err;
  const int parts = screen_parts(n_steps * col_blocks,
                                 (T + kRows - 1) / kRows, slots);
  const int64_t n_items = n_steps * col_blocks * parts;
  d2_screen_kernel<<<(unsigned)min(n_items, slots), kScreenThreads,
                     kScreenSmem, (cudaStream_t)stream>>>(
      (const uint4 *)prof, (const int32_t *)lengths, (const int32_t *)tis,
      (const int32_t *)tjs, n_items, col_blocks, parts, T, n, d,
      (uint32_t *)words, (int32_t *)counts);
  return (int)cudaGetLastError();
}

extern "C" int swarm_d2_extract(const void *words, const void *counts,
                                const void *offsets, const void *tis,
                                const void *tjs, int64_t n_steps, int T,
                                int64_t total, void *ga, void *gb,
                                void *stream) {
  if (T <= 0 || T % 32 || (uintptr_t)words % 16)
    return (int)cudaErrorInvalidValue;
  if (n_steps <= 0 || total <= 0) return 0;
  const int64_t n_rows = n_steps * T;
  int64_t slots;
  const cudaError_t err =
      resident_blocks(d2_extract_kernel, 32 * kExtractWarps, 0, &slots);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      ((n_rows + 31) / 32 + kExtractWarps - 1) / kExtractWarps;
  d2_extract_kernel<<<(unsigned)min(blocks, slots), 32 * kExtractWarps, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t *)words, (const int32_t *)counts,
      (const int64_t *)offsets, (const int32_t *)tis, (const int32_t *)tjs, T,
      n_rows, total, (int32_t *)ga, (int32_t *)gb);
  return (int)cudaGetLastError();
}
