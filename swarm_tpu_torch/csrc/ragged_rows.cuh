// The ragged 2-bit rows read by csrc/d1_join.cu and csrc/graft.cu: row i
// of length L takes 4 * ceil(L / 64) words from word row_word[i] (base j
// at bits 2 * (j % 16) of word j / 16, zero past L).

#pragma once

#include <cstdint>

namespace {

constexpr uint32_t kOdd = 0x55555555u;  // low bit of every 2-bit field

// fields [0, k) of a word, for k of any sign
__device__ __forceinline__ uint32_t field_mask(int k) {
  return k >= 16 ? 0xFFFFFFFFu : k <= 0 ? 0u : (1u << (2 * k)) - 1u;
}

// one bit (the field's low bit) for every 2-bit field that is not zero
__device__ __forceinline__ uint32_t nonzero_fields(uint32_t x) {
  return (x | (x >> 1)) & kOdd;
}

// words of a row of len bases: whole uint4s of 64 bases
__device__ __forceinline__ int64_t row_size(int len) {
  return 4 * (((int64_t)len + 63) / 64);
}

// row_word[row] of n rows, after the layout's checks: a start that is not
// a multiple of 4, words past n_words or a last row that does not end at
// n_words traps
__device__ __forceinline__ int64_t row_start(const int64_t *row_word,
                                             int64_t row, int64_t n, int len,
                                             int64_t n_words) {
  const int64_t start = row_word[row];
  const int64_t end = start + row_size(len);
  if (len < 0 || start < 0 || (start & 3) || end > n_words ||
      (row == n - 1 && end != n_words))
    __trap();
  return start;
}

}  // namespace
