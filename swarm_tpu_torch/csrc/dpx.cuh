// Helpers shared by the integer DP kernels of this directory.

#pragma once

#include <cstdint>

// a + b * one, where `one` is 1 at run time but unknown to the compiler:
// the add runs as an integer multiply-add on the FMA pipe and leaves
// the ALU pipe, which bounds these kernels, to the mins and logic.
__device__ __forceinline__ int fma_add(int a, int b, int one) {
  asm("mad.lo.s32 %0, %1, %2, %0;" : "+r"(a) : "r"(b), "r"(one));
  return a;
}

// 16 codes of a row (one byte each, 16 bytes as loaded) as 2 bits each,
// lowest index in the lowest bits. Codes are taken modulo 4.
__device__ __forceinline__ uint32_t pack_codes16(uint4 v) {
  auto squeeze = [](uint32_t w) {  // 4 bytes -> 8 bits
    w &= 0x03030303u;
    w = (w | (w >> 6)) & 0x000f000fu;
    return (w | (w >> 12)) & 0xffu;
  };
  return squeeze(v.x) | (squeeze(v.y) << 8) | (squeeze(v.z) << 16) |
         (squeeze(v.w) << 24);
}

// `v` as a register whose origin the compiler does not know, so that it
// is held across a loop instead of re-read from the kernel's arguments
// at every use.
__device__ __forceinline__ int in_register(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
