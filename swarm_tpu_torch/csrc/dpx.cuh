// Helpers shared by the integer DP kernels of this directory.

#pragma once

// a + b * one, where `one` is 1 at run time but unknown to the compiler:
// the add runs as an integer multiply-add on the FMA pipe and leaves
// the ALU pipe, which bounds these kernels, to the mins and logic.
__device__ __forceinline__ int fma_add(int a, int b, int one) {
  asm("mad.lo.s32 %0, %1, %2, %0;" : "+r"(a) : "r"(b), "r"(one));
  return a;
}
