// Explicitly rounded float32 helpers shared by the kernels' headers.
//
// Each product and sum is rounded on its own (__fmul_rn / __fadd_rn): nvcc
// would otherwise contract a*b + c*d into an FMA, and the plain PyTorch
// versions, which round every operation, would then differ from the
// kernels in the last bit.

#pragma once

namespace collide2d {

// a*b + c*d, both products and the sum rounded on their own.
__device__ __forceinline__ float dot2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

}  // namespace collide2d
