// Shared helpers of the capdec_tpu_torch Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace capdec {

// dtype codes passed by the Python wrappers (ops/_build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Selection order of lax.top_k: value descending, lowest index on ties.
__device__ __forceinline__ bool ranks_before(float av, int ai, float bv,
                                             int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Butterfly reduction to the first (value, index) pair in selection
// order; every lane ends with the same pair.
__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ranks_before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

}  // namespace capdec
