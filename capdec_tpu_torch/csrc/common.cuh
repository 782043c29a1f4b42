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
// order over groups of `width` neighbouring lanes (a power of two up to
// 32); every lane of a group ends with the group's pair.
template <int width = 32>
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ranks_before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// mbarriers, as the asynchronous-copy kernels use them.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier whose phase completes after `count` arrivals.
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

}  // namespace capdec
