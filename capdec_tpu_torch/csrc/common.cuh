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
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// 16 consecutive values as f32, read with 16-byte loads (p 16-byte aligned).
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4* w = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = w[i];
    f[4 * i] = x.x;
    f[4 * i + 1] = x.y;
    f[4 * i + 2] = x.z;
    f[4 * i + 3] = x.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4* w = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 x = w[i];
    const unsigned u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // bf16 -> f32 is exact: the top 16 bits
      f[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
      f[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}
// 16 int8 levels as f32, one 16-byte load (p 16-byte aligned).
__device__ __forceinline__ void load16(const int8_t* p, float* f) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  const int u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)  // byte j, sign-extended
      f[4 * i + j] = static_cast<float>(
          static_cast<int>(static_cast<unsigned>(u[i]) << (24 - 8 * j)) >> 24);
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

// Decode attention's head layout: a warp holds one head slice of
// head_dim <= 32·MAX_J values, lane owning dims lane + 32·j (j < nj).
constexpr int MAX_J = 4;  // head_dim <= 128

// A warp's dot product of q (lane holds dims lane + 32·j in qv) with one
// row's head slice, summed over the warp.
template <typename T>
__device__ __forceinline__ float head_dot(const float (&qv)[MAX_J],
                                          const T* row, int lane, int nj) {
  float p = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_J; ++j)
    if (j < nj) p = fmaf(qv[j], to_f32(row[lane + 32 * j]), p);
  return warp_sum(p);
}

// acc += e · row over the lane's dims lane + 32·j.
template <typename T>
__device__ __forceinline__ void head_axpy(float (&acc)[MAX_J], float e,
                                          const T* row, int lane, int nj) {
#pragma unroll
  for (int j = 0; j < MAX_J; ++j)
    if (j < nj) acc[j] = fmaf(e, to_f32(row[lane + 32 * j]), acc[j]);
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
