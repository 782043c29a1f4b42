// residual_rmsnorm: the residual sum and the RMSNorm of a decoder block of
// models/mla_moe.py in one pass, one warp a row: x (f32, the residual
// stream) += y (the block's bf16 output), or x = y (`assign`: the step's
// token embeddings), then h = x / sqrt(mean(x^2) + eps) * w in f32, rounded
// to bf16 for the next products. No TPU counterpart. Bound: bytes (x read
// and written in f32, y read and h written in bf16); it replaces a chain of
// seven plain ops (add, square, mean, rsqrt, two products, a cast).
#include "common.cuh"

namespace capdec {
namespace {

template <bool kAssign>
__global__ void residual_rmsnorm(float* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ y,
                                 long y_row, const float* __restrict__ w,
                                 __nv_bfloat16* __restrict__ h, int B, int D,
                                 float eps) {
  constexpr int kPer = 8;  // 8-value words a lane holds: D <= 2048
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  float* xr = x + (size_t)row * D;
  const __nv_bfloat16* yr = y + row * y_row;
  float v[kPer][8];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int e = (lane + 32 * c) * 8;
    if (e < D) {
      const uint4 yw = *reinterpret_cast<const uint4*>(yr + e);
      const unsigned u[4] = {yw.x, yw.y, yw.z, yw.w};
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (!kAssign) {
        a = reinterpret_cast<const float4*>(xr + e)[0];
        b = reinterpret_cast<const float4*>(xr + e)[1];
      }
      const float xs[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[c][2 * i] = xs[2 * i] + __uint_as_float(u[i] << 16);
        v[c][2 * i + 1] = xs[2 * i + 1] + __uint_as_float(u[i] & 0xffff0000u);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) ss += v[c][i] * v[c][i];
      reinterpret_cast<float4*>(xr + e)[0] =
          make_float4(v[c][0], v[c][1], v[c][2], v[c][3]);
      reinterpret_cast<float4*>(xr + e)[1] =
          make_float4(v[c][4], v[c][5], v[c][6], v[c][7]);
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / D + eps);
  __nv_bfloat16* hr = h + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int e = (lane + 32 * c) * 8;
    if (e < D) {
      unsigned p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 q = __floats2bfloat162_rn(
            __fmul_rn(__fmul_rn(v[c][2 * i], inv), w[e + 2 * i]),
            __fmul_rn(__fmul_rn(v[c][2 * i + 1], inv), w[e + 2 * i + 1]));
        p[i] = *reinterpret_cast<const unsigned*>(&q);
      }
      *reinterpret_cast<uint4*>(hr + e) = make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
}

}  // namespace
}  // namespace capdec

extern "C" int capdec_residual_rmsnorm(float* x, const void* y, long y_row,
                                       const float* w, void* h, int B, int D,
                                       float eps, int assign,
                                       cudaStream_t stream) {
  using namespace capdec;
  if (B < 1 || D < 8 || D % 8 || D > 2048 || y_row % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + 3) / 4), block(128);
  const auto* yy = static_cast<const __nv_bfloat16*>(y);
  auto* hh = static_cast<__nv_bfloat16*>(h);
  if (assign)
    residual_rmsnorm<true><<<grid, block, 0, stream>>>(x, yy, y_row, w, hh, B,
                                                       D, eps);
  else
    residual_rmsnorm<false><<<grid, block, 0, stream>>>(x, yy, y_row, w, hh,
                                                        B, D, eps);
  return static_cast<int>(cudaGetLastError());
}
