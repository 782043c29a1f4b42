// The routed-expert layer's glue around its grouped products (ops/moe.py):
// the router's choice, the sort of the token-expert pairs by expert, the
// SwiGLU between the two products, and the weighted combine back into the
// residual stream. No TPU counterpart (the JAX package decodes GPT-2 only).
//
// moe_route: one warp a token. The sigmoid scores of its E <= 64 router
// logits (f32), the top k of score + e_score_correction_bias (DeepSeek-V3's
// `noaux_tc` with one group: the bias moves the choice only), taken in k
// rounds of a warp-wide arg-max (lowest expert on ties), and the chosen
// experts' unbiased scores, divided by their sum (+ 1e-20) where
// `norm_topk_prob` and scaled by `routed_scaling_factor`.
//
// moe_dispatch: one block. Shared-memory counts of the token-expert pairs
// by expert, their running sum (offs: each expert's end, as the grouped
// products take it), and each pair's place in expert order by an atomic
// cursor: pos[t k + j] is the row of pair (t, j) in the sorted order and
// token_of[row] its token. Within an expert the order is the atomics', so
// it may differ from run to run; a row's products do not depend on the
// rows beside it, so the values do not. Adds the counts to a layer's row
// of the caller's counter (CaptionServer.stats["expert_rows"]) when given.
//
// swiglu: silu(g) * u in f32, rounded to bf16, from two strided [M, I]
// views (the halves of the fused gate|up product, or two products).
//
// moe_combine: one warp a token: x[t] += sum_j w[t, j] y[pos[t, j]] in f32,
// j in order, into the f32 residual stream.
#include "common.cuh"

namespace capdec {
namespace {

constexpr int kMaxExperts = 64;
constexpr int kMaxTopK = 8;

__global__ void moe_route(const float* __restrict__ logits,
                          const float* __restrict__ bias, int T, int E, int k,
                          int norm, float scaling, int* __restrict__ idx,
                          float* __restrict__ w) {
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= T) return;
  float s[2], c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = lane + 32 * i;
    if (e < E) {
      const float x = logits[(size_t)t * E + e];
      s[i] = 1.f / (1.f + expf(-x));
      c[i] = s[i] + bias[e];
    } else {
      s[i] = 0.f;
      c[i] = -INFINITY;
    }
  }
  float picked[kMaxTopK];
  int at[kMaxTopK];
  float sum = 0.f;
  for (int j = 0; j < k; ++j) {
    const bool hi = c[1] > c[0];  // lane + 32 ranks first only if larger
    float bv = hi ? c[1] : c[0];
    int bi = hi ? lane + 32 : lane;
    warp_best(bv, bi);
    const int owner = bi & 31, half = bi >> 5;
    const float sv = __shfl_sync(0xffffffffu, half ? s[1] : s[0], owner);
    if (lane == owner) c[half] = -INFINITY;
    picked[j] = sv;
    at[j] = bi;
    sum += sv;
  }
  if (lane == 0) {
    const float f = norm ? scaling / (sum + 1e-20f) : scaling;
    for (int j = 0; j < k; ++j) {
      idx[(size_t)t * k + j] = at[j];
      w[(size_t)t * k + j] = picked[j] * f;
    }
  }
}

__global__ void __launch_bounds__(1024)
    moe_dispatch(const int* __restrict__ idx, int n, int k, int E,
                 int* __restrict__ offs, int* __restrict__ pos,
                 int* __restrict__ token_of, int* __restrict__ counter) {
  __shared__ int cnt[kMaxExperts];
  __shared__ int cur[kMaxExperts];
  const int tid = threadIdx.x;
  if (tid < E) cnt[tid] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) atomicAdd(&cnt[idx[i]], 1);
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int e = 0; e < E; ++e) {
      cur[e] = run;
      run += cnt[e];
      offs[e] = run;
    }
  }
  if (counter != nullptr && tid < E) counter[tid] += cnt[tid];
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    const int p = atomicAdd(&cur[idx[i]], 1);
    pos[i] = p;
    token_of[p] = i / k;
  }
}

__global__ void swiglu(const __nv_bfloat16* __restrict__ g, long g_row,
                       const __nv_bfloat16* __restrict__ u, long u_row,
                       __nv_bfloat16* __restrict__ out, long M, int I) {
  const int words = I / 8;
  const long n = M * words;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const long r = i / words;
    const int c = (int)(i % words) * 8;
    const uint4 gw = *reinterpret_cast<const uint4*>(g + r * g_row + c);
    const uint4 uw = *reinterpret_cast<const uint4*>(u + r * u_row + c);
    const unsigned gu[4] = {gw.x, gw.y, gw.z, gw.w};
    const unsigned uu[4] = {uw.x, uw.y, uw.z, uw.w};
    unsigned o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float g0 = __uint_as_float(gu[j] << 16);
      const float g1 = __uint_as_float(gu[j] & 0xffff0000u);
      const float u0 = __uint_as_float(uu[j] << 16);
      const float u1 = __uint_as_float(uu[j] & 0xffff0000u);
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          g0 / (1.f + expf(-g0)) * u0, g1 / (1.f + expf(-g1)) * u1);
      o[j] = *reinterpret_cast<const unsigned*>(&v);
    }
    *reinterpret_cast<uint4*>(out + r * I + c) = make_uint4(o[0], o[1], o[2],
                                                            o[3]);
  }
}

__global__ void moe_combine(float* __restrict__ x,
                            const __nv_bfloat16* __restrict__ y,
                            const int* __restrict__ pos,
                            const float* __restrict__ w, int T, int D, int k) {
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= T) return;
  float* xr = x + (size_t)t * D;
  for (int c = lane * 8; c < D; c += 256) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int j = 0; j < k; ++j) {
      const float wj = w[(size_t)t * k + j];
      const uint4 yw = *reinterpret_cast<const uint4*>(
          y + (size_t)pos[(size_t)t * k + j] * D + c);
      const unsigned u[4] = {yw.x, yw.y, yw.z, yw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[2 * i] += wj * __uint_as_float(u[i] << 16);
        acc[2 * i + 1] += wj * __uint_as_float(u[i] & 0xffff0000u);
      }
    }
    float4* xv = reinterpret_cast<float4*>(xr + c);
    float4 a = xv[0], b = xv[1];
    a.x += acc[0], a.y += acc[1], a.z += acc[2], a.w += acc[3];
    b.x += acc[4], b.y += acc[5], b.z += acc[6], b.w += acc[7];
    xv[0] = a;
    xv[1] = b;
  }
}

}  // namespace
}  // namespace capdec

extern "C" int capdec_moe_route(const float* logits, const float* bias, int T,
                                int E, int k, int norm, float scaling,
                                int* idx, float* w, cudaStream_t stream) {
  using namespace capdec;
  if (T < 1 || E < 1 || E > kMaxExperts || k < 1 || k > kMaxTopK || k > E)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_route<<<(T + 3) / 4, 128, 0, stream>>>(logits, bias, T, E, k, norm,
                                             scaling, idx, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int capdec_moe_dispatch(const int* idx, int n, int k, int E,
                                   int* offs, int* pos, int* token_of,
                                   int* counter, cudaStream_t stream) {
  using namespace capdec;
  if (n < 1 || k < 1 || n % k || E < 1 || E > kMaxExperts)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_dispatch<<<1, 1024, 0, stream>>>(idx, n, k, E, offs, pos, token_of,
                                       counter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int capdec_swiglu(const void* g, long g_row, const void* u,
                             long u_row, void* out, long M, int I,
                             int blocks, cudaStream_t stream) {
  if (M < 1 || I < 8 || I % 8 || g_row % 8 || u_row % 8 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  capdec::swiglu<<<blocks, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g), g_row,
      static_cast<const __nv_bfloat16*>(u), u_row,
      static_cast<__nv_bfloat16*>(out), M, I);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int capdec_moe_combine(float* x, const void* y, const int* pos,
                                  const float* w, int T, int D, int k,
                                  cudaStream_t stream) {
  if (T < 1 || D < 8 || D % 8 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  capdec::moe_combine<<<(T + 3) / 4, 128, 0, stream>>>(
      x, static_cast<const __nv_bfloat16*>(y), pos, w, T, D, k);
  return static_cast<int>(cudaGetLastError());
}
