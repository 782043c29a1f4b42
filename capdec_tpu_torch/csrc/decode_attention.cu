// K2: one layer's beam-decode attention over split, row-major KV caches.
//
// Replaces capdec_tpu/ops/decode_attention.py::beam_decode_attention_rowmajor
// (pl.pallas_call at :765, body _kernel_rm :186-241). For each beam row b
// of image n = b / R and each head, a softmax over three slot sets:
//   * the image's shared prefix  pk/pv [L, N, K, D]  (all K slots),
//   * the row's generated slots  gk/gv [B, L, E, D]  below n_gen,
//   * the current token          k_new/v_new [B, D],
// then the probability-weighted sum of V, written as f32 out [B, D].
// n_gen = min(step, e_cap): slots at or above `step` are never read, so
// stale or NaN bits there (after a bounded fork copy) cannot reach the sum.
//
// Bound on the H100: bytes. Per call it reads one layer's prefix cache once
// (2·N·K·D), each row's live generated slots (2·B·n_gen·D) and q/k/v, and
// does about 4 FLOPs per byte read.
//
// Design: one block per (head, image), one warp per beam of that image.
// The block stages the image's prefix K/V head slice in shared memory
// once and serves its R beams from there, so the prefix leaves device
// memory once per image instead of once per beam. Each lane owns head
// dims lane + 32·j; a slot's score is a warp-sum of the lanes' partial
// dot products (real per-head reductions over head_dim, f32, scale
// 1/sqrt(hd)). The TPU kernel's 0/1 head-grouping matmul and its 8-slot
// prefix padding were Mosaic workarounds and are not carried over.
#include "common.cuh"

namespace capdec {
namespace {

constexpr int MAX_J = 4;  // head_dim <= 128

template <typename T>
__global__ void beam_attn_rowmajor(
    const T* __restrict__ q, const T* __restrict__ kn,
    const T* __restrict__ vn, long qs, const T* __restrict__ pk,
    const T* __restrict__ pv, const T* __restrict__ gk,
    const T* __restrict__ gv, float* __restrict__ out, int N, int R, int L,
    int K, int E, int D, int hd, int layer, int n_gen, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = K + n_gen + 1;
  float* pks = smem;               // [K][hd]
  float* pvs = pks + K * hd;       // [K][hd]
  float* sc = pvs + K * hd + warp * S;  // this warp's slot weights

  const size_t pbase = (((size_t)layer * N + n) * K) * D + (size_t)h * hd;
  for (int e = threadIdx.x; e < K * hd; e += blockDim.x) {
    const int s = e / hd, d = e % hd;
    pks[e] = to_f32(pk[pbase + (size_t)s * D + d]);
    pvs[e] = to_f32(pv[pbase + (size_t)s * D + d]);
  }
  __syncthreads();

  const int b = n * R + warp;
  const int nj = hd / 32;
  const size_t qoff = (size_t)b * qs + (size_t)h * hd;
  float qv[MAX_J];
#pragma unroll
  for (int j = 0; j < MAX_J; ++j)
    qv[j] = j < nj ? to_f32(q[qoff + lane + 32 * j]) : 0.f;

  for (int s = 0; s < K; ++s) {
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_J; ++j)
      if (j < nj) p = fmaf(qv[j], pks[s * hd + lane + 32 * j], p);
    p = warp_sum(p);
    if (lane == 0) sc[s] = p * scale;
  }
  const size_t gbase = (((size_t)b * L + layer) * E) * D + (size_t)h * hd;
  for (int s = 0; s < n_gen; ++s) {
    const T* krow = gk + gbase + (size_t)s * D;
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_J; ++j)
      if (j < nj) p = fmaf(qv[j], to_f32(krow[lane + 32 * j]), p);
    p = warp_sum(p);
    if (lane == 0) sc[K + s] = p * scale;
  }
  {
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_J; ++j)
      if (j < nj) p = fmaf(qv[j], to_f32(kn[qoff + lane + 32 * j]), p);
    p = warp_sum(p);
    if (lane == 0) sc[K + n_gen] = p * scale;
  }
  __syncwarp();

  float m = -INFINITY;
  for (int s = lane; s < S; s += 32) m = fmaxf(m, sc[s]);
  m = warp_max(m);
  float l = 0.f;
  for (int s = lane; s < S; s += 32) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    l += e;
  }
  l = warp_sum(l);
  __syncwarp();

  float acc[MAX_J];
#pragma unroll
  for (int j = 0; j < MAX_J; ++j) acc[j] = 0.f;
  for (int s = 0; s < K; ++s) {
    const float e = sc[s];
#pragma unroll
    for (int j = 0; j < MAX_J; ++j)
      if (j < nj) acc[j] = fmaf(e, pvs[s * hd + lane + 32 * j], acc[j]);
  }
  for (int s = 0; s < n_gen; ++s) {
    const float e = sc[K + s];
    const T* vrow = gv + gbase + (size_t)s * D;
#pragma unroll
    for (int j = 0; j < MAX_J; ++j)
      if (j < nj) acc[j] = fmaf(e, to_f32(vrow[lane + 32 * j]), acc[j]);
  }
  {
    const float e = sc[K + n_gen];
#pragma unroll
    for (int j = 0; j < MAX_J; ++j)
      if (j < nj) acc[j] = fmaf(e, to_f32(vn[qoff + lane + 32 * j]), acc[j]);
  }
  const float inv = 1.f / l;
  float* orow = out + (size_t)b * D + (size_t)h * hd;
#pragma unroll
  for (int j = 0; j < MAX_J; ++j)
    if (j < nj) orow[lane + 32 * j] = acc[j] * inv;
}

template <typename T>
cudaError_t launch(const void* q, const void* kn, const void* vn, long qs,
                   const void* pk, const void* pv, const void* gk,
                   const void* gv, float* out, int N, int R, int L, int K,
                   int E, int D, int hd, int layer, int n_gen,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(2 * K * hd + R * (K + n_gen + 1)) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_attn_rowmajor<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(D / hd, N);
  beam_attn_rowmajor<T><<<grid, 32 * R, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), qs, static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const T*>(gk),
      static_cast<const T*>(gv), out, N, R, L, K, E, D, hd, layer, n_gen,
      1.f / sqrtf((float)hd));
  return cudaGetLastError();
}

}  // namespace
}  // namespace capdec

extern "C" int capdec_beam_decode_attention_rowmajor(
    const void* q, const void* kn, const void* vn, long qs, const void* pk,
    const void* pv, const void* gk, const void* gv, float* out, int N, int R,
    int L, int K, int E, int D, int hd, int layer, int n_gen, int dtype,
    cudaStream_t stream) {
  cudaError_t err =
      dtype == capdec::kBF16
          ? capdec::launch<__nv_bfloat16>(q, kn, vn, qs, pk, pv, gk, gv, out,
                                          N, R, L, K, E, D, hd, layer, n_gen,
                                          stream)
          : capdec::launch<float>(q, kn, vn, qs, pk, pv, gk, gv, out, N, R, L,
                                  K, E, D, hd, layer, n_gen, stream);
  return static_cast<int>(err);
}
