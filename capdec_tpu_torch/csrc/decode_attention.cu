// K6: one layer's beam-decode attention over an int8 generated cache, on
// the warp-per-beam template beam_attn.
//
// Replaces capdec_tpu/ops/decode_attention.py::beam_decode_attention_rowmajor_q
// (pl.pallas_call at :684, body _kernel_rm_q :244-323). The function is
// K2's (::beam_decode_attention_rowmajor, which runs with K8, K9 and K15
// on decode_attention_async.cu): for each beam row b of image n = b / R
// and each head, a softmax over three slot sets:
//   * the image's shared prefix  pk/pv [L, N, K, D]  (all K slots),
//   * the row's generated slots  gk/gv [B, L, E, D]  below n_gen,
//   * the current token          k_new/v_new [B, D],
// then the probability-weighted sum of V, written as f32 out [B, D].
// n_gen = min(step, e_cap): slots at or above `step` are never read, so
// stale or NaN bits there (after a bounded fork copy) cannot reach the sum.
// gk/gv hold int8 levels and gks/gvs their f32 absmax scales [B, L, 1, E]
// (value = level · scale, written by K5). A generated slot's score is
// dot(q, level_k) · (ks[slot] · scale): the head sum first, then the
// scale, as in the TPU kernel (:284-285); the V scale folds into the
// slot's probability (:300-307). The scales keep the full slot width E
// even when e_cap bounds the read, and slots at or above n_gen are never
// read, neither their levels nor their scales.
//
// Bound on the H100: bytes. Per call it reads one layer's prefix cache once
// (2·N·K·D), each row's live generated levels (2·B·n_gen·D) and scales,
// and q/k/v, and does about 4 FLOPs per byte read.
//
// Design: one block per (head, image), one warp per beam of that image.
// The block stages the image's prefix K/V head slice in shared memory
// once and serves its R beams from there, so the prefix leaves device
// memory once per image instead of once per beam. Each lane owns head
// dims lane + 32·j; a prefix slot's score is a warp-sum of the lanes'
// partial dot products (real per-head reductions over head_dim, f32, scale
// 1/sqrt(hd)). The generated slots change layout so that every level
// arrives in a 16-byte load: a slot's head slice (head_dim bytes) is split
// over head_dim/16 lanes, each owning 16 consecutive dims, so a warp
// scores 512/head_dim slots at a time (lane groups reduce with shuffles).
// The value pass accumulates in the same layout; the groups then reduce
// across the warp and hand the per-dim partial to the head layout through
// shared memory. The TPU kernel's 0/1 head-grouping matmul and its 8-slot
// prefix padding were Mosaic workarounds and are not carried over. The
// template keeps its generated-slot policy (Gen = GenSlotsInt8) apart from
// the prefix, the current token, the softmax and the output.
#include "common.cuh"

namespace capdec {
namespace {

// K6's generated slots: int8 levels with f32 scales [B, L, 1, E]. A slot's
// head slice is split over hd/16 lanes of 16 consecutive dims each, so
// every level arrives in a 16-byte load and a warp takes 512/hd slots at a
// time.
struct GenSlotsInt8 {
  const int8_t* gk;
  const int8_t* gv;
  const float* gks;
  const float* gvs;

  template <typename T>
  __device__ void score(const T* qrow, const float (&)[MAX_J], float* sc,
                        size_t bl, int h, int n, int E, int D, int hd,
                        int lane, int, float scale) const {
    const int lps = hd / 16, spp = 32 / lps;
    const int sub = lane % lps, grp = lane / lps;
    float q16[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) q16[i] = to_f32(qrow[16 * sub + i]);
    const int8_t* base = gk + bl * E * D + (size_t)h * hd + 16 * sub;
    const float* ks = gks + bl * E;
    for (int s0 = 0; s0 < n; s0 += spp) {
      const int s = s0 + grp;
      float p = 0.f;
      if (s < n) {
        float lev[16];
        load16(base + (size_t)s * D, lev);
#pragma unroll
        for (int i = 0; i < 16; ++i) p = fmaf(q16[i], lev[i], p);
      }
      for (int off = 1; off < lps; off <<= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (sub == 0 && s < n) sc[s] = p * (ks[s] * scale);
    }
  }

  __device__ void value(float (&acc)[MAX_J], const float* sc, float* part,
                        size_t bl, int h, int n, int E, int D, int hd,
                        int lane, int nj) const {
    const int lps = hd / 16, spp = 32 / lps;
    const int sub = lane % lps, grp = lane / lps;
    const int8_t* base = gv + bl * E * D + (size_t)h * hd + 16 * sub;
    const float* vs = gvs + bl * E;
    float a16[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) a16[i] = 0.f;
    for (int s0 = 0; s0 < n; s0 += spp) {
      const int s = s0 + grp;
      if (s < n) {
        const float e = sc[s] * vs[s];
        float lev[16];
        load16(base + (size_t)s * D, lev);
#pragma unroll
        for (int i = 0; i < 16; ++i) a16[i] = fmaf(e, lev[i], a16[i]);
      }
    }
    for (int off = lps; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < 16; ++i)
        a16[i] += __shfl_xor_sync(0xffffffffu, a16[i], off);
    if (grp == 0)
#pragma unroll
      for (int i = 0; i < 16; ++i) part[16 * sub + i] = a16[i];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < MAX_J; ++j)
      if (j < nj) acc[j] += part[lane + 32 * j];
  }
};

template <typename T, typename Gen>
__global__ void beam_attn(const T* __restrict__ q, const T* __restrict__ kn,
                          const T* __restrict__ vn, long qs,
                          const T* __restrict__ pk, const T* __restrict__ pv,
                          Gen gen, float* __restrict__ out, int N, int R,
                          int L, int K, int E, int D, int hd, int layer,
                          int n_gen, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = K + n_gen + 1;
  float* pks = smem;                 // [K][hd]
  float* pvs = pks + K * hd;         // [K][hd]
  float* part = pvs + K * hd + warp * hd;  // [hd] per warp
  float* sc = pvs + K * hd + R * hd + warp * S;

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
  const size_t bl = (size_t)b * L + layer;
  float qv[MAX_J];
#pragma unroll
  for (int j = 0; j < MAX_J; ++j)
    qv[j] = j < nj ? to_f32(q[qoff + lane + 32 * j]) : 0.f;

  for (int s = 0; s < K; ++s) {
    const float p = head_dot(qv, pks + s * hd, lane, nj);
    if (lane == 0) sc[s] = p * scale;
  }
  gen.score(q + qoff, qv, sc + K, bl, h, n_gen, E, D, hd, lane, nj, scale);
  {
    const float p = head_dot(qv, kn + qoff, lane, nj);
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
  for (int s = 0; s < K; ++s) head_axpy(acc, sc[s], pvs + s * hd, lane, nj);
  gen.value(acc, sc + K, part, bl, h, n_gen, E, D, hd, lane, nj);
  head_axpy(acc, sc[K + n_gen], vn + qoff, lane, nj);
  const float inv = 1.f / l;
  float* orow = out + (size_t)b * D + (size_t)h * hd;
#pragma unroll
  for (int j = 0; j < MAX_J; ++j)
    if (j < nj) orow[lane + 32 * j] = acc[j] * inv;
}

template <typename T, typename Gen>
cudaError_t launch(const void* q, const void* kn, const void* vn, long qs,
                   const void* pk, const void* pv, Gen gen, float* out,
                   int N, int R, int L, int K, int E, int D, int hd,
                   int layer, int n_gen, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * K * hd + R * hd +
                               R * (K + n_gen + 1)) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_attn<T, Gen>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(D / hd, N);
  beam_attn<T, Gen><<<grid, 32 * R, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), qs, static_cast<const T*>(pk),
      static_cast<const T*>(pv), gen, out, N, R, L, K, E, D, hd, layer,
      n_gen, 1.f / sqrtf((float)hd));
  return cudaGetLastError();
}

}  // namespace
}  // namespace capdec

extern "C" int capdec_beam_decode_attention_rowmajor_q(
    const void* q, const void* kn, const void* vn, long qs, const void* pk,
    const void* pv, const int8_t* gk, const int8_t* gv, const float* gks,
    const float* gvs, float* out, int N, int R, int L, int K, int E, int D,
    int hd, int layer, int n_gen, int dtype, cudaStream_t stream) {
  const capdec::GenSlotsInt8 gen{gk, gv, gks, gvs};
  cudaError_t err =
      dtype == capdec::kBF16
          ? capdec::launch<__nv_bfloat16>(q, kn, vn, qs, pk, pv, gen, out, N,
                                          R, L, K, E, D, hd, layer, n_gen,
                                          stream)
          : capdec::launch<float>(q, kn, vn, qs, pk, pv, gen, out, N, R, L,
                                  K, E, D, hd, layer, n_gen, stream);
  return static_cast<int>(err);
}
