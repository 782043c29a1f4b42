// K9: one layer's slot-bounded ("v3") beam-decode attention over an int8
// generated cache.
//
// Replaces capdec_tpu/ops/decode_attention.py::beam_decode_attention_chunked_q
// (pl.pallas_call at :620, body _kernel_rm_chunked :326-454 with int8
// scales), with or without an int8 prefix cache. K8, the same body over a
// bf16 or f32 cache (::beam_decode_attention_chunked, :484), runs on
// decode_attention_async.cu. K9 computes
// K2's function: for beam row b of image n = b / R and each head, a
// softmax over the image's prefix slots pk/pv [L, N, K, D], the row's
// generated slots gk/gv [B, L, E, D] below `step` and the current token,
// then the probability-weighted sum of V, written as f32 out [B, D].
//   * K9's generated cache holds int8 levels with f32 absmax scales
//     gks/gvs [B, L, 1, E] (value = level · scale). A slot's score is
//     dot(q, level_k) · (ks[slot] · scale), the head sum first; the V scale
//     folds into the slot's probability (TPU kernel :410-444).
//   * With pks/pvs (f32 [L, N, 1, K]) K9's prefix is int8 levels too: the
//     prefix K scale multiplies the score after the head sum, the prefix V
//     scale folds into the prefix probability (:373-392).
//
// Bound on the H100: bytes, as for K2. Per call it reads one layer's
// prefix once per image (2·N·K·D values; int8 levels plus 8·N·K scale
// bytes under an int8 prefix, half of a bf16 prefix), each row's
// generated slots below `step` (2·B·step·D levels and 8·B·step scale
// bytes) and q/k/v, and does about 4 operations per value read.
//
// Design: one block per (head, image), one warp per beam. The
// block stages the image's prefix head slice in shared memory once for
// its R beams (an int8 prefix leaves device memory as levels and sits in
// shared memory as f32 levels beside its scales). The warp scores the
// prefix and the current token in K2's head layout and starts the online
// softmax state (m, l, acc) from them. The TPU kernel carried that state
// across a sequential grid axis of `chunk`-slot blocks; blocks here run in
// no order, so a loop inside the warp walks the tiles of `chunk` slots
// below `step`, each in passes of 512/head_dim slots (one pass per 8-slot
// tile at head_dim 64). A slot's head slice is split over head_dim/16
// lanes of 16 consecutive dims, so every value arrives in 16-byte loads,
// as in K6. A pass loads its slots' K and V (and scales) together, then
// scores them, takes the pass max into m, rescales l and the value
// accumulator and adds the values, all in registers: the value loads do
// not wait for the softmax, and no shared memory lies on the chain (a
// tile scored through shared memory, with V loaded after its softmax, ran
// no faster than K2). Only slots below `step` are read, levels and scales
// alike, so stale or NaN bits at or above `step` (after a bounded fork
// copy) never reach a sum. At the end the lane groups' value sums meet
// K2's layout through shared memory. The chunk scales are indexed
// directly (the TPU kernel's one-hot matmul was a Mosaic workaround), and
// so are the head sums (its 0/1 head-grouping matmul and prefix padding
// are not ported).
#include "common.cuh"

namespace capdec {
namespace {

// K9's generated slots: int8 levels with f32 scales [B, L, 1, E].
struct ChunkGenInt8 {
  const int8_t* gk;
  const int8_t* gv;
  const float* gks;
  const float* gvs;
  __device__ float kscale(size_t i) const { return gks[i]; }
  __device__ float vscale(size_t i) const { return gvs[i]; }
};

// q/kn/vn of type T; prefix of type P (T, or int8 levels with pks/pvs).
template <typename T, typename P, typename Gen>
__global__ void chunk_attn(const T* __restrict__ q, const T* __restrict__ kn,
                           const T* __restrict__ vn, long qs,
                           const P* __restrict__ pk, const P* __restrict__ pv,
                           const float* __restrict__ pks,
                           const float* __restrict__ pvs, Gen gen,
                           float* __restrict__ out, int N, int R, int L,
                           int K, int E, int D, int hd, int layer, int n_gen,
                           int chunk, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pkf = smem;                                 // [K][hd]
  float* pvf = pkf + K * hd;                         // [K][hd]
  float* psc = pvf + K * hd;                         // [2][K]: K, V scales
  float* part = psc + 2 * K + warp * (hd + K + 1);   // [hd] per warp
  float* sc = part + hd;                             // [K + 1] per warp

  const size_t prow = ((size_t)layer * N + n) * K;
  const size_t pbase = prow * D + (size_t)h * hd;
  for (int e = threadIdx.x; e < K * hd; e += blockDim.x) {
    const int s = e / hd, d = e % hd;
    pkf[e] = to_f32(pk[pbase + (size_t)s * D + d]);
    pvf[e] = to_f32(pv[pbase + (size_t)s * D + d]);
  }
  for (int s = threadIdx.x; s < K; s += blockDim.x) {
    psc[s] = pks ? pks[prow + s] : 1.f;
    psc[K + s] = pvs ? pvs[prow + s] : 1.f;
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

  // The prefix and the current token start the softmax state (m, l, acc).
  for (int s = 0; s < K; ++s) {
    const float p = head_dot(qv, pkf + s * hd, lane, nj);
    if (lane == 0) sc[s] = p * (psc[s] * scale);
  }
  {
    const float p = head_dot(qv, kn + qoff, lane, nj);
    if (lane == 0) sc[K] = p * scale;
  }
  __syncwarp();
  float m = -INFINITY;
  for (int s = lane; s <= K; s += 32) m = fmaxf(m, sc[s]);
  m = warp_max(m);
  float l = 0.f;
  for (int s = lane; s <= K; s += 32) {
    const float e = expf(sc[s] - m);
    l += e;
    sc[s] = s < K ? e * psc[K + s] : e;  // the prefix V scale folds in
  }
  l = warp_sum(l);
  __syncwarp();
  float acc[MAX_J];
#pragma unroll
  for (int j = 0; j < MAX_J; ++j) acc[j] = 0.f;
  for (int s = 0; s < K; ++s) head_axpy(acc, sc[s], pvf + s * hd, lane, nj);
  head_axpy(acc, sc[K], vn + qoff, lane, nj);
  const float m0 = m;  // acc is rescaled once, at the end

  // The generated slots below n_gen, in tiles of `chunk` slots, each
  // taken in passes of spp slots: lane group grp holds slot s0 + grp of a
  // pass, lane sub its dims 16·sub .. 16·sub + 15. A pass loads the
  // slots' K and V together, so the value loads do not wait for the
  // softmax, and updates (m, l, a16) in registers (at head_dim 64 one
  // pass is one 8-slot chunk).
  const int lps = hd / 16, spp = 32 / lps;
  const int sub = lane % lps, grp = lane / lps;
  float q16[16], a16[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    q16[i] = to_f32(q[qoff + 16 * sub + i]);
    a16[i] = 0.f;
  }
  const size_t gbase = bl * E * D + (size_t)h * hd + 16 * sub;
  const size_t sbase = bl * E;
  for (int c0 = 0; c0 < n_gen; c0 += chunk) {
    const int nt = min(chunk, n_gen - c0);
    for (int s0 = 0; s0 < nt; s0 += spp) {
      const int s = s0 + grp;
      const bool live = s < nt;  // slot c0 + s lies below n_gen
      float kv[16], vv[16] = {}, p = 0.f, ks = 0.f, vs = 0.f;
      if (live) {
        const size_t slot = (size_t)(c0 + s);
        load16(gen.gk + gbase + slot * D, kv);
        load16(gen.gv + gbase + slot * D, vv);
        ks = gen.kscale(sbase + slot);
        vs = gen.vscale(sbase + slot);
#pragma unroll
        for (int i = 0; i < 16; ++i) p = fmaf(q16[i], kv[i], p);
      }
      for (int off = 1; off < lps; off <<= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      const float x = live ? p * (ks * scale) : -INFINITY;
      const float m_new = fmaxf(m, warp_max(x));
      const float corr = expf(m - m_new);
      const float e = live ? expf(x - m_new) : 0.f;
      float esum = e;  // one term per lane group
      for (int off = lps; off < 32; off <<= 1)
        esum += __shfl_xor_sync(0xffffffffu, esum, off);
      l = l * corr + esum;
      const float w = e * vs;
#pragma unroll
      for (int i = 0; i < 16; ++i) a16[i] = fmaf(w, vv[i], a16[i] * corr);
      m = m_new;
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
  const float c = expf(m0 - m), inv = 1.f / l;
  float* orow = out + (size_t)b * D + (size_t)h * hd;
#pragma unroll
  for (int j = 0; j < MAX_J; ++j)
    if (j < nj) orow[lane + 32 * j] = (acc[j] * c + part[lane + 32 * j]) * inv;
}

template <typename T, typename P, typename Gen>
cudaError_t launch(const void* q, const void* kn, const void* vn, long qs,
                   const void* pk, const void* pv, const float* pks,
                   const float* pvs, Gen gen, float* out, int N, int R, int L,
                   int K, int E, int D, int hd, int layer, int n_gen,
                   int chunk, cudaStream_t stream) {
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * K * hd + 2 * K + R * (hd + K + 1)) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chunk_attn<T, P, Gen>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(D / hd, N);
  chunk_attn<T, P, Gen><<<grid, 32 * R, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), qs, static_cast<const P*>(pk),
      static_cast<const P*>(pv), pks, pvs, gen, out, N, R, L, K, E, D, hd,
      layer, n_gen, chunk, 1.f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_q(const void* q, const void* kn, const void* vn, long qs,
                     const void* pk, const void* pv, const float* pks,
                     const float* pvs, ChunkGenInt8 gen, float* out, int N,
                     int R, int L, int K, int E, int D, int hd, int layer,
                     int n_gen, int chunk, cudaStream_t stream) {
  return pks ? launch<T, int8_t>(q, kn, vn, qs, pk, pv, pks, pvs, gen, out,
                                 N, R, L, K, E, D, hd, layer, n_gen, chunk,
                                 stream)
             : launch<T, T>(q, kn, vn, qs, pk, pv, nullptr, nullptr, gen, out,
                            N, R, L, K, E, D, hd, layer, n_gen, chunk, stream);
}

}  // namespace
}  // namespace capdec

extern "C" int capdec_beam_decode_attention_chunked_q(
    const void* q, const void* kn, const void* vn, long qs, const void* pk,
    const void* pv, const float* pks, const float* pvs, const int8_t* gk,
    const int8_t* gv, const float* gks, const float* gvs, float* out, int N,
    int R, int L, int K, int E, int D, int hd, int layer, int n_gen,
    int chunk, int dtype, cudaStream_t stream) {
  const capdec::ChunkGenInt8 gen{gk, gv, gks, gvs};
  cudaError_t err =
      dtype == capdec::kBF16
          ? capdec::launch_q<__nv_bfloat16>(q, kn, vn, qs, pk, pv, pks, pvs,
                                            gen, out, N, R, L, K, E, D, hd,
                                            layer, n_gen, chunk, stream)
          : capdec::launch_q<float>(q, kn, vn, qs, pk, pv, pks, pvs, gen,
                                    out, N, R, L, K, E, D, hd, layer, n_gen,
                                    chunk, stream);
  return static_cast<int>(err);
}
