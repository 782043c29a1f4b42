// K3, K4, K5, K7 and K14: in-place updates of the row-major generated KV
// cache [B, L, E, D]; K13: K3 for the seq-major cache [L, B, E, D]. K3, K4,
// K7, K13 and K14 move bytes only, so one kernel serves every
// dtype: rows move as 16-byte words (the wrappers require
// D·itemsize % 16 == 0).
//
// K3 write_gen_slot replaces
// capdec_tpu/ops/cache_reorder.py::write_gen_slot_chunk (:355, pallas_call
// in _write_chunk_impl :318): new_k/new_v [B, L, D] go to slot `step`.
// Bound: bytes, 2·B·L·D·itemsize read and as many written. One block per
// (row, layer) copies its D values; only the written slot is touched (the
// TPU kernel's aligned 8-slot chunk was a tiling workaround).
//
// K14 replaces capdec_tpu/ops/cache_reorder.py::write_gen_slot (:452,
// pallas_call :480), which computes what K3 computes: slot `step` of the
// row-major caches takes new_k/new_v. The TPU wrote a 2-slot pair window at
// the even slot below `step`, read back first, only because Mosaic's
// (2, 128) bf16 tiling makes a one-slot DMA illegal; Hopper has no such
// rule, so K14 launches K3's kernel through K3's entry, which writes the one
// slot. Its own wrapper (ops/cache_reorder.py::write_gen_slot) keeps its own
// launch count, so a run shows which of the two routes wrote the slot.
// Bound: K3's.
//
// K13 write_gen_slot_seqmajor replaces
// capdec_tpu/ops/cache_reorder.py::write_gen_slot_chunk_seqmajor (:380,
// pallas_call in _write_chunk_impl :318 with row_axis 1): K3 for the
// seq-major caches [L, B, E, D] of greedy/top-p decode, new_k/new_v
// [L, B, D]. Bound: bytes, as K3. K3's design with the seq-major strides:
// one block per (row b, layer l) copies the D values of row (l·B + b) of
// new into slot `step` at ((l·B + b)·E + step)·D, as 16-byte words.
//
// K4 copy_forked_rows_bounded replaces
// capdec_tpu/ops/cache_reorder.py::copy_forked_rows_bounded (:210,
// pallas_call :237): row b <- row src[b] over slots < count, only where
// src[b] != b. Bound: bytes, 2·forks·L·count·D·itemsize each way, which
// depends on how many beams forked this step. One block per (row, layer):
// a row that kept its lane exits at once, so surviving beams move nothing.
// The lane assignment guarantees a written row is never a source
// (decode/beam.py _assign_lanes), so blocks may run in any order in place.
//
// K5 write_gen_slot_q replaces
// capdec_tpu/ops/cache_reorder.py::write_gen_slot_chunk_q (:413, body
// _chunk_write_q_kernel :393): absmax-int8 quantisation of the step's
// new_k/new_v [B, L, D] over D per (row, layer), levels into slot `step`
// of the int8 caches, the f32 scale into ks/vs [B, L, 1, E] at `step`.
// Bound: bytes (new K/V in, levels and scales out; a few operations per
// byte). One block of two warps per (row, layer), warp 0 for K and warp 1
// for V: each lane holds 16-value groups in registers, the warp takes the
// absmax with shuffles, and each group leaves as one 16-byte store. It is
// bit-identical to absmax_int8_quant: the scale is amax · fl32(1/127)
// (1 where amax == 0; jitted JAX code multiplies by that reciprocal, as
// XLA rewrites a division by a constant) and each level rintf(x / s)
// (round half to even, IEEE division: the build uses no fast-math)
// clamped to ±127.
//
// K7 copy_forked_rows replaces capdec_tpu/ops/cache_reorder.py::
// copy_forked_rows (:136, pallas_call :160): K4 over whole rows, for the
// staged cache whose allocation is the current stage's. In [B, L, E, D] a
// row is one contiguous span of L·E·D·itemsize bytes. Bound: bytes, each
// forked row written once and each source row read once. The grid is
// (row, span tile) over 16-byte words; blocks of a row that kept its lane
// exit at once. The lane invariant makes the in-place copy safe.
#include "common.cuh"

namespace capdec {
namespace {

constexpr int MAX_CH = 4;  // 16-value groups per lane: D <= 2048
constexpr float kInv127 = 1.0f / 127.0f;  // rounded once, in f32

__global__ void write_gen_slot(uint4* __restrict__ k, uint4* __restrict__ v,
                               const uint4* __restrict__ nk,
                               const uint4* __restrict__ nv, int E, int step,
                               long row16) {
  const size_t bl = blockIdx.x;  // (row, layer) pair
  uint4* kd = k + (bl * E + step) * row16;
  uint4* vd = v + (bl * E + step) * row16;
  const uint4* ks = nk + bl * row16;
  const uint4* vs = nv + bl * row16;
  for (long i = threadIdx.x; i < row16; i += blockDim.x) {
    kd[i] = ks[i];
    vd[i] = vs[i];
  }
}

__global__ void write_gen_slot_seqmajor(uint4* __restrict__ k,
                                        uint4* __restrict__ v,
                                        const uint4* __restrict__ nk,
                                        const uint4* __restrict__ nv, int B,
                                        int E, int step, long row16) {
  const size_t row = (size_t)blockIdx.y * B + blockIdx.x;  // l·B + b
  uint4* kd = k + (row * E + step) * row16;
  uint4* vd = v + (row * E + step) * row16;
  const uint4* ks = nk + row * row16;
  const uint4* vs = nv + row * row16;
  for (long i = threadIdx.x; i < row16; i += blockDim.x) {
    kd[i] = ks[i];
    vd[i] = vs[i];
  }
}

__global__ void copy_forked_rows_bounded(uint4* k, uint4* v,
                                         const int64_t* __restrict__ src,
                                         int L, int E, int count,
                                         long row16) {
  const int b = blockIdx.x, l = blockIdx.y;
  const int64_t s = src[b];
  if (s == b) return;
  const size_t dst = ((size_t)b * L + l) * E * row16;
  const size_t from = ((size_t)s * L + l) * E * row16;
  const size_t n = (size_t)count * row16;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    k[dst + i] = k[from + i];
    v[dst + i] = v[from + i];
  }
}

template <typename T>
__global__ void write_gen_slot_q(int8_t* __restrict__ k,
                                 int8_t* __restrict__ v,
                                 float* __restrict__ ks,
                                 float* __restrict__ vs,
                                 const T* __restrict__ nk,
                                 const T* __restrict__ nv, int E, int D,
                                 int step) {
  const size_t bl = blockIdx.x;  // (row, layer) pair
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* src = (warp ? nv : nk) + bl * D;
  int8_t* dst = (warp ? v : k) + (bl * E + step) * D;
  const int groups = D / 16;
  float x[MAX_CH][16];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_CH; ++c) {
    const int g = lane + 32 * c;
    if (g < groups) {
      load16(src + 16 * g, x[c]);
#pragma unroll
      for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(x[c][i]));
    }
  }
  amax = warp_max(amax);
  const float s = amax > 0.f ? amax * kInv127 : 1.0f;
#pragma unroll
  for (int c = 0; c < MAX_CH; ++c) {
    const int g = lane + 32 * c;
    if (g < groups) {
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float r = fminf(fmaxf(rintf(x[c][i] / s), -127.f), 127.f);
        w[i / 4] |= (static_cast<unsigned>(static_cast<int>(r)) & 0xffu)
                    << (8 * (i % 4));
      }
      *reinterpret_cast<uint4*>(dst + 16 * g) = make_uint4(w[0], w[1], w[2],
                                                           w[3]);
    }
  }
  if (lane == 0) (warp ? vs : ks)[bl * E + step] = s;
}

__global__ void copy_forked_rows(uint4* k, uint4* v,
                                 const int64_t* __restrict__ src,
                                 long row16) {
  const int b = blockIdx.x;
  const int64_t s = src[b];
  if (s == b) return;
  uint4* kd = k + (size_t)b * row16;
  uint4* vd = v + (size_t)b * row16;
  const uint4* kf = k + (size_t)s * row16;
  const uint4* vf = v + (size_t)s * row16;
  const long stride = (long)gridDim.y * blockDim.x;
  for (long i = (long)blockIdx.y * blockDim.x + threadIdx.x; i < row16;
       i += stride) {
    kd[i] = kf[i];
    vd[i] = vf[i];
  }
}

}  // namespace
}  // namespace capdec

extern "C" int capdec_write_gen_slot(void* k, void* v, const void* nk,
                                     const void* nv, int B, int L, int E,
                                     int step, long row_bytes,
                                     cudaStream_t stream) {
  capdec::write_gen_slot<<<B * L, 128, 0, stream>>>(
      static_cast<uint4*>(k), static_cast<uint4*>(v),
      static_cast<const uint4*>(nk), static_cast<const uint4*>(nv), E, step,
      row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int capdec_write_gen_slot_seqmajor(void* k, void* v,
                                              const void* nk, const void* nv,
                                              int L, int B, int E, int step,
                                              long row_bytes,
                                              cudaStream_t stream) {
  capdec::write_gen_slot_seqmajor<<<dim3(B, L), 128, 0, stream>>>(
      static_cast<uint4*>(k), static_cast<uint4*>(v),
      static_cast<const uint4*>(nk), static_cast<const uint4*>(nv), B, E,
      step, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int capdec_copy_forked_rows_bounded(void* k, void* v,
                                               const int64_t* src, int B,
                                               int L, int E, int count,
                                               long row_bytes,
                                               cudaStream_t stream) {
  capdec::copy_forked_rows_bounded<<<dim3(B, L), 256, 0, stream>>>(
      static_cast<uint4*>(k), static_cast<uint4*>(v), src, L, E, count,
      row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int capdec_write_gen_slot_q(void* k, void* v, float* ks,
                                       float* vs, const void* nk,
                                       const void* nv, int B, int L, int E,
                                       int D, int step, int dtype,
                                       cudaStream_t stream) {
  int8_t* k8 = static_cast<int8_t*>(k);
  int8_t* v8 = static_cast<int8_t*>(v);
  if (dtype == capdec::kBF16)
    capdec::write_gen_slot_q<__nv_bfloat16><<<B * L, 64, 0, stream>>>(
        k8, v8, ks, vs, static_cast<const __nv_bfloat16*>(nk),
        static_cast<const __nv_bfloat16*>(nv), E, D, step);
  else
    capdec::write_gen_slot_q<float><<<B * L, 64, 0, stream>>>(
        k8, v8, ks, vs, static_cast<const float*>(nk),
        static_cast<const float*>(nv), E, D, step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int capdec_copy_forked_rows(void* k, void* v, const int64_t* src,
                                       int B, long row_bytes,
                                       cudaStream_t stream) {
  constexpr int threads = 256, words_per_thread = 4;
  const long row16 = row_bytes / 16;
  long tiles = (row16 + threads * words_per_thread - 1) /
               (threads * words_per_thread);
  if (tiles > 65535) tiles = 65535;
  capdec::copy_forked_rows<<<dim3(B, (unsigned)tiles), threads, 0, stream>>>(
      static_cast<uint4*>(k), static_cast<uint4*>(v), src, row16);
  return static_cast<int>(cudaGetLastError());
}
