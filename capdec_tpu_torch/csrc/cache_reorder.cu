// K3 and K4: in-place updates of the row-major generated KV cache
// [B, L, E, D]. Both move bytes only, so one kernel serves every dtype:
// rows move as 16-byte words (the wrappers require D·itemsize % 16 == 0).
//
// K3 write_gen_slot replaces
// capdec_tpu/ops/cache_reorder.py::write_gen_slot_chunk (:355, pallas_call
// in _write_chunk_impl :318): new_k/new_v [B, L, D] go to slot `step`.
// Bound: bytes, 2·B·L·D·itemsize read and as many written. One block per
// (row, layer) copies its D values; only the written slot is touched (the
// TPU kernel's aligned 8-slot chunk was a tiling workaround).
//
// K4 copy_forked_rows_bounded replaces
// capdec_tpu/ops/cache_reorder.py::copy_forked_rows_bounded (:210,
// pallas_call :237): row b <- row src[b] over slots < count, only where
// src[b] != b. Bound: bytes, 2·forks·L·count·D·itemsize each way, which
// depends on how many beams forked this step. One block per (row, layer):
// a row that kept its lane exits at once, so surviving beams move nothing.
// The lane assignment guarantees a written row is never a source
// (decode/beam.py _assign_lanes), so blocks may run in any order in place.
#include "common.cuh"

namespace capdec {
namespace {

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
