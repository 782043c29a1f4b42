// K10, K11 and K12: out-of-place gathers of generated-cache rows by `src`,
// the per-step beam permutation of the paths that move whole caches (the
// non-lane beam search, and the seq-major lane path's fork fix-up).
//
// K10 reorder_rows_leading replaces
// capdec_tpu/ops/cache_reorder.py::reorder_rows_leading (:516, pallas_call
// :538): out row b <- row src[b] of the row-major caches [B, L, E, D]. A
// row is one contiguous span of L·E·D·itemsize bytes.
//
// K11 reorder_cache_rows replaces capdec_tpu/ops/cache_reorder.py::
// reorder_cache_rows (:550, pallas_call :573): the same gather along axis 1
// of the seq-major caches [L, B, E, D], where row b is L spans of
// E·D·itemsize bytes, one a layer.
//
// K12 reorder_cache_rows_bounded replaces capdec_tpu/ops/cache_reorder.py::
// reorder_cache_rows_bounded (:64, pallas_call :92): K11 over the slots
// below `count` only; the output's slots at or above `count` are left as
// they were (uninitialised in a fresh output, as on the TPU).
//
// One kernel serves all three: span (b, l) of the output takes span
// (src[b], l) of the input, n16 16-byte words from the offset
// (row·L + l)·stride16 (row-major; K10 runs it with L = 1 and the whole row
// as its span) or (l·B + row)·stride16 (seq-major). The wrappers require
// D·itemsize % 16 == 0, so one kernel moves every dtype bit for bit.
// Bound: bytes, each distinct source span read once and each output span
// written once: at most 2·849 MB at the served shapes (0.507 ms at
// 3.35 TB/s), less where rows share a source. The grid is (span tile, b, l);
// a thread issues its four 16-byte loads of k and of v before it stores
// any, so eight loads are in flight per thread, and no block runs long.
//
// `src` is no permutation: several rows may read one source, so the gather
// cannot run in place (a row could be overwritten before another row has
// read it). The wrappers write into an output cache and refuse one that
// overlaps the input. The beam engine lets PyTorch's caching allocator hand
// out each step's output and frees the input when it rebinds the cache, so
// two cache buffers alternate from step to step (peak: two caches, 1.7 GB
// in bf16 at the served shapes).
//
// A source outside [0, B) trips a device-side assert, as index_select's
// does on the card: the wrappers cannot check `src`'s values on the host
// without waiting for the device at every step.
#include <cassert>

#include "common.cuh"

namespace capdec {
namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;  // 16-byte words a thread moves per array
constexpr long kTile = static_cast<long>(kThreads) * kWords;

__global__ void gather_spans(const uint4* __restrict__ k,
                             const uint4* __restrict__ v,
                             uint4* __restrict__ ok, uint4* __restrict__ ov,
                             const int64_t* __restrict__ src, int B, int L,
                             int seq_major, long stride16, long n16) {
  const int b = blockIdx.y, l = blockIdx.z;
  const int64_t s = src[b];
  assert(s >= 0 && s < B);
  const size_t from =
      (seq_major ? (size_t)l * B + s : (size_t)s * L + l) * stride16;
  const size_t to =
      (seq_major ? (size_t)l * B + b : (size_t)b * L + l) * stride16;
  const long base = (long)blockIdx.x * kTile + threadIdx.x;
  uint4 kw[kWords], vw[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const long i = base + (long)j * kThreads;
    if (i < n16) {
      kw[j] = k[from + i];
      vw[j] = v[from + i];
    }
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const long i = base + (long)j * kThreads;
    if (i < n16) {
      ok[to + i] = kw[j];
      ov[to + i] = vw[j];
    }
  }
}

}  // namespace
}  // namespace capdec

extern "C" int capdec_gather_rows(const void* k, const void* v, void* ok,
                                  void* ov, const int64_t* src, int B, int L,
                                  int seq_major, long stride_bytes,
                                  long span_bytes, cudaStream_t stream) {
  const long n16 = span_bytes / 16;
  if (n16 == 0) return 0;  // count 0: nothing moves, nothing launches
  const long tiles = (n16 + capdec::kTile - 1) / capdec::kTile;
  capdec::gather_spans<<<dim3((unsigned)tiles, B, L), capdec::kThreads, 0,
                         stream>>>(
      static_cast<const uint4*>(k), static_cast<const uint4*>(v),
      static_cast<uint4*>(ok), static_cast<uint4*>(ov), src, B, L, seq_major,
      stride_bytes / 16, n16);
  return static_cast<int>(cudaGetLastError());
}
