// K3, K4, K5, K7 and K14: in-place updates of the row-major generated KV
// cache [B, L, E, D]; K13: the slot write of the seq-major cache
// [L, B, E, D], from per-layer views. K3, K4,
// K7, K13 and K14 move bytes only, so one kernel serves every
// dtype: rows move as 16-byte words (the wrappers require
// D·itemsize % 16 == 0).
//
// K3 write_gen_slot (write_gen_slot_views<W, true>) replaces
// capdec_tpu/ops/cache_reorder.py::write_gen_slot_chunk (:355, pallas_call
// in _write_chunk_impl :318): the step's K/V of every layer go to slot
// `step` of the row-major caches [B, L, E, D]. Bound: bytes,
// 2·B·L·D·itemsize read and as many written; only the written slot is
// touched (the TPU kernel's aligned 8-slot chunk was a tiling workaround).
// It is K13's kernel with the row-major slot row ((b·L + l)·E + step), and
// reads what K13 reads (below): decode_step hands both the k and v thirds
// of each layer's [B, 3D] qkv output, so no torch.stack runs before the
// write (a [B, L, D] tensor is read as its L strided [B, D] views). Its
// parent ran one 128-thread block a (row, layer), a thread taking one word
// of the K row and one of the V row, from [B, L, D] tensors that
// decode_step stacked first (two more launches). From the views in one
// launch the step's write takes a third of the parent's stacks and write.
// The kernel alone is faster than the parent's at B 320 but 0.1-0.6 µs
// (1-7%) slower at one image, a tp=2 rank and B 2560; in
// scripts/torch_cache_kernel_sweep.py neither scalar sources in place of
// the struct, plain loads, a smaller struct nor another grid (a loop over
// the items, a warp a (layer, row), the parent's block a (row, layer),
// 1-8 warps a block) closed the gap, and the counters that would show why
// are not readable on the card's machine.
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
// K13 write_gen_slot_seqmajor (write_gen_slot_views<W, false>) replaces
// capdec_tpu/ops/cache_reorder.py::write_gen_slot_chunk_seqmajor (:380,
// body _write_chunk_impl :275, pallas_call :318 with row_axis 1): slot
// `step` of the seq-major caches [L, B, E, D] of greedy/top-p decode takes
// the step's K/V of every layer. Bound: bytes, 2·L·B·D·itemsize read and
// as many written. On the TPU the decode scan stacked each layer's K/V
// into [L, B, D] for free; the port's layers run in a Python loop, and a
// stack there is two more launches and 2·L·B·D·itemsize more bytes each
// way. So the kernel reads the K/V where the layers leave them: L strided
// [B, D] views (the k and v thirds of each layer's [B, 3D] qkv output),
// whose 2·L base pointers and row strides come by value in a
// __grid_constant__ parameter struct (a device table would cost a copy a
// step). The grid is cut for the bytes and not by (row, layer): one warp
// takes one (row, K|V) item j = 2·b + (0 K | 1 V) of layer blockIdx.y (the
// grid's y axis, so that a warp reads its layer's entries of the struct
// without waiting for a parameter), whose row is row16 16-byte words; a
// lane issues all of its W words' non-coherent loads (ld.global.nc) before
// any store, W the least of 1, 2, 4 or 8 with 32·W >= row16 (the row in
// passes of 32·W words beyond that). At D 768 bf16 (96 words, W 4, three
// live) path (d)'s call is 1536 warps with no idle lane, in blocks of four
// warps, one wave. The wrapper's plan (ops/cache_reorder.py::
// slot_write_plan) chooses warps, W and the grid; the C entry refuses a
// plan that is not its own layout's. On the H100 the call takes the
// launch's floor (the empty kernel on the same grid), then the loads'
// round trip, then the stores, whichever way the grid is cut
// (scripts/torch_cache_kernel_sweep.py: a warp a K|V row looping over the
// items, a warp a (layer, row), a block a (layer, row); blocks of 1-8
// warps); the layer on the grid's y axis was the fastest of these.
//
// K4 copy_forked_rows_bounded replaces
// capdec_tpu/ops/cache_reorder.py::copy_forked_rows_bounded (:210,
// pallas_call :237): row b <- row src[b] over slots < count, only where
// src[b] != b. Bound: bytes, each source row's slots < count read once and
// each forked row's written once (2·(sources + forks)·L·count·D·itemsize),
// which depends on how the beams forked this step. The lane assignment
// guarantees a written row is never a source (decode/beam.py
// _assign_lanes), so items may run in any order in place, and a source is
// read-only for the kernel's life (ld.global.nc). A (row, layer) K or V
// slab is count·row16 contiguous 16-byte words. The grid is cut by bytes:
// one warp takes one item (row, layer, K|V, tile of 32·W words of the
// slab), tile fastest; a lane issues its W loads before any store, and an
// item of a row that kept its lane exits at once. Forks are read
// fork-major: each fork's items read its source's tile, and the forks of
// one source (an image's lanes, neighbouring rows) run close enough that
// the second read comes from the L2 (scripts/torch_cache_kernel_sweep.py
// on the H100: at B 320 the 734.8 MB the bound counts move in 0.2530 ms,
// 2.90 TB/s, where reading each source once per fork from HBM would take
// 3.69 TB/s, above the HBM's rate). A source-major order (a warp an
// image's 5 rows, each distinct source's tile loaded once and stored to
// each of its forks) was slower at every shape timed, one image to B 2560
// (0.2555 ms at B 320), and needs a scan and a grouping of the rows; the
// fork-major one takes any src. W = 4 (kForkWords) was the best of 1, 2,
// 4 and 8 at one image, a tp=2 rank and B 2560 and within 0.1% of W 2 at
// B 320. Its parent ran one
// 256-thread block a (row, layer): it could not fill the card at one image
// (60 blocks, 36 with work, on 132 SMs), each thread with one word in
// flight (a store to k came before the next load from v, which may
// alias).
//
// K5 write_gen_slot_q replaces
// capdec_tpu/ops/cache_reorder.py::write_gen_slot_chunk_q (:413, body
// _chunk_write_q_kernel :393): absmax-int8 quantisation of the step's
// new_k/new_v [B, L, D] over D per (row, layer), levels into slot `step`
// of the int8 caches, the f32 scale into ks/vs [B, L, 1, E] at `step`.
// Bound: bytes (new K/V in, levels and scales out), but the arithmetic is
// of the same order on the H100: with the IEEE division a level this
// kernel takes 12.2 µs against 9.8 without (scripts/torch_int8_ablate.py),
// and a grid that loads, then divides, then stores in step across the card
// pays for both. So a level takes no division (level_fma: one FMUL and two
// FFMA give the division's quotient, and an addition rounds it), and one
// warp takes one (row, layer, K|V) item 2·(b·L + l) + (0 K | 1 V) in
// blocks of four warps, about eight blocks an SM by registers, so that the
// block scheduler overlaps one warp's arithmetic with others' loads (the
// loop over items only serves a grid smaller than the items; such a grid
// was no faster). A lane holds 8-value units u = lane + 32·c (D = 768 is
// 96 units, three a lane) and each unit leaves as one 8-byte store; lane 0
// stores the scale. It is bit-identical to absmax_int8_quant: the scale is amax · fl32(1/127) (1 where amax == 0;
// jitted JAX code multiplies by that reciprocal, as XLA rewrites a division
// by a constant) and each level rint(x / s) (round half to even, the IEEE
// quotient: the build uses no fast-math) clamped to ±127. An amax outside
// [2^-60, 2^100] (or not finite) takes the IEEE division itself (a warp-
// uniform branch: a branch per value cost as much as the division, for
// the compiler ran its divisions under a predicate).
//
// K7 copy_forked_rows replaces capdec_tpu/ops/cache_reorder.py::
// copy_forked_rows (:136, pallas_call :160): K4 over whole rows, for the
// staged cache whose allocation is the current stage's. In [B, L, E, D] a
// row is one contiguous span of L·E·D·itemsize bytes. Bound: bytes, each
// forked row written once and each source row read once. The grid is
// (row, span tile) over 16-byte words; blocks of a row that kept its lane
// exit at once. The lane invariant makes the in-place copy safe.
#include <climits>

#include "common.cuh"

namespace capdec {

// The sources of K3, K13 and K14, by value: layer l's K rows start at
// k[l], row b at k[l] + b·k_row16[l] 16-byte words (likewise v).
constexpr int kSlotMaxLayers = 64;
constexpr int kSlotMaxWarps = 8;
struct LayerSources {
  const uint4* k[kSlotMaxLayers];
  const uint4* v[kSlotMaxLayers];
  int k_row16[kSlotMaxLayers];
  int v_row16[kSlotMaxLayers];
};

// The words a lane holds for a row of row16 16-byte words: the least of
// 1, 2, 4, 8 with 32·W >= row16, else 8 (the row in passes).
constexpr int slot_words(long row16) {
  return row16 <= 32 ? 1 : row16 <= 64 ? 2 : row16 <= 128 ? 4 : 8;
}

// K4: the warps of a block, and the 16-byte words a lane holds
// (ops/cache_reorder.py FORK_W).
constexpr int kForkWarps = 4;
constexpr int kForkWords = 4;

namespace {

constexpr float kInv127 = 1.0f / 127.0f;  // rounded once, in f32
// 1.5 · 2^23: t + kMagic rounds t (|t| <= 2^22) to an integer, half to
// even, which lands in the low mantissa bits
constexpr float kMagic = 12582912.0f;

// K5's level of x under scale s: the low byte of clamp(rint(x / s), ±127)
// by the IEEE division.
__device__ __forceinline__ unsigned level_div(float x, float s) {
  const float r = fminf(fmaxf(rintf(x / s), -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(r)) & 0xffu;
}

// The same from inv = fl(1/s), with no division and no branch: q = x · inv
// is within an ulp of x / s, the residual x - s · q is exact in an FMA, and
// fl(q + residual · inv) is then the IEEE quotient x / s (Markstein's
// theorem, the correction step of the IEEE division itself) as long as x
// and s are normal and nothing underflows; the caller keeps amax, so s, in
// a range where that holds. kMagic rounds the clamped quotient.
__device__ __forceinline__ unsigned level_fma(float x, float s, float inv) {
  const float q = x * inv;
  const float y = fmaf(fmaf(-q, s, x), inv, q);
  return __float_as_uint(fminf(fmaxf(y, -127.f), 127.f) + kMagic) & 0xffu;
}

// K3/K14 (kRowMajor: caches [B, L, E, D]) and K13 ([L, B, E, D]): warp
// j of layer blockIdx.y takes row j >> 1 of that layer's K (j even) or V.
template <int W, bool kRowMajor>
__global__ void __launch_bounds__(kSlotMaxWarps * 32)
write_gen_slot_views(uint4* __restrict__ k, uint4* __restrict__ v,
                     const __grid_constant__ LayerSources src, int L, int B,
                     int E, int step, int row16) {
  const int l = blockIdx.y;
  const int j = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (j >= 2 * B) return;
  const int b = j >> 1, lane = threadIdx.x & 31;
  const bool is_v = j & 1;
  const uint4* s = is_v ? src.v[l] + (size_t)b * src.v_row16[l]
                        : src.k[l] + (size_t)b * src.k_row16[l];
  const size_t slot_row = kRowMajor ? (size_t)b * L + l : (size_t)l * B + b;
  uint4* d = (is_v ? v : k) + (slot_row * E + step) * row16;
  for (int base = lane; base < row16; base += 32 * W) {
    uint4 w[W];
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (base + 32 * c < row16) w[c] = __ldg(s + base + 32 * c);
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (base + 32 * c < row16) d[base + 32 * c] = w[c];
  }
}

// The floor of a launch on a grid: a kernel that does nothing, timed
// beside K3, K4 and K13 (chip_smoke.py, scripts/torch_slot_write_steps.py,
// scripts/torch_fork_copy_steps.py).
__global__ void empty_grid() {}

// K4 on items * 32 lanes; slab16 = count·row16 words, tiles of 32·W.
template <int W>
__global__ void __launch_bounds__(kForkWarps * 32)
copy_forked_rows_bounded(uint4* __restrict__ k, uint4* __restrict__ v,
                         const int64_t* __restrict__ src, int L, int E,
                         long row16, long slab16, long tiles, long items) {
  const long it = (long)blockIdx.x * kForkWarps + (threadIdx.x >> 5);
  if (it >= items) return;
  const long tile = it % tiles, rest = it / tiles;
  const long b = (rest >> 1) / L;
  const int64_t s = src[b];
  if (s == b) return;  // the row kept its lane: nothing moves
  const long w0 = tile * 32 * W + (threadIdx.x & 31);  // the lane's word
  const long slab = ((rest >> 1) % L) * E * row16 + w0;
  uint4* cache = (rest & 1) ? v : k;
  const uint4* from = cache + s * L * E * row16 + slab;
  uint4* to = cache + b * L * E * row16 + slab;
  uint4 w[W];
#pragma unroll
  for (int c = 0; c < W; ++c)
    if (w0 + 32 * c < slab16) w[c] = __ldg(from + 32 * c);
#pragma unroll
  for (int c = 0; c < W; ++c)
    if (w0 + 32 * c < slab16) to[32 * c] = w[c];
}

// K5: the threads of a block, and the 8-value units a lane holds: U = 4
// for D <= 1024, U = 8 for D <= 2048 (its limit), as the wrapper's plan
// (ops/cache_reorder.py quant_write_plan) reports.
constexpr int kQuantThreads = 128;
constexpr int kQuantMaxD = 8 * 32 * 8;

// 8 values of T as the words they are stored in: one (bf16) or two (f32)
// 16-byte words.
template <typename T>
struct Unit8 {
  uint4 w[sizeof(T) / 2];
};

__device__ __forceinline__ void unpack8(const Unit8<__nv_bfloat16>& x,
                                        float (&f)[8]) {
  const unsigned u[4] = {x.w[0].x, x.w[0].y, x.w[0].z, x.w[0].w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // bf16 -> f32 is exact: the top 16 bits
    f[2 * j] = __uint_as_float(u[j] << 16);
    f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack8(const Unit8<float>& x, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(x.w[i].x);
    f[4 * i + 1] = __uint_as_float(x.w[i].y);
    f[4 * i + 2] = __uint_as_float(x.w[i].z);
    f[4 * i + 3] = __uint_as_float(x.w[i].w);
  }
}

// Blocks an SM of each instance, by its registers: a lane holds an item's
// U units (2 · sizeof(T) registers a unit) and up to 32 registers besides.
template <typename T, int U>
constexpr int kQuantBlocks = 65536 / kQuantThreads /
                             (2 * U * (int)sizeof(T) + 32);

template <typename T, int U>
__global__ void __launch_bounds__(kQuantThreads, (kQuantBlocks<T, U>))
write_gen_slot_q(int8_t* __restrict__ k, int8_t* __restrict__ v,
                 float* __restrict__ ks, float* __restrict__ vs,
                 const T* __restrict__ nk, const T* __restrict__ nv,
                 int items, int E, int D, int step) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int units = D / 8;
  for (int it = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       it < items; it += warps) {
    // item it: row it / 2 of new_k or new_v, its units as stored
    const uint4* src = reinterpret_cast<const uint4*>(
        ((it & 1) ? nv : nk) + (size_t)(it >> 1) * D);
    Unit8<T> cur[U];
#pragma unroll
    for (int c = 0; c < U; ++c) {
      const int u = lane + 32 * c;
      if (u < units) {
#pragma unroll
        for (int i = 0; i < (int)sizeof(T) / 2; ++i)
          cur[c].w[i] = src[u * (sizeof(T) / 2) + i];
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < U; ++c)
      if (lane + 32 * c < units) {
        float x[8];
        unpack8(cur[c], x);
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(x[i]));
      }
    amax = warp_max(amax);
    const float s = amax > 0.f ? amax * kInv127 : 1.0f;
    const float inv = 1.0f / s;
    const size_t slot = (size_t)(it >> 1) * E + step;
    int8_t* dst = ((it & 1) ? v : k) + slot * D;
    // the division-free levels for every amax a model gives (warp-uniform)
    if (amax == 0.f || (amax >= 0x1p-60f && amax <= 0x1p100f)) {
#pragma unroll
      for (int c = 0; c < U; ++c)
        if (lane + 32 * c < units) {
          float x[8];
          unpack8(cur[c], x);
          unsigned w[2] = {0u, 0u};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            w[i / 4] |= level_fma(x[i], s, inv) << (8 * (i % 4));
          *reinterpret_cast<uint2*>(dst + 8 * (lane + 32 * c)) =
              make_uint2(w[0], w[1]);
        }
    } else {  // tiny, huge or infinite amax: the IEEE division
#pragma unroll
      for (int c = 0; c < U; ++c)
        if (lane + 32 * c < units) {
          float x[8];
          unpack8(cur[c], x);
          unsigned w[2] = {0u, 0u};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            w[i / 4] |= level_div(x[i], s) << (8 * (i % 4));
          *reinterpret_cast<uint2*>(dst + 8 * (lane + 32 * c)) =
              make_uint2(w[0], w[1]);
        }
    }
    if (lane == 0) ((it & 1) ? vs : ks)[slot] = s;
  }
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

// K3/K14 (kRowMajor) or K13 on the plan's grid: `blocks` blocks of `warps`
// warps for each of the L layers (grid.y), `words` 16-byte words a lane
// (the plan must be this layout's).
template <bool kRowMajor>
int launch_slot_write(void* k, void* v, const LayerSources* src, int L,
                      int B, int E, int step, long row_bytes, int warps,
                      int words, int blocks, cudaStream_t stream) {
  const long row16 = row_bytes / 16;
  if (L < 1 || L > kSlotMaxLayers || B < 1 || B > INT_MAX / 2 ||
      row_bytes % 16 || row16 < 1 || row16 > INT_MAX || step < 0 ||
      step >= E || warps < 1 || warps > kSlotMaxWarps ||
      blocks != (2L * B + warps - 1) / warps || words != slot_words(row16))
    return static_cast<int>(cudaErrorInvalidValue);
  uint4* k4 = static_cast<uint4*>(k);
  uint4* v4 = static_cast<uint4*>(v);
  const dim3 grid(blocks, L), block(32 * warps);
  const int r = (int)row16;
  switch (words) {
    case 1:
      write_gen_slot_views<1, kRowMajor><<<grid, block, 0, stream>>>(
          k4, v4, *src, L, B, E, step, r);
      break;
    case 2:
      write_gen_slot_views<2, kRowMajor><<<grid, block, 0, stream>>>(
          k4, v4, *src, L, B, E, step, r);
      break;
    case 4:
      write_gen_slot_views<4, kRowMajor><<<grid, block, 0, stream>>>(
          k4, v4, *src, L, B, E, step, r);
      break;
    default:
      write_gen_slot_views<8, kRowMajor><<<grid, block, 0, stream>>>(
          k4, v4, *src, L, B, E, step, r);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace capdec

// K3 and K14: slot `step` of the row-major caches [B, L, E, D].
extern "C" int capdec_write_gen_slot(void* k, void* v,
                                     const capdec::LayerSources* src, int L,
                                     int B, int E, int step, long row_bytes,
                                     int warps, int words, int blocks,
                                     cudaStream_t stream) {
  return capdec::launch_slot_write<true>(k, v, src, L, B, E, step,
                                         row_bytes, warps, words, blocks,
                                         stream);
}

// K13: slot `step` of the seq-major caches [L, B, E, D].
extern "C" int capdec_write_gen_slot_seqmajor(
    void* k, void* v, const capdec::LayerSources* src, int L, int B, int E,
    int step, long row_bytes, int warps, int words, int blocks,
    cudaStream_t stream) {
  return capdec::launch_slot_write<false>(k, v, src, L, B, E, step,
                                          row_bytes, warps, words, blocks,
                                          stream);
}

// The empty kernel on `blocks` blocks of `threads`.
extern "C" int capdec_empty_grid(int blocks, int threads,
                                 cudaStream_t stream) {
  capdec::empty_grid<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

// K4 on the plan's grid: `blocks` blocks of kForkWarps warps, one warp an
// item of kForkWords words a lane.
extern "C" int capdec_copy_forked_rows_bounded(void* k, void* v,
                                               const int64_t* src, int B,
                                               int L, int E, int count,
                                               long row_bytes, int blocks,
                                               cudaStream_t stream) {
  constexpr int W = capdec::kForkWords;
  const long row16 = row_bytes / 16;
  if (B < 1 || L < 1 || count < 1 || count > E || row_bytes % 16 ||
      row16 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long slab16 = (long)count * row16;
  const long tiles = (slab16 + 32L * W - 1) / (32L * W);
  const long items = 2L * B * L * tiles;
  if ((items + capdec::kForkWarps - 1) / capdec::kForkWarps != blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  capdec::copy_forked_rows_bounded<W>
      <<<blocks, 32 * capdec::kForkWarps, 0, stream>>>(
          static_cast<uint4*>(k), static_cast<uint4*>(v), src, L, E, row16,
          slab16, tiles, items);
  return static_cast<int>(cudaGetLastError());
}

namespace capdec {
namespace {

template <typename T, int U>
void launch_quant(int8_t* k, int8_t* v, float* ks, float* vs, const void* nk,
                  const void* nv, int items, int E, int D, int step,
                  int blocks, int threads, cudaStream_t stream) {
  write_gen_slot_q<T, U><<<blocks, threads, 0, stream>>>(
      k, v, ks, vs, static_cast<const T*>(nk), static_cast<const T*>(nv),
      items, E, D, step);
}

template <typename T>
void launch_quant_units(int8_t* k, int8_t* v, float* ks, float* vs,
                        const void* nk, const void* nv, int items, int E,
                        int D, int step, int blocks, int threads,
                        cudaStream_t stream) {
  if (D <= kQuantMaxD / 2)
    launch_quant<T, 4>(k, v, ks, vs, nk, nv, items, E, D, step, blocks,
                       threads, stream);
  else
    launch_quant<T, 8>(k, v, ks, vs, nk, nv, items, E, D, step, blocks,
                       threads, stream);
}

}  // namespace
}  // namespace capdec

// K5 on the plan's grid of `blocks` blocks of `threads`.
extern "C" int capdec_write_gen_slot_q(void* k, void* v, float* ks,
                                       float* vs, const void* nk,
                                       const void* nv, int B, int L, int E,
                                       int D, int step, int blocks,
                                       int threads, int dtype,
                                       cudaStream_t stream) {
  if (D % 16 || D < 16 || D > capdec::kQuantMaxD || blocks < 1 ||
      threads % 32 || threads < 32 || threads > capdec::kQuantThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  int8_t* k8 = static_cast<int8_t*>(k);
  int8_t* v8 = static_cast<int8_t*>(v);
  if (dtype == capdec::kBF16)
    capdec::launch_quant_units<__nv_bfloat16>(k8, v8, ks, vs, nk, nv,
                                              2 * B * L, E, D, step, blocks,
                                              threads, stream);
  else
    capdec::launch_quant_units<float>(k8, v8, ks, vs, nk, nv, 2 * B * L, E,
                                      D, step, blocks, threads, stream);
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
