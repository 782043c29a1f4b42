// The decode step's block epilogues: the elementwise and layernorm work
// that gpt2.decode_step runs between a block's products, one launch where
// PyTorch ran three to eight (ops/epilogue.py holds the wrappers and the
// plain versions, which are the op chains these replace).
//
// No TPU kernel: on the TPU, XLA fused this work into the products'
// neighbours inside the jitted step. In the eager port each op of the chain
// was its own launch and its own pass through device memory, with a
// float32 round trip around every bias add: 22 of a block's 27 launches.
//
//   bias_act<T, false>  (bias_cast, c_attn's epilogue)
//       out = T(f32(y) + b)
//   bias_act<T, true>   (bias_gelu_cast, c_fc's epilogue)
//       out = T(gelu_tanh(f32(y) + b))
//   residual_layernorm<T, false, ·>  (bias_residual_layernorm, c_projs)
//       x' = T(f32(x) + f32(T(f32(y) + b)))
//       h  = T(g · (rstd · (f32(x') - mean)) + beta)
//     with mean and rstd over the row of x' in float32; after the
//     attention's c_proj with ln_2, after the MLP's with the next block's
//     ln_1 (ln_f after the last block), so no block launches a layernorm
//   residual_layernorm<T, true, ·>  (embed_layernorm, the step's entry)
//       x' = T(f32(e) + f32(p)), e the token embeddings, p a row of wpe;
//       h as above with block 0's ln_1
//
// T is the compute dtype (float32 or bfloat16); y is a product's output in
// T as cuBLAS gives it; b, g and beta are float32. Each value is rounded to
// T exactly where the chain rounds it (T(·) above) and nowhere else; GELU
// is PyTorch's tanh form in float32 with its constants and its order of
// operations; rounding is to nearest even, as PyTorch's casts. The
// layernorm's mean and variance are taken in two passes over the row held
// in registers, where PyTorch's kernel uses Welford's update: the two may
// differ in the last bit of rstd, and then an output of T by one unit in
// its last place.
//
// Bound: bytes. Each kernel reads its inputs once and writes its outputs
// once: at B 2560 rows (batch 512 x beam 5) in bfloat16, bias_cast
// [2560, 2304] moves 23.6 MB (7.0 µs at 3.35 TB/s), bias_gelu_cast
// [2560, 3072] 31.5 MB (9.4 µs), bias_residual_layernorm [2560, 768]
// 15.7 MB (4.7 µs); the float32 bias, g and beta (a few KB) stay in L1/L2.
// The design for that bound: every access to a row is a 16-byte vector
// (8 bf16 or 4 f32 values), neighbouring lanes on neighbouring vectors.
// bias_act gives each thread one vector, so a wave of the card keeps
// 2048 x 16 bytes of loads in flight on each SM; residual_layernorm gives
// each row one warp, which holds the row in registers (at 768, 3 vectors
// a lane in bf16, 6 in f32), sums it with shuffles and writes x' and h
// once each. The wrappers' plans (ops/epilogue.py) shrink the blocks
// until the grid has a block for every SM where the work allows it (one
// warp a block at one image, B 5).
//
// Widths: bias_act takes any row of whole 16-byte vectors (a tp rank's
// c_attn and c_fc too, 1152 and 1536 at tp 2); residual_layernorm rows of
// whole vectors up to kMaxWidth, GPT-2 XL's 1600 included, in two
// instances a dtype: one for rows of exactly kFullWidth (GPT-2 124M's
// 768: every lane holds the same vectors, so the width is a constant and
// no lane tests its vectors against the row) and one for any other width
// up to kMaxWidth, whose lanes past the row sit out.
//
// Outputs may be written in place: each thread reads its vectors of y
// (bias_act) or x (residual_layernorm) before it writes the same vectors
// of out or x', so those pointers may be equal (decode_step updates the
// residual x in place and reuses one h and one GELU buffer a step,
// sparing the allocations); h must not overlap x, y or x'.
#include "common.cuh"

namespace capdec {
namespace {

// residual_layernorm's rows: at most kMaxWidth values; the instance for
// kFullWidth (GPT-2 124M's n_embd) is specialised to it.
constexpr int kFullWidth = 768;
constexpr int kMaxWidth = 1792;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

// n values of T from 16 aligned bytes, in float32 (exact).
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  out[0] = w.x;
  out[1] = w.y;
  out[2] = w.z;
  out[3] = w.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// n float32 values rounded to T, into 16 aligned bytes.
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 w;
  w.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  w.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  w.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  w.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = w;
}

// v rounded to T and read back in float32.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// n float32 values of a bias, g or beta (read through the non-coherent
// cache: they stay constant through the launch).
template <int n>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p + i));
    out[i] = w.x;
    out[i + 1] = w.y;
    out[i + 2] = w.z;
    out[i + 3] = w.w;
  }
}

// PyTorch's GELU, approximate="tanh", in float32 (its CUDA kernel's
// constants and order: kBeta = sqrt(2) · (2 / sqrt(pi)) · 0.5 and kKappa
// rounded from double to float).
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = static_cast<float>(
      1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  constexpr float kKappa = static_cast<float>(0.044715);
  const float cube = x * x * x;
  const float inner = kBeta * (x + kKappa * cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

template <typename T, bool kGelu>
__global__ void __launch_bounds__(256)
    bias_act(const T* y, const float* __restrict__ b, T* out, int vectors,
             int row_vectors) {
  constexpr int n = Vec<T>::n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= vectors) return;
  float v[n], bias[n];
  load_vec(y + static_cast<size_t>(i) * n, v);
  load_f32<n>(b + (i % row_vectors) * n, bias);
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float t = v[k] + bias[k];
    v[k] = kGelu ? gelu_tanh(t) : t;
  }
  store_vec(out + static_cast<size_t>(i) * n, v);
}

// kPer: the most 16-byte vectors a lane holds, so rows of up to
// 32 x kPer vectors; a lane's vectors past the row sit out. kFull: rows of
// exactly 32 x kPer vectors (row_vectors unread).
template <typename T, bool kEntry, int kPer, bool kFull>
__global__ void __launch_bounds__(128)
    residual_layernorm(const T* x, const T* __restrict__ y,
                       const void* __restrict__ add,
                       const float* __restrict__ g,
                       const float* __restrict__ beta, T* x_out,
                       T* __restrict__ h_out, int rows, int row_vectors,
                       float eps) {
  constexpr int n = Vec<T>::n;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  if (kFull) row_vectors = 32 * kPer;
  const int width = row_vectors * n;
  const size_t base = static_cast<size_t>(row) * width;
  float v[kPer][n];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!kFull && j * 32 + lane >= row_vectors) break;
    const int c = (j * 32 + lane) * n;
    float a[n], p[n];
    load_vec(y + base + c, a);
    if (kEntry) {
      load_vec(static_cast<const T*>(add) + c, p);
#pragma unroll
      for (int k = 0; k < n; ++k) v[j][k] = round_to(a[k] + p[k], y);
    } else {
      float r[n];
      load_f32<n>(static_cast<const float*>(add) + c, p);
      load_vec(x + base + c, r);
#pragma unroll
      for (int k = 0; k < n; ++k)
        v[j][k] = round_to(r[k] + round_to(a[k] + p[k], y), y);
    }
    store_vec(x_out + base + c, v[j]);
#pragma unroll
    for (int k = 0; k < n; ++k) sum += v[j][k];
  }
  const float mean = warp_sum(sum) / width;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!kFull && j * 32 + lane >= row_vectors) break;
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const float d = v[j][k] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / width + eps);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!kFull && j * 32 + lane >= row_vectors) break;
    const int c = (j * 32 + lane) * n;
    float gg[n], bb[n], h[n];
    load_f32<n>(g + c, gg);
    load_f32<n>(beta + c, bb);
#pragma unroll
    for (int k = 0; k < n; ++k)
      h[k] = gg[k] * (rstd * (v[j][k] - mean)) + bb[k];
    store_vec(h_out + base + c, h);
  }
}

template <typename T>
int launch_bias_act(const void* y, const float* b, void* out, int rows,
                    int width, int gelu, int threads, cudaStream_t stream) {
  if (width % Vec<T>::n) return static_cast<int>(cudaErrorInvalidValue);
  const int row_vectors = width / Vec<T>::n;
  const int vectors = rows * row_vectors;
  const int blocks = (vectors + threads - 1) / threads;
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  if (gelu)
    bias_act<T, true><<<blocks, threads, 0, stream>>>(yt, b, ot, vectors,
                                                      row_vectors);
  else
    bias_act<T, false><<<blocks, threads, 0, stream>>>(yt, b, ot, vectors,
                                                       row_vectors);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kEntry, int kPer, bool kFull>
void launch_rows(const void* x, const void* y, const void* add,
                 const float* g, const float* beta, void* x_out, void* h_out,
                 int rows, int row_vectors, float eps, int warps,
                 cudaStream_t stream) {
  residual_layernorm<T, kEntry, kPer, kFull>
      <<<(rows + warps - 1) / warps, 32 * warps, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(y), add, g, beta,
          static_cast<T*>(x_out), static_cast<T*>(h_out), rows, row_vectors,
          eps);
}

template <typename T, bool kEntry>
void launch_width(const void* x, const void* y, const void* add,
                  const float* g, const float* beta, void* x_out,
                  void* h_out, int rows, int width, float eps, int warps,
                  cudaStream_t stream) {
  constexpr int n = Vec<T>::n;
  const int row_vectors = width / n;
  if (width == kFullWidth)
    launch_rows<T, kEntry, kFullWidth / (32 * n), true>(
        x, y, add, g, beta, x_out, h_out, rows, row_vectors, eps, warps,
        stream);
  else
    launch_rows<T, kEntry, kMaxWidth / (32 * n), false>(
        x, y, add, g, beta, x_out, h_out, rows, row_vectors, eps, warps,
        stream);
}

template <typename T>
int launch_residual_layernorm(const void* x, const void* y, const void* add,
                              const float* g, const float* beta, void* x_out,
                              void* h_out, int rows, int width, float eps,
                              int entry, int warps, cudaStream_t stream) {
  if (width % Vec<T>::n) return static_cast<int>(cudaErrorInvalidValue);
  if (entry)
    launch_width<T, true>(x, y, add, g, beta, x_out, h_out, rows, width, eps,
                          warps, stream);
  else
    launch_width<T, false>(x, y, add, g, beta, x_out, h_out, rows, width,
                           eps, warps, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace capdec

// out [rows, width] = T(f32(y) + b), or T(gelu_tanh(f32(y) + b)) with
// `gelu`; rows of whole 16-byte vectors, `threads` 32-256 a block.
extern "C" int capdec_bias_act(const void* y, const float* b, void* out,
                               int rows, int width, int dtype, int gelu,
                               int threads, cudaStream_t stream) {
  if (rows < 1 || width < 1 || threads < 32 ||
      threads > 256 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == capdec::kBF16)
    return capdec::launch_bias_act<__nv_bfloat16>(y, b, out, rows, width,
                                                  gelu, threads, stream);
  if (dtype == capdec::kF32)
    return capdec::launch_bias_act<float>(y, b, out, rows, width, gelu,
                                          threads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x_out, h_out [rows, width]: the residual sum and its layernorm (`entry` 0:
// x, y in T and the f32 bias `add`) or the step's entry (`entry` 1: y the
// token embeddings, `add` a row of wpe in T; x unread); rows of whole
// 16-byte vectors up to kMaxWidth values, `warps` 1-4 a block, one a row.
extern "C" int capdec_residual_layernorm(const void* x, const void* y,
                                         const void* add, const float* g,
                                         const float* beta, void* x_out,
                                         void* h_out, int rows, int width,
                                         float eps, int dtype, int entry,
                                         int warps, cudaStream_t stream) {
  if (rows < 1 || width < 1 || width > capdec::kMaxWidth || warps < 1 ||
      warps > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == capdec::kBF16)
    return capdec::launch_residual_layernorm<__nv_bfloat16>(
        x, y, add, g, beta, x_out, h_out, rows, width, eps, entry, warps,
        stream);
  if (dtype == capdec::kF32)
    return capdec::launch_residual_layernorm<float>(
        x, y, add, g, beta, x_out, h_out, rows, width, eps, entry, warps,
        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
