// K1: fused tied LM head + logsumexp + exact top-R over the vocabulary.
//
// Replaces capdec_tpu/ops/lm_head.py::lm_head_topk (pl.pallas_call at
// :334). For hidden h [B, D] and the tied embedding w [V, D] it returns
// the top-R values of h @ w^T (f32), their indices (lowest index wins a
// tie, as lax.top_k) and the row logsumexp. The [B, V] logits never reach
// device memory.
//
// Bound on the H100: at the main-path shape (B = 320, V = 50257, D = 768,
// bf16) the product is 24.7 GFLOP against 77 MB of weights, about 320
// operations per byte, so the tensor cores bound it (25 us at 989
// TFLOP/s) just above the 23 us the bytes need. The f32 path (used for
// the token-identity check only) has no tensor-core route without TF32
// and is bound by the 67 TFLOP/s of the FMA units.
//
// Design, simple first:
//   pass 1: one block per (64-row tile, 128-entry vocab chunk); blockIdx.x
//           walks the row tiles so the blocks sharing a weight chunk run
//           together and read it from L2. The block forms its [64, 128]
//           score tile in shared memory (bf16: WMMA tensor-core tiles with
//           f32 accumulation; f32: FMA), then one warp per row reduces it
//           to (max, sum-exp, top-R) for the chunk, written to a small
//           scratch array [B, NC(, R)].
//   pass 2: one warp per row merges the NC chunk entries: logsumexp
//           m + log(l), and the top-R in selection order.
// Top-R selection runs R rounds of a warp reduction, each round taking
// the first candidate (value desc, index asc) strictly after the previous
// pick, so no candidate is masked or stored twice.
#include <float.h>
#include <limits.h>
#include <mma.h>

#include "common.cuh"

namespace capdec {
namespace {

constexpr int TB = 64;        // hidden rows per block
constexpr int VC = 128;       // vocab entries per block (one chunk)
constexpr int KT = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 8 warps
constexpr int SLD = VC + 4;   // leading dim of the f32 score tile

constexpr int F_LD = KT + 1;  // f32 operand tiles, padded against conflicts
constexpr int B_LD = KT + 8;  // bf16 operand tiles (80 bytes: WMMA ld rule)
constexpr int SMEM_BYTES = TB * SLD * 4;  // score tile; operands alias it
static_assert((TB + VC) * F_LD * 4 <= SMEM_BYTES, "f32 operands fit");
static_assert((TB + VC) * B_LD * 2 <= SMEM_BYTES, "bf16 operands fit");

// f32: thread (ty, tx) accumulates rows ty*4+i, columns tx+16*j.
__device__ void score_tile(const float* __restrict__ h,
                           const float* __restrict__ w, int B, int V, int D,
                           int row0, int v0, unsigned char* smem) {
  float* hs = reinterpret_cast<float*>(smem);  // [TB][F_LD]
  float* ws = hs + TB * F_LD;                  // [VC][F_LD]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += KT) {
    for (int e = tid; e < TB * KT; e += THREADS) {
      const int r = e / KT, kk = e % KT, row = row0 + r, k = k0 + kk;
      hs[r * F_LD + kk] = (row < B && k < D) ? h[(size_t)row * D + k] : 0.f;
    }
    for (int e = tid; e < VC * KT; e += THREADS) {
      const int n = e / KT, kk = e % KT, g = v0 + n, k = k0 + kk;
      ws[n * F_LD + kk] = (g < V && k < D) ? w[(size_t)g * D + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[(ty * 4 + i) * F_LD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[(tx + 16 * j) * F_LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[(ty * 4 + i) * SLD + tx + 16 * j] = acc[i][j];
}

// bf16: warp (wm, wn) owns rows wm*16..+16 and columns wn*64..+64 as four
// 16x16 WMMA accumulators. Operands move as 16-byte vectors (D % 8 == 0).
__device__ void score_tile(const __nv_bfloat16* __restrict__ h,
                           const __nv_bfloat16* __restrict__ w, int B, int V,
                           int D, int row0, int v0, unsigned char* smem) {
  using namespace nvcuda;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);  // [TB][B_LD]
  __nv_bfloat16* ws = hs + TB * B_LD;                          // [VC][B_LD]
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);
  constexpr int VPR = KT / 8;  // 16-byte vectors per operand row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < D; k0 += KT) {
    for (int e = tid; e < TB * VPR; e += THREADS) {
      const int r = e / VPR, c8 = (e % VPR) * 8, row = row0 + r, k = k0 + c8;
      *reinterpret_cast<uint4*>(hs + r * B_LD + c8) =
          (row < B && k < D)
              ? *reinterpret_cast<const uint4*>(h + (size_t)row * D + k)
              : zero;
    }
    for (int e = tid; e < VC * VPR; e += THREADS) {
      const int n = e / VPR, c8 = (e % VPR) * 8, g = v0 + n, k = k0 + c8;
      *reinterpret_cast<uint4*>(ws + n * B_LD + c8) =
          (g < V && k < D)
              ? *reinterpret_cast<const uint4*>(w + (size_t)g * D + k)
              : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, hs + (wm * 16) * B_LD + kk, B_LD);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(b, ws + (wn * 64 + f * 16) * B_LD + kk, B_LD);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();
  }
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int f = 0; f < 4; ++f)
    wmma::store_matrix_sync(sc + (wm * 16) * SLD + wn * 64 + f * 16, acc[f],
                            SLD, wmma::mem_row_major);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lm_head_pass1(const T* __restrict__ h, const T* __restrict__ w, int B,
                  int V, int D, int R, int NC, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_v,
                  int* __restrict__ part_i) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int row0 = blockIdx.x * TB, c = blockIdx.y, v0 = c * VC;
  score_tile(h, w, B, V, D, row0, v0, smem);
  __syncthreads();
  const float* sc = reinterpret_cast<const float*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int PER_LANE = VC / 32;
  for (int r = warp; r < TB; r += THREADS / 32) {
    const int row = row0 + r;
    if (row >= B) break;
    float s[PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int col = lane + 32 * j;
      s[j] = (v0 + col < V) ? sc[r * SLD + col] : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = warp_max(mx);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (v0 + lane + 32 * j < V) l += expf(s[j] - mx);
    l = warp_sum(l);
    const size_t slot = (size_t)row * NC + c;
    if (lane == 0) {
      part_m[slot] = mx;
      part_l[slot] = l;
    }
    float pv = INFINITY;
    int pi = -1;
    for (int k = 0; k < R; ++k) {
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int g = v0 + lane + 32 * j;
        if (g < V && ranks_before(pv, pi, s[j], g) &&
            ranks_before(s[j], g, bv, bi)) {
          bv = s[j];
          bi = g;
        }
      }
      warp_best(bv, bi);
      if (lane == 0) {
        part_v[slot * R + k] = bv;
        part_i[slot * R + k] = bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

__global__ void lm_head_pass2(const float* __restrict__ part_m,
                              const float* __restrict__ part_l,
                              const float* __restrict__ part_v,
                              const int* __restrict__ part_i, int B, int NC,
                              int R, float* __restrict__ vals,
                              int64_t* __restrict__ idx,
                              float* __restrict__ lse) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= B) return;
  const float* m = part_m + (size_t)row * NC;
  const float* l = part_l + (size_t)row * NC;
  float M = -INFINITY;
  for (int c = lane; c < NC; c += 32) M = fmaxf(M, m[c]);
  M = warp_max(M);
  float S = 0.f;
  for (int c = lane; c < NC; c += 32) S += l[c] * expf(m[c] - M);
  S = warp_sum(S);
  if (lane == 0) lse[row] = M + logf(S);
  const float* cv = part_v + (size_t)row * NC * R;
  const int* ci = part_i + (size_t)row * NC * R;
  const int n = NC * R;
  float pv = INFINITY;
  int pi = -1;
  for (int k = 0; k < R; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int e = lane; e < n; e += 32) {
      const float v = cv[e];
      const int i = ci[e];
      if (ranks_before(pv, pi, v, i) && ranks_before(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      vals[(size_t)row * R + k] = bv;
      idx[(size_t)row * R + k] = bi;
    }
    pv = bv;
    pi = bi;
  }
}

template <typename T>
void launch(const void* h, const void* w, int B, int V, int D, int R, int NC,
            float* part_m, float* part_l, float* part_v, int* part_i,
            float* vals, int64_t* idx, float* lse, cudaStream_t stream) {
  dim3 grid1((B + TB - 1) / TB, NC);
  lm_head_pass1<T><<<grid1, THREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), B, V, D, R, NC,
      part_m, part_l, part_v, part_i);
  constexpr int ROWS2 = 4;
  lm_head_pass2<<<(B + ROWS2 - 1) / ROWS2, 32 * ROWS2, 0, stream>>>(
      part_m, part_l, part_v, part_i, B, NC, R, vals, idx, lse);
}

}  // namespace
}  // namespace capdec

extern "C" int capdec_lm_head_topk(const void* h, const void* w, int B, int V,
                                   int D, int R, int NC, float* part_m,
                                   float* part_l, float* part_v, int* part_i,
                                   float* vals, int64_t* idx, float* lse,
                                   int dtype, cudaStream_t stream) {
  if (dtype == capdec::kBF16)
    capdec::launch<__nv_bfloat16>(h, w, B, V, D, R, NC, part_m, part_l, part_v,
                                  part_i, vals, idx, lse, stream);
  else
    capdec::launch<float>(h, w, B, V, D, R, NC, part_m, part_l, part_v,
                          part_i, vals, idx, lse, stream);
  return static_cast<int>(cudaGetLastError());
}
