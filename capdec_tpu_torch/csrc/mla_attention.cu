// K16: absorbed multi-head latent attention (MLA) of one decode step, and
// the latent's entry (its RMSNorm and the rotary embedding of the step's
// rope parts).
//
// K16 mla_decode_attention (no TPU counterpart: the JAX package decodes
// GPT-2 only). DeepSeek-V2/V3-style attention, as the Kimi-VL-A3B text
// model runs it, decodes against a cache of one 576-value latent row per
// token and layer: c_kv (512, RMS-normed) and the rope key k_pe (64),
// shared by the 16 heads. In the absorbed form each head's query is
// q_lat = q_nope W_UK[h] (512) beside q_pe (64), a score is
// q_lat . c_kv + q_pe . k_pe, and the head's output is p . c_kv (512),
// which W_UV[h] maps to the head's 128 values afterwards
// (models/mla_moe.py). So the 16 heads of a beam row read the same
// latent rows, and every beam of an image reads the image's prefix rows.
//
// Bound on the H100: bytes. At batch 512 x beam 5 and step s, a layer's
// call reads the prefix latent once per image (40 x 1152 B) and each
// row's s generated slots (s x 1152 B): 195 MB at s = 66, 58 us at 3.35
// TB/s, against 2 x 2560 x 16 x 107 x 1088 = 9.5 GFLOP, 10 us on the
// tensor cores.
//
// Design: one block of four warps a beam row b (image b / R). It copies
// the row's 16 queries ([q_lat | q_pe], 576 values a head) into shared
// memory, and the latent rows it attends over (the image's prefix, the
// row's slots below `step`, and the step's own latent) in chunks of 32,
// each chunk's 16-byte cp.async copies issued while the chunk before it
// computes (two buffers), rows padded to 1168 bytes (73 words, so the 8
// rows an ldmatrix reads meet 8 bank groups). A chunk's scores S = Q C^T
// run on the tensor cores (mma.sync m16n8k16, the 16 heads as M, a warp's
// 8 slots as N, 36 k-steps over the 576 values); then an online softmax
// in f32 (a warp four heads, a lane a slot: the running max and sum, the
// numerators rounded to bf16), and O = O alpha + P C[:, :512] (a warp 128
// of the 512 values, the chunk's slots as k); the sums divide O at the
// end. The output is the heads' latent outputs [H, B, 512] (bf16),
// head-major so that the W_UV products read each head's rows
// contiguously. The prefix is read once per beam, from the L2 for all but
// the first beam of an image. A block takes 98 KB of shared memory, so two
// share an SM and one's copies run under the other's products. (The first
// version held every slot at once, 80-161 KB, one block an SM, and read
// 0.290 ms at step 66, 32 % of the bound; PERF.md §6 PR 22.)
//
// mla_prep: one warp a row of the step: c_kv's RMSNorm (f32 sums, the
// kv_a_layernorm weight) and the rotary embedding (rotate-half form, f32)
// of k_pe into the step's latent row, and of each head's q_pe in place in
// the query projection's output.
#include "common.cuh"

namespace capdec {
namespace {

constexpr int kHeads = 16;         // query heads a row
constexpr int kLat = 512;          // c_kv
constexpr int kRope = 64;          // k_pe / q_pe
constexpr int kRow = kLat + kRope; // a latent row: 576 values
constexpr int kPitch = kRow + 8;   // shared-memory row: 1168 bytes
constexpr int kWords = kRow / 8;   // 16-byte words of a latent row: 72
constexpr int kThreads = 128;      // four warps
constexpr int kChunk = 32;         // slots a chunk: a tile of 8 a warp
constexpr int kPStride = kChunk + 8;  // a numerator row: 80 bytes

// Bytes of dynamic shared memory: the queries, two chunk buffers of
// latent rows, a chunk's f32 scores and bf16 numerators, and each head's
// running max, sum and rescale. ops/mla_attention.py computes the same.
constexpr int kSmem = (kHeads + 2 * kChunk) * kPitch * 2 +
                      kHeads * kChunk * 4 + kHeads * kPStride * 2 +
                      3 * kHeads * 4;

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& a0, uint32_t& a1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(a0), "=r"(a1) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The source row of slot j of beam row b: the image's prefix (j < K), the
// row's generated slots (j < K + step), the step's own latent (j = K +
// step), or none (null: a zero row past the slots).
__device__ __forceinline__ const __nv_bfloat16* slot_row(
    int j, int K, int step, const __nv_bfloat16* pre,
    const __nv_bfloat16* gl, const __nv_bfloat16* nw) {
  return j < K ? pre + (size_t)j * kRow
               : j < K + step ? gl + (size_t)(j - K) * kRow
                              : j == K + step ? nw : nullptr;
}

// Copies of chunk c's kChunk latent rows into buf (zeros past the slots).
__device__ __forceinline__ void load_chunk(__nv_bfloat16* buf, int c, int S,
                                           int K, int step,
                                           const __nv_bfloat16* pre,
                                           const __nv_bfloat16* gl,
                                           const __nv_bfloat16* nw) {
  for (int i = threadIdx.x; i < kChunk * kWords; i += kThreads) {
    const int r = i / kWords, w = i % kWords, j = c * kChunk + r;
    __nv_bfloat16* dst = buf + r * kPitch + w * 8;
    if (j < S)
      copy16(dst, slot_row(j, K, step, pre, gl, nw) + w * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads)
    mla_decode_attention(const __nv_bfloat16* __restrict__ q_lat,
                         const __nv_bfloat16* __restrict__ q_pe, long qpe_row,
                         long qpe_head,
                         const __nv_bfloat16* __restrict__ lat_new,
                         long new_row, const __nv_bfloat16* __restrict__ prefix,
                         const __nv_bfloat16* __restrict__ gen,
                         __nv_bfloat16* __restrict__ out, int B, int R, int K,
                         int L, int E, int layer, int step, float scale2) {
  extern __shared__ __align__(128) unsigned char dyn[];
  const int b = blockIdx.x, n = b / R, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // mma fragment coordinates
  const int S = K + step + 1, chunks = (S + kChunk - 1) / kChunk;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(dyn);
  __nv_bfloat16* bufs = qs + kHeads * kPitch;          // [2][kChunk][kPitch]
  float* sc = reinterpret_cast<float*>(bufs + 2 * kChunk * kPitch);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(sc + kHeads * kChunk);
  float* run_m = reinterpret_cast<float*>(ps + kHeads * kPStride);
  float* run_l = run_m + kHeads;
  float* alpha = run_l + kHeads;
  const __nv_bfloat16* pre = prefix + ((size_t)layer * (B / R) + n) * K * kRow;
  const __nv_bfloat16* gl = gen + ((size_t)b * L + layer) * E * kRow;
  const __nv_bfloat16* nw = lat_new + b * new_row;

  // the queries and chunk 0, then each next chunk while this one computes
  for (int i = tid; i < kHeads * kWords; i += kThreads) {
    const int h = i / kWords, w = i % kWords;
    const __nv_bfloat16* src =
        w < kLat / 8 ? q_lat + ((size_t)h * B + b) * kLat + w * 8
                     : q_pe + b * qpe_row + h * qpe_head + (w - kLat / 8) * 8;
    copy16(qs + h * kPitch + w * 8, src);
  }
  load_chunk(bufs, 0, S, K, step, pre, gl, nw);
  copies_commit();
  if (tid < kHeads) {
    run_m[tid] = -INFINITY;
    run_l[tid] = 0.f;
  }
  float o[16][4];  // heads g, g + 8 by this warp's 128 values
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const int d0 = warp * 128;
  for (int c = 0; c < chunks; ++c) {
    __nv_bfloat16* buf = bufs + (c & 1) * kChunk * kPitch;
    if (c + 1 < chunks) {  // its buffer's last reader, chunk c - 1, is done
      load_chunk(bufs + ((c + 1) & 1) * kChunk * kPitch, c + 1, S, K, step,
                 pre, gl, nw);
      copies_commit();
      copies_wait<1>();
    } else {
      copies_wait<0>();
    }
    __syncthreads();
    // scores of the chunk's tile `warp` (8 slots): S = Q C^T x scale2
    {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* qa = qs + (lane & 15) * kPitch + (lane >> 4) * 8;
      const __nv_bfloat16* cb =
          buf + (warp * 8 + (lane & 7)) * kPitch + ((lane >> 3) & 1) * 8;
#pragma unroll 4
      for (int kk = 0; kk < kRow / 16; ++kk) {
        uint32_t a[4], b0, b1;
        ldsm_x4(a, qa + kk * 16);
        ldsm_x2(b0, b1, cb + kk * 16);
        mma16816(acc, a, b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (head g (+8), slot 8 warp + 2q (+1))
        const int h = g + (e >> 1) * 8, s = warp * 8 + 2 * q + (e & 1);
        sc[h * kChunk + s] =
            c * kChunk + s < S ? acc[e] * scale2 : -INFINITY;
      }
    }
    __syncthreads();
    // online softmax: a warp four heads, a lane a slot of the chunk
    for (int h = warp * 4; h < warp * 4 + 4; ++h) {
      const float s = sc[h * kChunk + lane];
      const float m_new = fmaxf(run_m[h], warp_max(s));
      const float p = exp2f(s - m_new);  // exp2(-inf) = 0
      ps[h * kPStride + lane] = __float2bfloat16_rn(p);
      const float l = warp_sum(p);
      if (lane == 0) {
        const float a = exp2f(run_m[h] - m_new);  // 0 on the first chunk
        alpha[h] = a;
        run_l[h] = run_l[h] * a + l;
        run_m[h] = m_new;
      }
    }
    __syncthreads();
    // O = O alpha + P C: the slots as k, two steps of 16
    const float a0 = alpha[g], a1 = alpha[g + 8];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j][0] *= a0, o[j][1] *= a0, o[j][2] *= a1, o[j][3] *= a1;
    }
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, ps + (lane & 15) * kPStride + k0 + (lane >> 4) * 8);
      const __nv_bfloat16* cb =
          buf + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + d0 +
          (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        uint32_t bt[4];
        ldsm_x4_t(bt, cb + j * 8);
        mma16816(o[j], a, bt[0], bt[1]);
        mma16816(o[j + 1], a, bt[2], bt[3]);
      }
    }
    __syncthreads();  // the buffer and the numerators are free again
  }
  const float inv0 = 1.f / run_l[g], inv1 = 1.f / run_l[g + 8];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int d = d0 + 8 * j + 2 * q;
    *reinterpret_cast<uint32_t*>(out + ((size_t)g * B + b) * kLat + d) =
        pack2(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(out + ((size_t)(g + 8) * B + b) * kLat + d) =
        pack2(o[j][2] * inv1, o[j][3] * inv1);
  }
}

// a cos - b sin and b cos + a sin, each product rounded (no FMA).
__device__ __forceinline__ float rot_lo(float a, float b, float c, float s) {
  return __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s));
}
__device__ __forceinline__ float rot_hi(float a, float b, float c, float s) {
  return __fadd_rn(__fmul_rn(b, c), __fmul_rn(a, s));
}

// One warp a row: the step's latent row (normed c_kv, rotated k_pe) from
// the kv_a product, and each head's q_pe rotated in place.
__global__ void mla_prep(__nv_bfloat16* __restrict__ q, long q_row,
                         const __nv_bfloat16* __restrict__ kv, long kv_row,
                         const float* __restrict__ norm_w,
                         const float* __restrict__ cos_,
                         const float* __restrict__ sin_, float eps,
                         __nv_bfloat16* __restrict__ lat, long lat_row, int B,
                         int qk_head) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  const __nv_bfloat16* kr = kv + row * kv_row;
  __nv_bfloat16* lr = lat + row * lat_row;
  float x[16];
#pragma unroll
  for (int c = 0; c < 2; ++c) {  // words lane and lane + 32 of c_kv
    const uint4 w = *reinterpret_cast<const uint4*>(kr + (lane + 32 * c) * 8);
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[8 * c + 2 * j] = __uint_as_float(u[j] << 16);
      x[8 * c + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) ss += x[i] * x[i];
  const float inv = rsqrtf(warp_sum(ss) / kLat + eps);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int e0 = (lane + 32 * c) * 8;
    uint32_t p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[j] = pack2(__fmul_rn(__fmul_rn(x[8 * c + 2 * j], inv),
                             norm_w[e0 + 2 * j]),
                   __fmul_rn(__fmul_rn(x[8 * c + 2 * j + 1], inv),
                             norm_w[e0 + 2 * j + 1]));
    *reinterpret_cast<uint4*>(lr + e0) = make_uint4(p[0], p[1], p[2], p[3]);
  }
  // rotate-half: pair (i, i + 32) of the 64 rope values, lane i; each
  // product and sum rounded as the plain version's (no contraction)
  const float cs = cos_[lane], sn = sin_[lane];
  {
    const float a = __bfloat162float(kr[kLat + lane]);
    const float b2 = __bfloat162float(kr[kLat + lane + 32]);
    lr[kLat + lane] = __float2bfloat16_rn(rot_lo(a, b2, cs, sn));
    lr[kLat + lane + 32] = __float2bfloat16_rn(rot_hi(a, b2, cs, sn));
  }
  __nv_bfloat16* qr = q + row * q_row;
#pragma unroll 4
  for (int h = 0; h < kHeads; ++h) {
    __nv_bfloat16* pe = qr + h * qk_head + (qk_head - kRope);
    const float a = __bfloat162float(pe[lane]);
    const float b2 = __bfloat162float(pe[lane + 32]);
    pe[lane] = __float2bfloat16_rn(rot_lo(a, b2, cs, sn));
    pe[lane + 32] = __float2bfloat16_rn(rot_hi(a, b2, cs, sn));
  }
}

}  // namespace
}  // namespace capdec

// K16 on one block of 128 threads a beam row; `smem` must be the plan's
// (ops/mla_attention.py mla_attention_plan).
extern "C" int capdec_mla_decode_attention(
    const void* q_lat, const void* q_pe, long qpe_row, long qpe_head,
    const void* lat_new, long new_row, const void* prefix, const void* gen,
    void* out, int B, int R, int K, int L, int E, int layer, int step,
    float scale2, int smem, cudaStream_t stream) {
  using namespace capdec;
  if (B < 1 || R < 1 || B % R || K < 1 || step < 0 || step >= E ||
      layer < 0 || layer >= L || smem != kSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_attention, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  mla_decode_attention<<<B, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q_lat),
      static_cast<const __nv_bfloat16*>(q_pe), qpe_row, qpe_head,
      static_cast<const __nv_bfloat16*>(lat_new), new_row,
      static_cast<const __nv_bfloat16*>(prefix),
      static_cast<const __nv_bfloat16*>(gen),
      static_cast<__nv_bfloat16*>(out), B, R, K, L, E, layer, step, scale2);
  return static_cast<int>(cudaGetLastError());
}

// mla_prep on blocks of four warps, one warp a row.
extern "C" int capdec_mla_prep(void* q, long q_row, const void* kv,
                               long kv_row, const float* norm_w,
                               const float* cos_, const float* sin_, float eps,
                               void* lat, long lat_row, int B, int qk_head,
                               cudaStream_t stream) {
  using namespace capdec;
  if (B < 1 || qk_head < kRope) return static_cast<int>(cudaErrorInvalidValue);
  mla_prep<<<(B + 3) / 4, 128, 0, stream>>>(
      static_cast<__nv_bfloat16*>(q), q_row,
      static_cast<const __nv_bfloat16*>(kv), kv_row, norm_w, cos_, sin_, eps,
      static_cast<__nv_bfloat16*>(lat), lat_row, B, qk_head);
  return static_cast<int>(cudaGetLastError());
}
