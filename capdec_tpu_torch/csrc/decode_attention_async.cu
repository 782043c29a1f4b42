// K2, K6, K8, K9 and K15: one layer's beam-decode attention, its head
// slices staged in shared memory by asynchronous copies that complete on
// mbarriers.
//
// Replaces capdec_tpu/ops/decode_attention.py::beam_decode_attention_rowmajor
// (the function at :719, pl.pallas_call at :765, body _kernel_rm :186-241),
// ::beam_decode_attention_rowmajor_q (the function at :646, pl.pallas_call
// at :684, body _kernel_rm_q :244-323), ::beam_decode_attention_chunked (the
// function at :484, pl.pallas_call at :523, body _kernel_rm_chunked
// :326-454), ::beam_decode_attention_chunked_q (the function at :569,
// pl.pallas_call at :620, the same body with int8 scales) and
// ::beam_decode_attention (the function at :794, pl.pallas_call at :825,
// body _kernel :67-136). All compute one function: for beam row b of image
// n = b / R and each head, a softmax over
//   * the image's prefix slots      pk/pv [L, N, K, D]  (all K),
//   * the row's generated slots     gk/gv [B, L, E, D]  below n_gen,
//   * the current token             k_new/v_new [B, D]  (row stride qs),
// then the probability-weighted sum of V, written as f32 out [B, D]. K2 and
// K6 read n_gen = min(step, e_cap) slots, K8 and K9 n_gen = step: the caller
// passes n_gen, and the K8 entry is the K2 entry under its own name. The
// slot policies of the others:
//   * K6 and K9: the generated cache holds int8 levels with f32 absmax
//     scales gks/gvs [B, L, 1, E] (value = level · scale), and K9's prefix
//     with pks/pvs [L, N, 1, K] too. A slot's K scale multiplies its score
//     after the head sum, before 1/sqrt(hd); its V scale folds into its
//     probability before P is rounded to q's type (the plain version's
//     order). The current token stays unquantised (scale 1); q is never
//     quantised. K9 widens each landed int8 stage in shared memory, levels
//     being exact in bf16, and takes the same tensor-core path as K2. K6
//     (a prefix of q's type) reads each landed int8 stage in place instead
//     and widens the levels in registers (below).
//   * K15: the v1 kernel, one layer's caches [B, E, D] read as L = 1,
//     n_gen = step; the block for (head h, rows) also stores head h's
//     columns of its rows' k_new/v_new into slot `step` of gk/gv, in place.
//     No copy reads slot `step` (copies stop below n_gen), so the write
//     needs no ordering; every other slot's bits stay as they were.
//
// Bound on the H100: bytes. A call reads one layer's prefix once per image
// (2·N·K·D values), each row's live generated slots (2·B·n_gen·D) and
// q/k/v, and does about 4 operations per byte: at the served shape (N 64 x
// R 5, K 40, step 66, D 768, bf16) 75.2 MB, 22.4 µs at 3.35 TB/s. What
// reaches the bound is bytes in flight, not arithmetic: the kernels this
// one replaced kept about one 128-byte row per warp in flight behind a
// serial chain of warp sums, and ran at 2.8-3.2x the bound.
//
// K6's and K9's bytes are half of K2's in the generated cache (and, with
// K9's int8 prefix, in the prefix) plus 8 bytes of scales a slot (K6 at the
// served shape: 42.9 MB, 12.8 µs); K15's add the slot it writes (2·B·D).
//
// Design: one block per (head, image, group of at most 16 rows) serves the
// group's rows (the prefix leaves device memory once per image and group;
// the served R = 5 and R = 1 have one group): 128 threads, about 25 KB of shared
// memory at the served shape, so six blocks share an SM and the served
// call's 768 blocks run in one wave. The last warp produces: it streams the
// block's head slices through a ring of two stages in shared memory as
// 16-byte `cp.async` copies (a copy holds no register; neighbouring lanes
// on neighbouring addresses; values kept in their stored type), each lane
// arriving on the stage's "full" mbarrier once its copies have landed
// (`cp.async.mbarrier.arrive.noinc`). The stages are the prefix K (with q,
// k_new, v_new), the K of chunks of `tile` generated slots of the block's
// rows, then the prefix V and the V chunks (K6: the V chunks, then the
// prefix V). The wrapper's plan sizes a chunk at 2 ceil(K / rows) slots
// (twice that for int8 levels), but never below the flagship's served
// stage (R 5 x 16 slots of bf16: 160 bytes of each head dimension) in
// whole 16-slot tensor-core units: at a short prefix (K 10) the prefix's
// measure gave 4 slots a row, stages of 2.5 KB whose mbarrier round trips
// and quarter-full units made the call 2.3x slower than at tile 16
// (PERF.md §6). Any tile runs; the layout follows from it. The other three
// warps consume each stage as it lands and release it on its "empty"
// mbarrier: they score the K stages, take one exact softmax over all of a
// row's scores (while the producer refills the freed ring with V), then sum
// the V stages. In bf16 the products run on the tensor cores (mma.sync
// m16n8k16, f32 sums): scores as K Q^T, 16 slots by 8 rows, and values as
// V^T P^T (P rounded to bf16, as the plain version rounds it), 16 dims by
// 8 rows, fed by ldmatrix from rows whose 16-byte words are swizzled so
// that eight slices meet eight bank groups; a gen chunk's unit keeps one
// row's column of the 8. The f32 path (parity, not speed) keeps FMA: LP =
// hd / 4 lanes take LP slots of one row, each lane one 16-byte word of all
// of them, and a reduce-scatter (LP - 1 shuffles) leaves each lane one
// slot's score. The consumer warps' value sums meet in shared memory in a
// fixed order, so the result does not depend on the timing.
//
// K6's generated slots run on the CUDA cores in f32 FMA, in both types: for
// each (row, head) they are a matrix-vector product with no reuse across
// rows, about 4 operations a byte, so tensor cores buy nothing there, and
// their fragments cost registers that six blocks an SM do not have (80 a
// thread). A 16-byte word of a landed int8 stage is 16 levels, so LQ =
// hd / 16 lanes take LQ slots of one row (unit k of a row takes slots k,
// k + units, ..., so that neighbouring units read neighbouring slots), each
// lane one word of all of them, and a reduce-scatter leaves each lane one
// slot's score. The value pass gives each thread 16 dims of one row and
// every J8-th slot, its sums held in registers over the chunks (sums kept
// in shared memory between stages were read at a 64-byte lane stride, which
// the banks serialise). A word is widened in registers with byte permutes
// and one subtraction a level (exact; no conversion instruction), and
// nothing is written back to shared memory: K9's widening pass through
// shared memory cost 13 µs of its 43 on the H100 (PERF.md §6). The current
// token is kept out of the int8 loops (its score is taken with the softmax,
// its value with the output), so they hold no branch. The prefix V comes
// last, so the tensor-core sums of the prefix are live in registers only
// for that stage (live over the int8 chunks they spilled at 80 registers).
//
// Not chosen, as measured on the H100 (PERF.md §6): one `cp.async.bulk`
// per 128-byte slice (the copy engine keeps too few such copies in flight)
// and whole items resident in two large blocks an SM (their waves run in
// step, and the memory idles while every block computes).
//
// Slots at or above n_gen may hold stale or NaN bits (a bounded fork copy,
// and at slot E - 1 the next slot in memory is the next layer's slot 0): no
// copy reaches them, so they never enter shared memory; the current token's
// slot is read from the copied k_new/v_new rows. K6's and K9's scales are
// copied for the slots below n_gen only (NaN above them would give 0 · NaN).
//
// Not carried over from the TPU kernels: the 0/1 head-grouping matmul (the
// head sums are lane shuffles), the 8-slot prefix padding (a copy takes any
// slot count), K9's one-hot scale matmul (the scales are indexed) and the
// sequential `chunk` grid axis (blocks run in no order; the chunks are
// parts of one block's work, and their tile is the plan's, not the
// caller's `chunk`).
#include "common.cuh"

namespace capdec {
namespace {

constexpr int kRowGroup = 16;  // rows a block serves: two mma row tiles

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Shared-memory layout of one block, as byte offsets from the dynamic base
// (each 16-byte aligned), for R = min(rows, kRowGroup) rows, values of
// tsize bytes (q, k_new, v_new), a generated cache of csize and a prefix of
// psize (tsize, or 1 for int8 levels); `inreg` (K6) reads the int8 cache's
// stages in place. The wrapper's plan (ops/decode_attention.py
// attention_plan) computes the same total; the launch refuses a mismatch.
struct Layout {
  int rowb;   // bytes of one head slice of T
  int NC;     // consumer warps; the last warp of the block produces
  int J;      // f32 value pass: consumer threads per (row, 16-byte word)
  int J8;     // K6's value pass: consumer threads per (row, 16-level word)
  int scw;    // score row width: K + nchunks * tile
  int stage;  // bytes a stage: max(K prefix slices, R * tile cache slices)
  // where each region starts; the mbarriers (nbuf full, nbuf empty) first
  int ring;   // nbuf stages, each as copied (int8 slices unswizzled)
  int wide;   // an int8 stage widened to T: max(K or R * tile) slices
  int red;    // bf16: the consumer warps' value sums f32 [NC][R/8][8][hd],
              // over the spent ring
  int cur;    // q, k_new, v_new: [3][R][hd] of T
  int sc;     // scores, then exp(score - max): f32 [R][scw]
  int scl;    // int8 scales f32: prefix K, V [K] each; cache K, V [R][n_gen]
  int part;   // f32: the value sums f32 [R][J][hd]
  int part8;  // K6: the generated slots' value sums f32 [R][J8][hd]
  int stats;  // the softmax sums: f32 [R]
  int total;
  __host__ __device__ Layout(int R, int K, int hd, int tsize, int csize,
                             int psize, int tile, int nbuf, int threads,
                             int n_gen, bool inreg) {
    rowb = hd * tsize;
    NC = threads / 32 - 1;
    J = imax(1, NC * 32 / (R * (rowb / 16)));
    J8 = inreg ? imax(1, NC * 32 / (R * (hd / 16))) : 0;
    scw = K + (n_gen + tile) / tile * tile;
    stage = up16(imax(K * hd * psize, R * tile * hd * csize));
    ring = up16(16 * nbuf);
    wide = ring + nbuf * stage;
    red = ring;
    cur = wide + (inreg ? 0
                        : imax(psize < tsize ? K : 0,
                               csize < tsize ? R * tile : 0) * rowb);
    if (tsize == 2) cur = imax(cur, red + NC * ((R + 7) / 8) * 8 * hd * 4);
    sc = cur + 3 * R * rowb;
    scl = sc + up16(R * scw * 4);
    part = scl + up16(((psize == 1 ? 2 * K : 0) +
                       (csize == 1 ? 2 * R * n_gen : 0)) * 4);
    part8 = part + (tsize == 2 ? 0 : R * J * hd * 4);
    stats = part8 + R * J8 * hd * 4;
    total = stats + up16(R * 4);
  }
};

// A launch's arguments (pointers as the wrapper passes them).
struct Args {
  const void* q;
  const void* kn;
  const void* vn;
  long qs;  // row stride of q, k_new, v_new, in values
  const void* pk;
  const void* pv;
  const float* pks;  // K9's int8 prefix scales [L, N, 1, K], or null
  const float* pvs;
  const void* gk;
  const void* gv;
  const float* gks;  // K9's cache scales [B, L, 1, E], or null
  const float* gvs;
  void* wk;  // K15: k_new/v_new go into slot n_gen of these; null: no write
  void* wv;
  float* out;
  int N, R, L, K, E, D, layer, n_gen, tile, nbuf;
};

// The consumer warps' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// 16 bytes from device to shared memory (both 16-byte aligned), cached in
// the L2 only.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// 4 bytes from device to shared memory (K9's scales: a row of them need
// not start on 16 bytes).
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// This thread's arrival on `bar`, made once all its copies so far have
// landed.
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               ::"r"(smem_addr(bar)) : "memory");
}

// The values of one 16-byte word of shared memory as f32.
__device__ __forceinline__ void load_word(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
}
__device__ __forceinline__ void load_word(const __nv_bfloat16* p,
                                          float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // bf16 -> f32 is exact: the top 16 bits
    f[2 * j] = __uint_as_float(u[j] << 16);
    f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

// Word w of head slice `idx` of a region sits at word w ^ swz(idx) in bf16
// (none in f32): the eight consecutive slices an ldmatrix reads then meet
// eight different bank groups.
template <typename T, int HD>
__device__ __forceinline__ int swz(int idx) {
  constexpr int W = HD * (int)sizeof(T) / 16;  // 16-byte words a slice
  if constexpr (sizeof(T) != 2) {
    return 0;
  } else {
    constexpr int RPL = W >= 8 ? 1 : 8 / W;  // slices a 128-byte line
    return (idx / RPL) & ((W < 8 ? W : 8) - 1);
  }
}

// Word w of slice idx of a region starting at base.
template <typename T, int HD>
__device__ __forceinline__ const T* word_at(const T* base, int idx, int w) {
  return base + idx * HD + (w ^ swz<T, HD>(idx)) * (16 / (int)sizeof(T));
}

// A head slice in shared memory: its region and its index there.
template <typename T>
struct Slice {
  const T* base;
  int idx;
};

// The head slices of one stage (the prefix, or one chunk of generated
// slots; K or V) in shared memory: row r's slot s. Prefix slots are shared
// by the R rows (stride 0); slot `cur_s` of a chunk is the current token,
// slice cidx + r of the region `cb` (q, k_new, v_new). An int8 part has K
// scales ks [r * kst + s] (the current token's is 1).
template <typename T>
struct Part {
  const T* base;
  const T* cb;
  int cidx;    // R (k_new) in a K stage, 2 R (v_new) in a V stage
  int stride;  // slices per beam row: 0 (prefix) or tile
  int cur_s;   // the current token's slot in the part, or -1
  int cnt;     // slots in the part
  const float* ks;  // K scales, or null (all 1)
  int kst;          // scales per beam row: 0 (prefix) or n_gen
  __device__ Slice<T> row(int r, int s) const {
    return s == cur_s ? Slice<T>{cb, cidx + r}
                      : Slice<T>{base, r * stride + s};
  }
  __device__ float kscale(int r, int s) const {
    return ks && s != cur_s ? ks[r * kst + s] : 1.f;
  }
};

// bf16 tensor-core pieces: m16n8k16 products with f32 sums.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copies of slices i < cnt of one head (values of S, rows D values apart
// from src) into a stage from slice idx0 on, lane by lane: slices of T
// swizzled for ldmatrix, int8 slices as stored.
template <typename S, typename T, int HD>
__device__ __forceinline__ void copy_slices(unsigned char* buf, int idx0,
                                            const S* src, int D, int cnt,
                                            int lane) {
  constexpr int W = HD * (int)sizeof(S) / 16;  // 16-byte words a slice
  for (int i = lane; i < cnt * W; i += 32) {
    const int sl = i / W, w = i % W;
    void* dst;
    if constexpr (sizeof(S) == sizeof(T))
      dst = const_cast<T*>(
          word_at<T, HD>(reinterpret_cast<T*>(buf), idx0 + sl, w));
    else
      dst = buf + (size_t)(idx0 + sl) * HD * sizeof(S) + w * 16;
    copy16(dst, src + (size_t)sl * D + w * (16 / (int)sizeof(S)));
  }
}

// Four int8 levels (the bytes of u, lowest first) as exact f32 without a
// conversion instruction (those run at a quarter of the ALU rate): byte
// x + 128 becomes the low mantissa bits of 2^23, and 2^23 + 128 is
// subtracted.
__device__ __forceinline__ void levels4(uint32_t u, float (&f)[4]) {
  const uint32_t b = u ^ 0x80808080u;  // x + 128, unsigned
  f[0] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Two f32 integers of at most 8 significant bits as a bf16 pair (lo in
// the low half): their low 16 bits are zero, so the top halves are exact.
__device__ __forceinline__ uint32_t top_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The 16 levels at src (word w of an int8 slice), widened exactly into
// word w of slice idx of the T region `wide` (a level is exact in bf16).
template <typename T, int HD>
__device__ __forceinline__ void widen_word(const int8_t* src, T* wide,
                                           int idx, int w) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const uint32_t u[4] = {x.x, x.y, x.z, x.w};
  constexpr int V = 16 / sizeof(T);  // values a word of T
#pragma unroll
  for (int j = 0; j < 16 / V; ++j) {
    void* dst = const_cast<T*>(word_at<T, HD>(wide, idx, w * (16 / V) + j));
    if constexpr (sizeof(T) == 2) {
      float a[4], b[4];
      levels4(u[2 * j], a);
      levels4(u[2 * j + 1], b);
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(top_halves(a[0], a[1]), top_halves(a[2], a[3]),
                     top_halves(b[0], b[1]), top_halves(b[2], b[3]));
    } else {
      float a[4];
      levels4(u[j], a);
      *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

// 16 consecutive values of word w16 (16 values wide) of slice idx of a T
// region as f32.
template <typename T, int HD>
__device__ __forceinline__ void load16_slice(const T* base, int idx, int w16,
                                             float (&f)[16]) {
  constexpr int V = 16 / sizeof(T);  // values a 16-byte word
#pragma unroll
  for (int i = 0; i < 16 / V; ++i) {
    float x[V];
    load_word(word_at<T, HD>(base, idx, w16 * (16 / V) + i), x);
#pragma unroll
    for (int k = 0; k < V; ++k) f[i * V + k] = x[k];
  }
}

// The 16 int8 levels at p (16-byte aligned, in shared memory) as exact f32.
__device__ __forceinline__ void levels16(const int8_t* p, float (&f)[16]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float a[4];
    levels4(u[i], a);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[4 * i + k] = a[k];
  }
}

// A probability rounded to T, as the plain version rounds it before its
// product with V.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 128-thread blocks (three consumer warps and a producer) of head_dim <= 64
// fit six to an SM by registers.
// T: q, k_new, v_new (and the f32 sums' inputs); C: the generated cache;
// P: the prefix (C and P are T, or int8 levels with scales). kInReg (K6,
// C int8 and P T): the cache's stages are read in place and widened in
// registers, and its products run in f32 FMA.
template <typename T, typename C, typename P, int HD, bool kInReg>
__global__ void __launch_bounds__(128, HD <= 64 ? 6 : 3)
async_attn(const Args args, float scale) {
  constexpr bool kMma = sizeof(T) == 2;  // bf16: tensor cores
  constexpr int V = 16 / sizeof(T);      // values per 16-byte word
  constexpr int LP = HD / V;             // 16-byte words a head slice
  constexpr int LQ = HD / 16;            // 16-level words an int8 slice
  constexpr bool kNarrowP = sizeof(P) < sizeof(T);  // an int8 prefix
  constexpr bool kNarrowC = sizeof(C) < sizeof(T);  // an int8 cache
  static_assert(!kInReg || (kNarrowC && !kNarrowP),
                "in-place int8 reads: an int8 cache under a prefix of T");
  const T* q = static_cast<const T*>(args.q);
  const T* kn = static_cast<const T*>(args.kn);
  const T* vn = static_cast<const T*>(args.vn);
  const P* pk = static_cast<const P*>(args.pk);
  const P* pv = static_cast<const P*>(args.pv);
  const C* gk = static_cast<const C*>(args.gk);
  const C* gv = static_cast<const C*>(args.gv);
  float* out = args.out;
  const int N = args.N, R = args.R, L = args.L, K = args.K, E = args.E;
  const int D = args.D, layer = args.layer, n_gen = args.n_gen;
  const int tile = args.tile, nbuf = args.nbuf;
  const int RG = imin(R, kRowGroup);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(RG, K, HD, sizeof(T), sizeof(C), sizeof(P), tile, nbuf,
                   blockDim.x, n_gen, kInReg);
  const int h = blockIdx.x, n = blockIdx.y;
  // this block's rows: Rb rows of image n from its row rg0 on
  const int rg0 = blockIdx.z * kRowGroup, Rb = imin(kRowGroup, R - rg0);
  const size_t row0 = (size_t)n * R + rg0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NC = lay.NC, NCT = NC * 32, J = lay.J, scw = lay.scw;
  const int G = n_gen + 1;  // the generated slots and the current token
  const int nchunks = (G + tile - 1) / tile;
  const int nst = 2 * (1 + nchunks);  // K: prefix, chunks; V: the same
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + nbuf;
  unsigned char* ring = smem + lay.ring;
  T* wide = reinterpret_cast<T*>(smem + lay.wide);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  T* cur = reinterpret_cast<T*>(smem + lay.cur);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  // K9's scales: the prefix's K and V [K], then the cache's K and V
  // [RG][n_gen]
  float* scl = reinterpret_cast<float*>(smem + lay.scl);
  float* sgk = scl + (kNarrowP ? 2 * K : 0);
  float* sgv = sgk + RG * n_gen;
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* part8 = reinterpret_cast<float*>(smem + lay.part8);
  const int J8 = lay.J8;
  float* den = reinterpret_cast<float*>(smem + lay.stats);

  if (tid == 0) {
    for (int b = 0; b < nbuf; ++b) {
      bar_init(full + b, 32);  // the producer's lanes, once their copies land
      bar_init(empty + b, NC);  // the consumer warps, done with the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (!kMma)
    for (int i = tid; i < Rb * J * HD; i += blockDim.x) part[i] = 0.f;
  __syncthreads();

  // Stage s: 0 the prefix K (and q, k_new, v_new and the int8 scales),
  // 1 .. nchunks the K chunks of `tile` slots of the block's rows; then
  // the prefix V and the V chunks (K6: the V chunks, then the prefix V).
  // Stage s fills buffer s % nbuf.
  auto chunk_of = [&](int s) {
    if (s <= nchunks) return s - 1;
    if constexpr (kInReg) return s == nst - 1 ? -1 : s - nchunks - 1;
    return s - nchunks - 2;
  };
  // an int8 stage, widened before use
  auto narrow = [&](int s) { return chunk_of(s) < 0 ? kNarrowP : kNarrowC; };
  if (warp == NC) {
    // The producer: every stage's slices as 16-byte copies spread over the
    // lanes; each lane arrives on the stage's full barrier once its copies
    // have landed.
    const size_t hoff = (size_t)h * HD;
    for (int i = lane; i < 3 * Rb * LP; i += 32) {
      const int sl = i / LP, w = i % LP;
      const T* src = sl < Rb ? q : sl < 2 * Rb ? kn : vn;
      copy16(const_cast<T*>(word_at<T, HD>(cur, sl, w)),
             src + (row0 + sl % Rb) * args.qs + hoff + w * V);
    }
    // the scales of the slots below n_gen (they land with stage 0)
    if constexpr (kNarrowP) {
      const size_t base = ((size_t)layer * N + n) * K;
      for (int s = lane; s < K; s += 32) {
        copy4(scl + s, args.pks + base + s);
        copy4(scl + K + s, args.pvs + base + s);
      }
    }
    if constexpr (kNarrowC) {
      for (int i = lane; i < Rb * n_gen; i += 32) {
        const size_t src = ((row0 + i / n_gen) * L + layer) * E + i % n_gen;
        copy4(sgk + i, args.gks + src);
        copy4(sgv + i, args.gvs + src);
      }
    }
    for (int s = 0; s < nst; ++s) {
      const int b = s % nbuf, u = s / nbuf, c = chunk_of(s);
      const bool vside = s > nchunks;
      if (u > 0) bar_wait(empty + b, (u - 1) & 1);
      unsigned char* buf = ring + (size_t)b * lay.stage;
      if (c < 0) {
        copy_slices<P, T, HD>(
            buf, 0, (vside ? pv : pk) + ((size_t)layer * N + n) * K * D + hoff,
            D, K, lane);
      } else {
        const int g0 = c * tile;
        const int live = imin(g0 + tile, n_gen) - g0;  // cached slots
        for (int r = 0; r < Rb; ++r)
          copy_slices<C, T, HD>(
              buf, r * tile,
              (vside ? gv : gk) +
                  (((row0 + r) * L + layer) * E + g0) * D + hoff,
              D, live, lane);
      }
      arrive_on_copies(full + b);
    }
    if (args.wk) {
      // K15: head h's columns of the rows' k_new/v_new into slot n_gen,
      // which no copy reads
      for (int i = lane; i < 2 * Rb * LP; i += 32) {
        const int sl = i / LP, w = i % LP;
        const size_t r = row0 + sl % Rb, col = hoff + w * V;
        T* dst = static_cast<T*>(sl < Rb ? args.wk : args.wv) +
                 ((r * L + layer) * E + n_gen) * D + col;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
            (sl < Rb ? kn : vn) + r * args.qs + col);
      }
    }
    return;
  }

  // The consumers: stage s as a part over the slices at `base`, its first
  // score column col0.
  auto part_of = [&](int s, const T* base) {
    const int c = chunk_of(s), cidx = s > nchunks ? 2 * Rb : Rb;
    if (c < 0)
      return Part<T>{base, cur, cidx, 0, -1, K, kNarrowP ? scl : nullptr, 0};
    const int g0 = c * tile, cnt = imin(tile, G - g0);
    return Part<T>{base, cur, cidx, tile,
                   n_gen - g0 < cnt ? n_gen - g0 : -1, cnt,
                   kNarrowC ? sgk + g0 : nullptr, n_gen};
  };
  auto col_of = [&](int s) {
    const int c = chunk_of(s);
    return c < 0 ? 0 : K + c * tile;
  };
  // release stage s to the producer
  auto give = [&](int s) {
    __syncwarp();
    if (lane == 0) bar_arrive(empty + s % nbuf);
  };
  // wait for stage s. An int8 stage is widened into `wide` by all the
  // consumers and released at once; a stage of T is read where it landed
  // and released (give) once consumed.
  auto land = [&](int s) {
    bar_wait(full + s % nbuf, (s / nbuf) & 1);
    const unsigned char* buf = ring + (size_t)(s % nbuf) * lay.stage;
    if (!narrow(s)) return part_of(s, reinterpret_cast<const T*>(buf));
    const int c = chunk_of(s), g0 = imax(c, 0) * tile;
    const int live = c < 0 ? K : imin(g0 + tile, n_gen) - g0;
    const int rows = c < 0 ? 1 : Rb;
    constexpr int W = HD / 16;  // 16-byte words of an int8 slice
    consumers_sync(NCT);  // every warp is done with the last widened stage
    for (int i = tid; i < rows * live * W; i += NCT) {
      const int sl = i / W, r = sl / live;
      const int idx = r * tile + sl % live;
      widen_word<T, HD>(reinterpret_cast<const int8_t*>(buf) +
                            (size_t)idx * HD + i % W * 16,
                        wide, idx, i % W);
    }
    consumers_sync(NCT);
    give(s);
    return part_of(s, wide);
  };

  // bf16: units of 16 slots of one row (of all rows for the prefix) for
  // the rows 8 qt .. 8 qt + 7; the consumer warps take them in turn, the
  // turn carried from stage to stage in ub
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int nqt = (Rb + 7) / 8;           // query tiles (Rb <= 16)
  auto first_unit = [&](int units, int& ub) {
    const int first = ((warp - ub) % NC + NC) % NC;
    ub += units;
    return first;
  };
  // scores S^T = K Q^T of a part's units
  auto score_mma = [&](const Part<T>& p, int qt, int col0, int& ub) {
    const int r0 = 8 * qt, nr = imin(8, Rb - r0), nm = (p.cnt + 15) / 16;
    const int units = p.stride == 0 ? nm : nr * nm;
    const int first = first_unit(units, ub);
    if (first >= units) return;
    uint32_t qb[HD / 16][2];  // Q^T fragments; rows past Rb repeat Rb-1
    const int qrow = imin(r0 + g, Rb - 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = kk * 16 + 2 * t + 8 * i;
        qb[kk][i] = *reinterpret_cast<const uint32_t*>(
            word_at<T, HD>(cur, qrow, e / 8) + e % 8);
      }
    for (int u = first; u < units; u += NC) {
      const int r = p.stride == 0 ? -1 : r0 + u / nm, m0 = (u % nm) * 16;
      const Slice<T> sl = p.row(
          r < 0 ? 0 : r, imin(m0 + (lane & 7) + (lane & 8), p.cnt - 1));
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, word_at<T, HD>(sl.base, sl.idx, 2 * kk + (lane >> 4)));
        mma_bf16(c, a, qb[kk][0], qb[kk][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (slot m0 + g (+8), row r0 + 2t (+1))
        const int s = m0 + g + (e >> 1) * 8, row = r0 + 2 * t + (e & 1);
        if (s < p.cnt && row < Rb && (r < 0 || row == r))
          sc[row * scw + col0 + s] = c[e] * p.kscale(row, s) * scale;
      }
    }
  };
  // values O^T += V^T P^T of a part's units (dims by rows)
  auto values_mma = [&](const Part<T>& p, int qt, int col0,
                        float (&o)[HD / 16][4], int& ub) {
    const int r0 = 8 * qt, nr = imin(8, Rb - r0), nk = (p.cnt + 15) / 16;
    const int units = p.stride == 0 ? nk : nr * nk;
    for (int u = first_unit(units, ub); u < units; u += NC) {
      const int r = p.stride == 0 ? -1 : r0 + u / nk, k0 = (u % nk) * 16;
      const int row = r0 + g;  // this lane's column of P^T
      const bool use = row < Rb && (r < 0 || row == r);
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // slots k0 + 2t, +1, +8, +9
        const int s = k0 + 2 * t + (i & 1) + (i >> 1) * 8;
        pr[i] = use && s < p.cnt ? sc[row * scw + col0 + s] : 0.f;
      }
      const uint32_t b0 = pack_bf16(pr[0], pr[1]);
      const uint32_t b1 = pack_bf16(pr[2], pr[3]);
      const Slice<T> sl = p.row(
          r < 0 ? 0 : r, imin(k0 + (lane & 7) + (lane >> 4) * 8, p.cnt - 1));
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt) {
        uint32_t a[4];
        ldsm_x4_t(a, word_at<T, HD>(sl.base, sl.idx,
                                    2 * mt + ((lane >> 3) & 1)));
        mma_bf16(o[mt], a, b0, b1);
      }
    }
  };

  // f32 scores of a part: a unit of LP lanes takes LP slots of one row;
  // lane sub sums its word of each slot, and a reduce-scatter leaves it
  // slot sub's score. The trip count is every consumer's, so every lane
  // reaches the shuffles.
  const int sub = tid % LP, grp = tid / LP, ngrp = NCT / LP;
  auto score_fma = [&](const Part<T>& p, int col0) {
    const int nu = (p.cnt + LP - 1) / LP;  // units a row
    for (int u0 = 0; u0 < Rb * nu; u0 += ngrp) {
      const int u = u0 + grp;
      const bool live = u < Rb * nu;
      const int r = live ? u / nu : 0, s0 = live ? (u % nu) * LP : 0;
      float qv[V];
      load_word(word_at<T, HD>(cur, r, sub), qv);
      float acc[LP];
#pragma unroll
      for (int j = 0; j < LP; ++j) {
        acc[j] = 0.f;
        if (live && s0 + j < p.cnt) {
          const Slice<T> sl = p.row(r, s0 + j);
          float kv[V];
          load_word(word_at<T, HD>(sl.base, sl.idx, sub), kv);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[j] = fmaf(qv[k], kv[k], acc[j]);
        }
      }
#pragma unroll
      for (int lv = 1; lv < LP; lv *= 2) {
        const int w = LP / (2 * lv);
        const bool hi = sub & w;  // keep the upper half of the 2w slots
#pragma unroll
        for (int j = 0; j < w; ++j) {
          const float send = hi ? acc[j] : acc[j + w];
          acc[j] = (hi ? acc[j + w] : acc[j]) +
                   __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      if (live && s0 + sub < p.cnt)
        sc[r * scw + col0 + s0 + sub] = acc[0] * p.kscale(r, s0 + sub) * scale;
    }
  };
  // f32 values of a part into the sums of thread (row r, j, word col):
  // slots j, j + J, ..., two loads in flight.
  auto values_fma = [&](const Part<T>& p, int col0) {
    for (int ow = tid; ow < Rb * J * LP; ow += NCT) {
      const int col = ow % LP, rj = ow / LP, j = rj % J, r = rj / J;
      float* acc = part + (size_t)rj * HD + col * V;
      const float* w = sc + r * scw + col0;
      float a[V];
#pragma unroll
      for (int k = 0; k < V; ++k) a[k] = acc[k];
      int s = j;
      for (; s + J < p.cnt; s += 2 * J) {
        const Slice<T> s0 = p.row(r, s), s1 = p.row(r, s + J);
        float v0[V], v1[V];
        load_word(word_at<T, HD>(s0.base, s0.idx, col), v0);
        load_word(word_at<T, HD>(s1.base, s1.idx, col), v1);
#pragma unroll
        for (int k = 0; k < V; ++k)
          a[k] = fmaf(w[s + J], v1[k], fmaf(w[s], v0[k], a[k]));
      }
      if (s < p.cnt) {
        const Slice<T> s0 = p.row(r, s);
        float v0[V];
        load_word(word_at<T, HD>(s0.base, s0.idx, col), v0);
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = fmaf(w[s], v0[k], a[k]);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = a[k];
    }
  };

  // K6: the int8 chunk c of the block's rows, read where it landed: its
  // slots g0 = c * tile on, gcnt of them below n_gen (the current token
  // is apart: its score is taken with the softmax, its value with the
  // output).
  auto gen_slots = [&](int c) { return imin(tile, n_gen - c * tile); };
  // K6 scores: a unit of LQ lanes takes LQ slots k, k + nu, ... of one row
  // (nu units a row); lane sub8 sums its word of each, and a reduce-scatter
  // leaves it slot k + nu * sub8's score. The trip count is every
  // consumer's, so every lane reaches the shuffles.
  const int sub8 = tid % LQ, grp8 = tid / LQ, ngrp8 = NCT / LQ;
  auto score_q8 = [&](const int8_t* buf, int c) {
    const int g0 = c * tile, gcnt = gen_slots(c);
    const int nu = (gcnt + LQ - 1) / LQ;
    for (int u0 = 0; u0 < Rb * nu; u0 += ngrp8) {
      const int u = u0 + grp8;
      const bool live = u < Rb * nu;
      const int r = live ? u / nu : 0, k = live ? u % nu : 0;
      float qv[16];
      load16_slice<T, HD>(cur, r, sub8, qv);
      const int8_t* base = buf + (size_t)r * tile * HD + sub8 * 16;
      float acc[LQ];
#pragma unroll
      for (int j = 0; j < LQ; ++j) {
        acc[j] = 0.f;
        const int s = k + nu * j;
        if (live && s < gcnt) {
          float kv[16];
          levels16(base + (size_t)s * HD, kv);
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[j] = fmaf(qv[i], kv[i], acc[j]);
        }
      }
#pragma unroll
      for (int lv = 1; lv < LQ; lv *= 2) {
        const int w = LQ / (2 * lv);
        const bool hi = sub8 & w;  // keep the upper half of the 2w slots
#pragma unroll
        for (int j = 0; j < w; ++j) {
          const float send = hi ? acc[j] : acc[j + w];
          acc[j] = (hi ? acc[j + w] : acc[j]) +
                   __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      const int s = k + nu * sub8;
      if (live && s < gcnt)
        sc[r * scw + K + g0 + s] = acc[0] * sgk[r * n_gen + g0 + s] * scale;
    }
  };
  // K6 values: item ow = tid + o8 * NCT of a consumer thread (row r, j,
  // word col) sums the weights (V scale folded, rounded to T) times the 16
  // dims of slots j, j + J8, ...; its sums stay in registers over the
  // chunks (kOW items a thread: two only for hd 128 with more than 12
  // rows) and meet in part8 after the last.
  constexpr int kOW = HD == 128 ? 2 : 1;
  auto values_q8 = [&](const int8_t* buf, int c, float (&acc)[kOW][16]) {
    const int g0 = c * tile, gcnt = gen_slots(c);
#pragma unroll
    for (int o8 = 0; o8 < kOW; ++o8) {
      const int ow = tid + o8 * NCT;
      if (ow < Rb * J8 * LQ) {
        const int col = ow % LQ, rj = ow / LQ, j = rj % J8, r = rj / J8;
        const float* w = sc + r * scw + K + g0;
        const int8_t* base = buf + (size_t)r * tile * HD + col * 16;
#pragma unroll 2
        for (int s = j; s < gcnt; s += J8) {
          float v[16];
          levels16(base + (size_t)s * HD, v);
          const float e = round_to(w[s], q);
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[o8][i] = fmaf(e, v[i], acc[o8][i]);
        }
      }
    }
  };
  // value d of slice idx of `cur` (q, k_new, v_new) as f32
  auto cur_at = [&](int idx, int d) {
    return to_f32(*(word_at<T, HD>(cur, idx, d / V) + d % V));
  };
  // wait for K6's int8 stage s; released by give(s) once consumed
  auto land8 = [&](int s) {
    bar_wait(full + s % nbuf, (s / nbuf) & 1);
    return reinterpret_cast<const int8_t*>(ring + (size_t)(s % nbuf) *
                                                      lay.stage);
  };

  // Scores of every K stage as it lands.
  int ub = 0;
  for (int s = 0; s <= nchunks; ++s) {
    if constexpr (kInReg)
      if (chunk_of(s) >= 0) {
        score_q8(land8(s), chunk_of(s));
        give(s);
        continue;
      }
    const Part<T> p = land(s);
    if constexpr (kMma) {
#pragma unroll
      for (int qt = 0; qt < 2; ++qt)
        if (qt < nqt) score_mma(p, qt, col_of(s), ub);
    } else {
      score_fma(p, col_of(s));
    }
    if (!narrow(s)) give(s);
  }
  consumers_sync(NCT);
  // One softmax over all K + G scores of a row, a warp per row (the
  // producer meanwhile fills the freed buffers with V stages). K9's V
  // scales fold into the weights, not into the sum l.
  const int width = K + G;
  for (int r = warp; r < Rb; r += NC) {
    float* row = sc + r * scw;
    if constexpr (kInReg) {  // K6: the current token's score
      float p = 0.f;
      for (int d = lane; d < HD; d += 32)
        p = fmaf(cur_at(r, d), cur_at(Rb + r, d), p);
      p = warp_sum(p);
      if (lane == 0) row[K + n_gen] = p * scale;
      __syncwarp();
    }
    float m = -INFINITY;
    for (int s = lane; s < width; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float l = 0.f;
    for (int s = lane; s < width; s += 32) {
      const float e = expf(row[s] - m);
      float w = e;
      if constexpr (kNarrowP)
        if (s < K) w *= scl[K + s];
      if constexpr (kNarrowC)
        if (s >= K && s - K < n_gen) w *= sgv[r * n_gen + s - K];
      row[s] = w;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) den[r] = l;
  }
  consumers_sync(NCT);
  // Values of every V stage as it lands: K6's int8 chunks first, so that
  // the tensor-core sums o are live only for its last stage, the prefix.
  int v0 = nchunks + 1;
  if constexpr (kInReg) {
    float acc8[kOW][16] = {};
    for (; chunk_of(v0) >= 0; ++v0) {
      values_q8(land8(v0), chunk_of(v0), acc8);
      give(v0);
    }
#pragma unroll
    for (int o8 = 0; o8 < kOW; ++o8) {
      const int ow = tid + o8 * NCT;
      if (ow < Rb * J8 * LQ)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          part8[(size_t)(ow / LQ) * HD + ow % LQ * 16 + i] = acc8[o8][i];
    }
  }
  float o[2][HD / 16][4] = {};  // bf16: O^T of the (at most two) query tiles
  ub = 0;
  for (int s = v0; s < nst; ++s) {
    const Part<T> p = land(s);
    if constexpr (kMma) {
#pragma unroll
      for (int qt = 0; qt < 2; ++qt)
        if (qt < nqt) values_mma(p, qt, col_of(s), o[qt], ub);
    } else {
      values_fma(p, col_of(s));
    }
    if (!narrow(s)) give(s);
  }
  consumers_sync(NCT);

  if constexpr (kMma) {
    // the consumer warps' O^T [NC][tile][8 rows][HD], over the spent ring,
    // summed in a fixed order
#pragma unroll
    for (int qt = 0; qt < 2; ++qt)
      if (qt < nqt) {
        float* mine = red + ((warp * nqt + qt) * 8 + 2 * t) * HD + g;
#pragma unroll
        for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)  // (dim 16 mt + g (+8), row 2t (+1))
            mine[(e & 1) * HD + 16 * mt + (e >> 1) * 8] = o[qt][mt][e];
      }
    consumers_sync(NCT);
  }
  for (int i = tid; i < Rb * HD; i += NCT) {
    const int r = i / HD, d = i % HD;
    float s = 0.f;
    if constexpr (kMma) {
      for (int w = 0; w < NC; ++w)
        s += red[((w * nqt + r / 8) * 8 + r % 8) * HD + d];
    } else {
      for (int j = 0; j < J; ++j) s += part[(r * J + j) * HD + d];
    }
    if constexpr (kInReg) {  // K6: the int8 slots', then the current token's
      for (int j = 0; j < J8; ++j) s += part8[(r * J8 + j) * HD + d];
      s += round_to(sc[r * scw + K + n_gen], q) * cur_at(2 * Rb + r, d);
    }
    out[(row0 + r) * D + (size_t)h * HD + d] = s / den[r];
  }
}


template <typename T, typename C, typename P, int HD, bool kInReg>
cudaError_t launch(const Args& a, int threads, int smem, cudaStream_t stream) {
  const Layout lay(imin(a.R, kRowGroup), a.K, HD, sizeof(T), sizeof(C),
                   sizeof(P), a.tile, a.nbuf, threads, a.n_gen, kInReg);
  if (lay.total != smem || threads % 32 || threads < 64 || threads > 128 ||
      a.tile < 1 || a.nbuf < 2 || a.R < 1 ||
      (a.R + kRowGroup - 1) / kRowGroup > 65535 || a.N > 65535)
    return cudaErrorInvalidValue;
  // K6: each consumer thread holds at most two (hd 128) or one value items
  if (kInReg && imin(a.R, kRowGroup) * lay.J8 * (HD / 16) >
                    (HD == 128 ? 2 : 1) * (threads - 32))
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        async_attn<T, C, P, HD, kInReg>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(a.D / HD, a.N, (a.R + kRowGroup - 1) / kRowGroup);
  async_attn<T, C, P, HD, kInReg><<<grid, threads, smem, stream>>>(
      a, 1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T, typename C, typename P, bool kInReg = false>
cudaError_t launch_hd(const Args& a, int hd, int threads, int smem,
                      cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, C, P, 32, kInReg>(a, threads, smem, stream);
    case 64:
      return launch<T, C, P, 64, kInReg>(a, threads, smem, stream);
    case 128:
      return launch<T, C, P, 128, kInReg>(a, threads, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The slot policies a caller reaches.
enum Kind { kPlainCache, kInt8Widened, kInt8InReg };

// The instances: (T, T, T) for K2, K8 and K15; (T, int8, T) and (T, int8,
// int8) for K9 (an int8 prefix comes with its scales); (T, int8, T) read in
// registers for K6.
template <typename T>
cudaError_t launch_kind(const Args& a, Kind kind, int hd, int threads,
                        int smem, cudaStream_t stream) {
  switch (kind) {
    case kPlainCache:
      return launch_hd<T, T, T>(a, hd, threads, smem, stream);
    case kInt8Widened:
      return a.pks ? launch_hd<T, int8_t, int8_t>(a, hd, threads, smem,
                                                  stream)
                   : launch_hd<T, int8_t, T>(a, hd, threads, smem, stream);
    default:
      return launch_hd<T, int8_t, T, true>(a, hd, threads, smem, stream);
  }
}

int run(const Args& a, Kind kind, int hd, int threads, int smem, int dtype,
        cudaStream_t stream) {
  return static_cast<int>(
      dtype == kBF16
          ? launch_kind<__nv_bfloat16>(a, kind, hd, threads, smem, stream)
          : launch_kind<float>(a, kind, hd, threads, smem, stream));
}

}  // namespace
}  // namespace capdec

// K2: n_gen = min(step, e_cap).
extern "C" int capdec_beam_decode_attention_rowmajor(
    const void* q, const void* kn, const void* vn, long qs, const void* pk,
    const void* pv, const void* gk, const void* gv, float* out, int N, int R,
    int L, int K, int E, int D, int hd, int layer, int n_gen, int tile,
    int nbuf, int threads, int smem, int dtype, cudaStream_t stream) {
  const capdec::Args a{q,  kn,      vn,      qs,      pk,      pv,
                       nullptr, nullptr, gk, gv,     nullptr, nullptr,
                       nullptr, nullptr, out, N,    R,       L,
                       K,  E,       D,       layer,   n_gen,   tile,
                       nbuf};
  return capdec::run(a, capdec::kPlainCache, hd, threads, smem, dtype,
                     stream);
}

// K8: n_gen = step (the TPU's `chunk` tiles are the wrapper's to check).
extern "C" int capdec_beam_decode_attention_chunked(
    const void* q, const void* kn, const void* vn, long qs, const void* pk,
    const void* pv, const void* gk, const void* gv, float* out, int N, int R,
    int L, int K, int E, int D, int hd, int layer, int n_gen, int tile,
    int nbuf, int threads, int smem, int dtype, cudaStream_t stream) {
  return capdec_beam_decode_attention_rowmajor(
      q, kn, vn, qs, pk, pv, gk, gv, out, N, R, L, K, E, D, hd, layer, n_gen,
      tile, nbuf, threads, smem, dtype, stream);
}

// K6: n_gen = min(step, e_cap) over int8 levels gk/gv with scales gks/gvs,
// under a prefix of q's type.
extern "C" int capdec_beam_decode_attention_rowmajor_q(
    const void* q, const void* kn, const void* vn, long qs, const void* pk,
    const void* pv, const void* gk, const void* gv, const float* gks,
    const float* gvs, float* out, int N, int R, int L, int K, int E, int D,
    int hd, int layer, int n_gen, int tile, int nbuf, int threads, int smem,
    int dtype, cudaStream_t stream) {
  if (!gks || !gvs) return static_cast<int>(cudaErrorInvalidValue);
  const capdec::Args a{q,   kn,      vn,    qs,    pk,    pv,      nullptr,
                       nullptr, gk,  gv,    gks,   gvs,   nullptr, nullptr,
                       out, N,       R,     L,     K,     E,       D,
                       layer, n_gen, tile,  nbuf};
  return capdec::run(a, capdec::kInt8InReg, hd, threads, smem, dtype,
                     stream);
}

// K9: n_gen = step over int8 levels gk/gv with scales gks/gvs; with
// pks/pvs (non-null) the prefix pk/pv is int8 levels too.
extern "C" int capdec_beam_decode_attention_chunked_q(
    const void* q, const void* kn, const void* vn, long qs, const void* pk,
    const void* pv, const float* pks, const float* pvs, const void* gk,
    const void* gv, const float* gks, const float* gvs, float* out, int N,
    int R, int L, int K, int E, int D, int hd, int layer, int n_gen,
    int tile, int nbuf, int threads, int smem, int dtype,
    cudaStream_t stream) {
  if ((pks == nullptr) != (pvs == nullptr) || !gks || !gvs)
    return static_cast<int>(cudaErrorInvalidValue);
  const capdec::Args a{q,  kn,  vn,  qs,      pk,      pv,    pks,
                       pvs, gk, gv,  gks,     gvs,     nullptr, nullptr,
                       out, N,  R,   L,       K,       E,     D,
                       layer, n_gen, tile,    nbuf};
  return capdec::run(a, capdec::kInt8Widened, hd, threads, smem, dtype,
                     stream);
}

// K15: one layer's caches gk/gv [B, E, D] (the wrapper passes L = 1,
// layer 0 and n_gen = step); slot `step` of them receives k_new/v_new.
extern "C" int capdec_beam_decode_attention(
    const void* q, const void* kn, const void* vn, long qs, const void* pk,
    const void* pv, void* gk, void* gv, float* out, int N, int R, int L,
    int K, int E, int D, int hd, int layer, int n_gen, int tile, int nbuf,
    int threads, int smem, int dtype, cudaStream_t stream) {
  const capdec::Args a{q,  kn,      vn,      qs,   pk,      pv,
                       nullptr, nullptr, gk, gv,  nullptr, nullptr,
                       gk, gv,      out,     N,    R,       L,
                       K,  E,       D,       layer, n_gen,  tile,
                       nbuf};
  return capdec::run(a, capdec::kPlainCache, hd, threads, smem, dtype,
                     stream);
}
