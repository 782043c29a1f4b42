// K1: fused tied LM head + logsumexp + exact top-R over the vocabulary.
//
// Replaces capdec_tpu/ops/lm_head.py::lm_head_topk (the function at :259,
// pl.pallas_call at :306 and :334). For hidden h [B, D] and the tied
// embedding w [V, D] it returns the top-R values of h @ w^T (f32), their
// indices (lowest index wins a tie, as lax.top_k on the f32 logits) and
// the row logsumexp. The [B, V] logits never reach device memory.
//
// Bound on the H100: at the beam shape (B = 320, V = 50257, D = 768,
// bf16) the product is 24.7 GFLOP against 77 MB of weights, about 320
// operations per byte, so the tensor cores bound it (25 us at 989
// TFLOP/s), just above the 23 us the weight bytes need; at greedy's B = 64
// the weight bytes alone bound it (23 us at 3.35 TB/s). At the Kimi-VL-A3B
// head (B = 2560, V = 163840, D = 2048) the product is 1.72 TFLOP against
// 0.68 GB: the tensor cores bound it, 1.737 ms. The f32 route (the
// token-identity checks only) has no tensor-core path without TF32 and is
// bound by the 67 TFLOP/s of the FMA units.
//
// bf16 up to D = 832, weight-stationary (lm_head_wgmma<128>): persistent
// blocks, at most one an SM (blocks = min(vocab tiles, SMs); block b takes
// vocab tiles b, b + blocks, ...). A block holds one vocab tile of the
// weights, [tile_n = 128, D], whole in shared memory as D / 64 slices of
// [128, 64] (128-byte rows, swizzled by TMA for wgmma; 192 KB at D = 768),
// and walks every 64-row tile of h over it:
//   * a producer warpgroup, of which one thread works, issues TMA copies
//     on mbarriers: each weight slice of the next vocab tile as soon as
//     the last row tile of the current one has released it (the next
//     tile's weights stream in under the current tile's last products),
//     and h's [64, 64] slices of each (row tile, slice) through a ring of
//     `stages` buffers. TMA's zero fill covers the ragged edges of B, V
//     and D. It hands its registers to the consumers (setmaxnreg: 40 and
//     232 a thread), whose epilogue needs them;
//   * two consumer warpgroups take the row tiles in turn (the block's g-th
//     row tile goes to warpgroup g % 2), so that one warpgroup's epilogue
//     runs under the other's products. A warpgroup runs wgmma m64 n128 k16
//     on bf16 with f32 sums in registers: a slice's four go out as one
//     group, and the previous slice's group is waited for and released.
//     Tile g's products start only once tile g - 1's are issued (an
//     mbarrier a warpgroup), so the ring is consumed in the order it is
//     filled and no wait on a stage's phase parity can see a phase two
//     rounds old. Ring positions are 32-bit counters stepped once a
//     slice: 64-bit division by the stage count was the slice loop's
//     largest cost on the H100;
//   * the epilogue stays in registers (tile_partials): a thread holds 32
//     values of each of two rows, a quad of lanes a whole row, and the
//     quad writes one partial (max, sum-exp, top-R) per (row, vocab tile).
// Each weight byte leaves device memory once; h (491 KB at B = 320) is
// read from the L2 once per vocab tile: 393 x 491 KB = 193 MB of L2 reads
// at the beam shape, 38.6 MB at greedy's.
//
// Not chosen for it, as measured on the H100 (PERF.md §6): R rounds that
// each filter and reduce all 32 values of a row (about twice the pairs'
// time at R = 5); tile_n 96 or 112 for a deeper ring (slower: more vocab
// tiles, more h bytes); each block starting at another row tile; a
// suspend-time hint on the mbarrier waits; two or three wgmma groups in
// flight (no gain, or slower).
//
// bf16 beyond D = 832, streamed (lm_head_wgmma_streamed), where a
// 128-entry weight tile no longer fits a block. Narrower weight tiles
// read h from the L2 once per tile: at 48 entries (the only width that
// fit D = 2048) 3414 x 10.5 MB = 36 GB at the Kimi head, 8.65 ms against
// cuBLAS's product alone at 2.08 ms. The streamed kernel is the product's
// own design: persistent blocks walk output tiles of 128 rows x 256 vocab
// entries, the row tiles innermost (tile = vocab tile x row tiles + row
// tile; block b takes tiles b, b + blocks, ...), so that the blocks in
// flight share a few vocab tiles and each weight byte leaves device
// memory about once. Both operands stream over D through a ring of four
// 48 KB stages ([128, 64] of h and [256, 64] of the weights) filled by one
// producer thread on full/empty mbarriers; it runs on into the next tile
// while the consumers run the epilogue. Two consumer warpgroups, 64 rows
// each, run wgmma m64 n256 k16 on the same stage (128 f32 sums a thread)
// and release it together; the epilogue (streamed_partials) writes one
// partial per (row, 256-entry vocab tile), in the format lm_head_merge
// reads. L2 reads at the Kimi head: h 640 times (6.7 GB) and the weights
// 20 times (13.4 GB), 20.1 GB against the 48-entry tile's 36 GB; the
// partials 79 MB against 0.42 GB.
//
// Measured on the H100 (PERF.md §6; NVIDIA H100 80GB HBM3 at 700 W):
// 2.48-2.50 ms a call at the Kimi head, R = 5 (the kernel 2.40, the merge
// 0.08), 72 % of the operations bound. The tensor cores bound the
// products: at R = 1, whose epilogue is short, the call takes 2.02-2.13
// ms (82-86 % of the bound). The rest at R = 5 is the epilogue's rounds,
// which no product runs under: a warpgroup's 128 sums hold the tile until
// its partials are written. At D = 1024 and 1280 (B 2560, V 50257) 0.50
// and 0.58 ms against the 64-entry weight tile's 1.02 and 1.20. Not
// chosen, as measured there:
// clusters of two CTAs on neighbouring row tiles, each keeping its own
// ring and loading half of each weight slice into both by a multicast
// copy (20.1 GB of L2 reads become 13.4): 2.50-2.53 ms, no gain, so the
// L2 (8.4 TB/s here) does not bound it; with the empty mbarriers' remote
// arrivals at cluster-scope release, 5.86 ms. Clusters of four on the
// 48-entry tile sharing h by multicast, a shared four-stage ring:
// 11.05 ms. Not tried: warpgroups in ping-pong on their own tiles (a
// warpgroup's own 128 x 256 tile needs 256 sums a thread; on 64 x 256
// tiles each reads its own weight slices, 33.5 GB of L2 reads).
//
// f32 design (lm_head_fma, the first port's kernel): one block per (64-row
// tile, 128-entry vocab chunk) forms the score tile in shared memory by
// FMA and one warp per row reduces it to the same partials.
//
// pass 2 (lm_head_merge): one block per row merges the row's partials:
// logsumexp m + log(l), and the top-R in selection order.
//
// The wrapper's plan (ops/lm_head.py lm_head_plan) gives the tiles, the
// ring's stages, the threads, the grid and the shared-memory bytes; the
// entry refuses a plan that disagrees with the kernel's layout.
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <float.h>
#include <limits.h>

#include "common.cuh"

namespace capdec {
namespace {

// ---- bf16: TMA + wgmma ---------------------------------------------------

constexpr int TM = 64;          // rows of a tile: one warpgroup's wgmma M
constexpr int KT = 64;          // depth of a slice: one 128-byte row of bf16
constexpr int CONSUMERS = 2;    // consumer warpgroups
constexpr int WG_THREADS = 128 * (CONSUMERS + 1);  // and a producer one
// registers a thread after the producer warpgroup hands its own to the
// consumers (setmaxnreg): 128 x 40 + 256 x 232 <= 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int SMEM_LIMIT = 232448;  // an H100 block's dynamic shared memory

// Bytes of dynamic shared memory: 1 KB to align the tiles to the 128-byte
// swizzle's 1 KB period, the weight tile (ks slices of [bn][KT]), the
// ring of h slices ([TM][KT] each) and the mbarriers (full and empty, one
// pair a weight slice and a ring stage; one a consumer warpgroup, whose
// phase completes when its tile's products are issued). ops/lm_head.py
// computes the same.
__host__ __device__ inline int wgmma_smem(int ks, int bn, int stages) {
  return 1024 + ks * bn * KT * 2 + stages * TM * KT * 2 +
         (2 * ks + 2 * stages + CONSUMERS) * 8;
}

// wgmma's shared-memory descriptor of a K-major tile of 128-byte rows in
// the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), the leading
// offset unused; a step of 16 values along k adds 32 bytes to the start.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// d[BN / 2] += A (64 x 16, desc da) * B (BN x 16, desc db)^T, issued by
// the warpgroup; scale_d = 0 would overwrite d.
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (BN == 128) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    static_assert(BN == 256, "N is 128 or 256");
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// The box of `map` at (c0 along D, c1 along rows) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// Leaves 0..2W-1 of (bv, bi) to leaf 0, the first in selection order, in
// levels of W, W / 2, ..., 1 independent comparisons.
template <int W, int N>
__device__ __forceinline__ void tree_best(float (&bv)[N], int (&bi)[N]) {
#pragma unroll
  for (int n = 0; n < W; ++n) {
    const bool take = ranks_before(bv[n + W], bi[n + W], bv[n], bi[n]);
    bv[n] = take ? bv[n + W] : bv[n];
    bi[n] = take ? bi[n + W] : bi[n];
  }
  if constexpr (W > 1) tree_best<W / 2>(bv, bi);
}

// The max of leaves 0..2W-1, in levels of W, ..., 1 independent maxima
// (the leaves are overwritten).
template <int W, int N>
__device__ __forceinline__ float tree_max(float (&x)[N]) {
#pragma unroll
  for (int n = 0; n < W; ++n) x[n] = fmaxf(x[n], x[n + W]);
  if constexpr (W > 1) return tree_max<W / 2>(x);
  return x[0];
}

// The min of leaves 0..2W-1, likewise (overwritten).
template <int W, int N>
__device__ __forceinline__ int tree_min(int (&x)[N]) {
#pragma unroll
  for (int n = 0; n < W; ++n) x[n] = min(x[n], x[n + W]);
  if constexpr (W > 1) return tree_min<W / 2>(x);
  return x[0];
}

// One (64-row tile, vocab tile)'s partials from a warpgroup's
// accumulators: warp wi holds rows row0 + 16 wi + lane / 4 (+ 8), lane
// columns 8i + 2(lane % 4) + {0, 1} of the tile at v0, so a thread holds
// BN / 4 values of each of its two rows and a quad of lanes a whole row.
// R = 1 (greedy): a max tree, the lowest column holding the max (a min
// tree), the sum-exp, then the same over the quad. R > 1: a thread's
// values of a row go into BN / 8 pairs, each ordered once (head first);
// a round takes the first head in selection order by a tree of depth
// log2(BN / 8), then the first over the quad, and the pair that held the
// pick moves its second value up. Both rows' rounds run together (their
// trees interleave); the first round's pick is the row's max, which the
// sum-exp uses. Columns >= V are -inf and never picked.
template <int BN>
__device__ __forceinline__ void tile_partials(
    const float (&acc)[BN / 2], int row0, int v0, int vt, int B, int V,
    int R, int P, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int NP = BN / 8;  // a thread's pairs of one row
  constexpr int NX = 2 * NP;  // its values of one row
  constexpr float kLog2e = 1.4426950408889634f;
  const int lane = threadIdx.x % 32, q = lane % 4;
  if (R == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + lane / 4 + 8 * half;
      float x[NX];
      int at[NX];
#pragma unroll
      for (int n = 0; n < NX; ++n) {
        const int g = v0 + 8 * (n / 2) + 2 * q + n % 2;
        x[n] = g < V ? acc[4 * (n / 2) + 2 * half + n % 2] : -INFINITY;
      }
      float t[NX];  // the tree overwrites its leaves
#pragma unroll
      for (int n = 0; n < NX; ++n) t[n] = x[n];
      float mx = tree_max<NX / 2>(t);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float l = 0.f;
#pragma unroll
      for (int n = 0; n < NX; ++n) {
        const int g = v0 + 8 * (n / 2) + 2 * q + n % 2;
        at[n] = x[n] == mx ? g : INT_MAX;
        l += exp2f((x[n] - mx) * kLog2e);  // exp2(-inf) = 0
      }
      int first = tree_min<NX / 2>(at);
      first = min(first, __shfl_xor_sync(0xffffffffu, first, 1));
      first = min(first, __shfl_xor_sync(0xffffffffu, first, 2));
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const size_t slot = (size_t)row * P + vt;
      if (row < B && q == 0) {
        part_m[slot] = mx;
        part_l[slot] = l;
        part_v[slot] = mx;
        part_i[slot] = first;
      }
    }
    return;
  }
  // the pairs of both rows, kept together so that a round's two trees
  // and quad reductions interleave
  float hv[2][NP], lv[2][NP];
  int hi[2][NP], li[2][NP];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int p = 0; p < NP; ++p) {  // columns g = v0 + 8p + 2q and g + 1
      const int g = v0 + 8 * p + 2 * q;
      const bool ok0 = g < V, ok1 = g + 1 < V;
      const float a = ok0 ? acc[4 * p + 2 * half] : -INFINITY;
      const float b = ok1 ? acc[4 * p + 2 * half + 1] : -INFINITY;
      const bool up = b > a;  // g + 1 ranks first only if strictly larger
      hv[half][p] = up ? b : a;
      hi[half][p] = up ? g + 1 : (ok0 ? g : INT_MAX);
      lv[half][p] = up ? a : b;
      li[half][p] = up ? g : (ok1 ? g + 1 : INT_MAX);
    }
  for (int k = 0; k < R; ++k) {
    float best[2];
    int at[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tv[NP];  // the tree overwrites its leaves
      int ti[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tv[p] = hv[half][p];
        ti[p] = hi[half][p];
      }
      tree_best<NP / 2>(tv, ti);
      best[half] = tv[0];
      at[half] = ti[0];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) warp_best<4>(best[half], at[half]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + lane / 4 + 8 * half;
      const bool writes = row < B && q == 0;
      const size_t slot = (size_t)row * P + vt;
      if (k == 0) {  // the row's max over the tile; masked values are -inf
        float l = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          l += exp2f((hv[half][p] - best[half]) * kLog2e) +
               exp2f((lv[half][p] - best[half]) * kLog2e);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        if (writes) {
          part_m[slot] = best[half];
          part_l[slot] = l;
        }
      }
      if (writes) {
        part_v[slot * R + k] = best[half];
        part_i[slot * R + k] = at[half];
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {  // the pick leaves its pair
        const bool pop = hi[half][p] == at[half];
        hv[half][p] = pop ? lv[half][p] : hv[half][p];
        hi[half][p] = pop ? li[half][p] : hi[half][p];
        lv[half][p] = pop ? -INFINITY : lv[half][p];
        li[half][p] = pop ? INT_MAX : li[half][p];
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
    lm_head_wgmma(const __grid_constant__ CUtensorMap hmap,
                  const __grid_constant__ CUtensorMap wmap, int B, int V,
                  int KS, int S, int R, int P, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_v,
                  int* __restrict__ part_i) {
  constexpr int WBYTES = BN * KT * 2, HBYTES = TM * KT * 2;
  extern __shared__ unsigned char dyn[];
  unsigned char* wtile = dyn + ((1024 - (smem_addr(dyn) & 1023)) & 1023);
  unsigned char* hring = wtile + KS * WBYTES;
  uint64_t* wfull = reinterpret_cast<uint64_t*>(hring + S * HBYTES);
  uint64_t* wempty = wfull + KS;
  uint64_t* hfull = wempty + KS;
  uint64_t* hempty = hfull + S;
  uint64_t* issued = hempty + S;  // [CONSUMERS]
  const int T = (B + TM - 1) / TM;  // row tiles
  if (threadIdx.x == 0) {
    // a weight slice is released by the last row tile of each consumer
    // warpgroup that has one (every warp arrives); a ring stage by its
    // one consumer warpgroup
    for (int j = 0; j < KS; ++j) {
      bar_init(wfull + j, 1);
      bar_init(wempty + j, 4 * (T < CONSUMERS ? T : CONSUMERS));
    }
    for (int s = 0; s < S; ++s) {
      bar_init(hfull + s, 1);
      bar_init(hempty + s, 4);
    }
    for (int c = 0; c < CONSUMERS; ++c) bar_init(issued + c, 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * CONSUMERS) {  // the producer warpgroup: one thread works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == 4 * CONSUMERS && lane == 0) {
      int s = 0;         // ring stage, stepped once a slice
      uint32_t ph = 0;   // parity of the ring's round
      for (int v = 0, vt = blockIdx.x; vt < P; ++v, vt += gridDim.x)
        for (int t = 0; t < T; ++t)
          for (int j = 0; j < KS; ++j) {
            if (t == 0) {
              bar_wait(wempty + j, (v & 1) ^ 1);
              bar_expect(wfull + j, WBYTES);
              tma_load(wtile + j * WBYTES, &wmap, j * KT, vt * BN,
                       wfull + j);
            }
            bar_wait(hempty + s, ph ^ 1);
            bar_expect(hfull + s, HBYTES);
            tma_load(hring + s * HBYTES, &hmap, j * KT, t * TM, hfull + s);
            if (++s == S) {
              s = 0;
              ph ^= 1;
            }
          }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4, wi = warp % 4;
  static_assert(CONSUMERS == 2, "the warpgroups alternate");
  for (int v = 0, vt = blockIdx.x; vt < P; ++v, vt += gridDim.x) {
    const int g0 = v * T;  // the block's row tiles before this one
    int last = T - 1;      // this warpgroup's last row tile here
    if ((g0 + last) % 2 != wg) --last;
    for (int t = (g0 + wg) % 2; t < T; t += 2) {
      const int g = g0 + t;
      if (g > 0)  // tile g - 1 (the other warpgroup's) is issued
        bar_wait(issued + (1 - wg), ((g - 1) / 2) & 1);
      float acc[BN / 2];
#pragma unroll
      for (int n = 0; n < BN / 2; ++n) acc[n] = 0.f;
      // the ring position of the tile's first slice: stage and parity
      int s = g * KS % S, sp = 0;
      uint32_t ph = (g * KS / S) & 1;
      auto release = [&](int j, int stage) {
        if (lane == 0) {
          bar_arrive(hempty + stage);
          if (t == last) bar_arrive(wempty + j);
        }
      };
      for (int j = 0; j < KS; ++j) {
        bar_wait(wfull + j, v & 1);
        bar_wait(hfull + s, ph);
        fence_operands(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        const uint64_t da = sw128_desc(hring + s * HBYTES);
        const uint64_t db = sw128_desc(wtile + j * WBYTES);
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk, 1);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        fence_operands(acc);
        if (j > 0) {  // the previous slice's products are done
          wgmma_wait<1>();
          fence_operands(acc);
          release(j - 1, sp);
        }
        sp = s;
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      if (lane == 0) bar_arrive(issued + wg);
      wgmma_wait<0>();
      fence_operands(acc);
      release(KS - 1, sp);
      tile_partials<BN>(acc, t * TM + 16 * wi, vt * BN, vt, B, V, R, P,
                        part_m, part_l, part_v, part_i);
    }
  }
}

// ---- bf16, streamed over D: both operands through one TMA ring -----------

constexpr int ST_M = 2 * TM;   // rows of h a tile: 64 a consumer warpgroup
constexpr int ST_N = 256;      // vocab entries a tile: wgmma's widest N
constexpr int ST_HBYTES = ST_M * KT * 2;  // a stage's h slice [ST_M][KT]
constexpr int ST_WBYTES = ST_N * KT * 2;  // and its weight slice [ST_N][KT]
constexpr int ST_STAGE = ST_HBYTES + ST_WBYTES;

// Bytes of dynamic shared memory of the streamed kernel: 1 KB of alignment,
// the ring, and its full and empty mbarriers. ops/lm_head.py computes the
// same.
__host__ __device__ inline int streamed_smem(int stages) {
  return 1024 + stages * ST_STAGE + 2 * stages * 8;
}

// Leaves 0..2W-1 of (v, p), each the first of a range of positions that
// follow in order (leaf n's before leaf n + 1's), to leaf 0: neighbours
// n = 2i and 2i + 1 meet, the right one taken only if strictly larger, so a
// tie keeps the lower position.
template <int W, int N>
__device__ __forceinline__ void tree_first(float (&v)[N], int (&p)[N]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const bool take = v[2 * i + 1] > v[2 * i];
    v[i] = take ? v[2 * i + 1] : v[2 * i];
    p[i] = take ? p[2 * i + 1] : p[2 * i];
  }
  if constexpr (W > 1) tree_first<W / 2>(v, p);
}

// A warpgroup's half of a streamed tile (64 rows, 256 vocab entries) to
// partials, from its m64n256 accumulators in place: acc[4p + 2 half + j]
// is row row0 + lane / 4 + 8 half, column v0 + 8p + 2(lane % 4) + j
// (p < 32), so a thread holds 64 values of each of its two rows, a quad
// of lanes a whole row, and the quad
// writes one partial (max, sum-exp, top-R) per (row, vocab tile). R = 1: a
// max tree, the lowest column holding the max, the sum-exp. R > 1: each
// pair of a thread's neighbouring columns is ordered once in place (head
// first; bit p of `up` says the head is the second column), and a round
// takes the first head in selection order by a tree over the 32 heads
// whose left side always holds the lower columns (so a tie keeps the left),
// then the first over the quad; the pair that held the pick moves its
// second value up (-inf behind it) and flips its bit. Columns >= V are
// -inf and rank after every real column; an index >= V is written as
// INT_MAX, as tile_partials writes it.
__device__ __forceinline__ void streamed_partials(
    float (&acc)[ST_N / 2], int row0, int v0, int vt, int B, int V, int R,
    int P, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int NP = ST_N / 8;  // a thread's pairs of one row
  constexpr float kLog2e = 1.4426950408889634f;
  const int lane = threadIdx.x % 32, q = lane % 4;
  if (v0 + ST_N > V) {  // the ragged last tile
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (v0 + 8 * p + 2 * q + (e & 1) >= V) acc[4 * p + e] = -INFINITY;
  }
  if (R == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + lane / 4 + 8 * half;
      float t[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        t[p] = fmaxf(acc[4 * p + 2 * half], acc[4 * p + 2 * half + 1]);
      float mx = tree_max<NP / 2>(t);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      int at[NP];
      float l = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int g = v0 + 8 * p + 2 * q;
        const float a = acc[4 * p + 2 * half], b = acc[4 * p + 2 * half + 1];
        at[p] = a == mx ? g : (b == mx ? g + 1 : INT_MAX);
        l += exp2f((a - mx) * kLog2e) + exp2f((b - mx) * kLog2e);
      }
      int first = tree_min<NP / 2>(at);
      first = min(first, __shfl_xor_sync(0xffffffffu, first, 1));
      first = min(first, __shfl_xor_sync(0xffffffffu, first, 2));
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const size_t slot = (size_t)row * P + vt;
      if (row < B && q == 0) {
        part_m[slot] = mx;
        part_l[slot] = l;
        part_v[slot] = mx;
        part_i[slot] = first < V ? first : INT_MAX;
      }
    }
    return;
  }
  uint32_t up[2] = {0u, 0u};
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float& a = acc[4 * p + 2 * half];
      float& b = acc[4 * p + 2 * half + 1];
      const bool u = b > a;  // the second column first only if larger
      const float hi = u ? b : a, lo = u ? a : b;
      a = hi;
      b = lo;
      up[half] |= static_cast<uint32_t>(u) << p;
    }
  for (int k = 0; k < R; ++k) {
    float best[2];
    int at[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tv[NP / 2];
      int tp[NP / 2];
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) {
        const float a = acc[8 * i + 2 * half], b = acc[8 * i + 4 + 2 * half];
        const bool take = b > a;
        tv[i] = take ? b : a;
        tp[i] = take ? 2 * i + 1 : 2 * i;
      }
      tree_first<NP / 4>(tv, tp);
      best[half] = tv[0];
      at[half] = v0 + 8 * tp[0] + 2 * q + ((up[half] >> tp[0]) & 1);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) warp_best<4>(best[half], at[half]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + lane / 4 + 8 * half;
      const bool writes = row < B && q == 0;
      const size_t slot = (size_t)row * P + vt;
      if (k == 0) {  // the row's max over the tile; masked values are -inf
        float l = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          l += exp2f((acc[4 * p + 2 * half] - best[half]) * kLog2e) +
               exp2f((acc[4 * p + 2 * half + 1] - best[half]) * kLog2e);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        if (writes) {
          part_m[slot] = best[half];
          part_l[slot] = l;
        }
      }
      if (writes) {
        part_v[slot * R + k] = best[half];
        part_i[slot * R + k] = at[half] < V ? at[half] : INT_MAX;
      }
      if (k + 1 < R) {  // the pick leaves its pair, in the lane holding it
        const int off = at[half] - v0;
        const int pp = ((off >> 1) & 3) == q ? off >> 3 : -1;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          float& a = acc[4 * p + 2 * half];
          float& b = acc[4 * p + 2 * half + 1];
          const bool pop = p == pp;
          a = pop ? b : a;
          b = pop ? -INFINITY : b;
        }
        if (pp >= 0) up[half] ^= 1u << pp;
      }
    }
  }
}

// The streamed design of the note above: block b takes tiles b, b + grid,
// ... of T row tiles x P vocab tiles (row tiles innermost); a ring of S
// stages, each released by every consumer warp (4 * CONSUMERS arrivals).
__global__ void __launch_bounds__(WG_THREADS, 1)
    lm_head_wgmma_streamed(const __grid_constant__ CUtensorMap hmap,
                           const __grid_constant__ CUtensorMap wmap, int B,
                           int V, int KS, int S, int R, int P,
                           float* __restrict__ part_m,
                           float* __restrict__ part_l,
                           float* __restrict__ part_v,
                           int* __restrict__ part_i) {
  extern __shared__ unsigned char dyn[];
  unsigned char* ring = dyn + ((1024 - (smem_addr(dyn) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * ST_STAGE);
  uint64_t* empty = full + S;
  const int T = (B + ST_M - 1) / ST_M;  // row tiles
  const int tiles = T * P;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 4 * CONSUMERS);  // every consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * CONSUMERS) {  // the producer warpgroup: one thread works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == 4 * CONSUMERS && lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int t = tile % T, vt = tile / T;
        for (int j = 0; j < KS; ++j) {
          bar_wait(empty + s, ph ^ 1);
          unsigned char* st = ring + s * ST_STAGE;
          bar_expect(full + s, ST_STAGE);
          tma_load(st, &hmap, j * KT, t * ST_M, full + s);
          tma_load(st + ST_HBYTES, &wmap, j * KT, vt * ST_N, full + s);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4, wi = warp % 4;
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t = tile % T, vt = tile / T;
    float acc[ST_N / 2];
#pragma unroll
    for (int n = 0; n < ST_N / 2; ++n) acc[n] = 0.f;
    int sp = 0;
    for (int j = 0; j < KS; ++j) {
      bar_wait(full + s, ph);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      const uint64_t da = sw128_desc(ring + s * ST_STAGE + wg * TM * KT * 2);
      const uint64_t db = sw128_desc(ring + s * ST_STAGE + ST_HBYTES);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_bf16<ST_N>(acc, da + 2 * kk, db + 2 * kk, 1);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_operands(acc);
      if (j > 0) {  // the previous slice's products are done
        wgmma_wait<1>();
        fence_operands(acc);
        if (lane == 0) bar_arrive(empty + sp);
      }
      sp = s;
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) bar_arrive(empty + sp);
    streamed_partials(acc, t * ST_M + wg * TM + 16 * wi, vt * ST_N, vt, B,
                      V, R, P, part_m, part_l, part_v, part_i);
  }
}

// ---- f32: FMA ------------------------------------------------------------

constexpr int FTB = 64;        // hidden rows per block
constexpr int VC = 128;        // vocab entries per block (one chunk)
constexpr int FKT = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;   // 8 warps
constexpr int SLD = VC + 4;    // leading dim of the f32 score tile
constexpr int F_LD = FKT + 1;  // operand tiles, padded against conflicts
constexpr int SMEM_BYTES = FTB * SLD * 4;  // score tile; operands alias it
static_assert((FTB + VC) * F_LD * 4 <= SMEM_BYTES, "f32 operands fit");

// Thread (ty, tx) accumulates rows ty*4+i, columns tx+16*j.
__device__ void score_tile(const float* __restrict__ h,
                           const float* __restrict__ w, int B, int V, int D,
                           int row0, int v0, unsigned char* smem) {
  float* hs = reinterpret_cast<float*>(smem);  // [FTB][F_LD]
  float* ws = hs + FTB * F_LD;                 // [VC][F_LD]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += FKT) {
    for (int e = tid; e < FTB * FKT; e += THREADS) {
      const int r = e / FKT, kk = e % FKT, row = row0 + r, k = k0 + kk;
      hs[r * F_LD + kk] = (row < B && k < D) ? h[(size_t)row * D + k] : 0.f;
    }
    for (int e = tid; e < VC * FKT; e += THREADS) {
      const int n = e / FKT, kk = e % FKT, g = v0 + n, k = k0 + kk;
      ws[n * F_LD + kk] = (g < V && k < D) ? w[(size_t)g * D + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FKT; ++kk) {
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

// One block per (64-row tile, vocab chunk c), the row tiles of a chunk
// launched together so that they read it from the L2: one warp per row
// reduces the score tile to the chunk's (max, sum-exp, top-R).
__global__ void __launch_bounds__(THREADS)
    lm_head_fma(const float* __restrict__ h, const float* __restrict__ w,
                int B, int V, int D, int R, int NC, float* __restrict__ part_m,
                float* __restrict__ part_l, float* __restrict__ part_v,
                int* __restrict__ part_i) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int row0 = blockIdx.x * FTB, c = blockIdx.y, v0 = c * VC;
  score_tile(h, w, B, V, D, row0, v0, smem);
  __syncthreads();
  const float* sc = reinterpret_cast<const float*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int PER_LANE = VC / 32;
  for (int r = warp; r < FTB; r += THREADS / 32) {
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

// ---- pass 2 --------------------------------------------------------------

constexpr int MERGE_THREADS = 256;
constexpr int MERGE_WARPS = MERGE_THREADS / 32;

// One block per row: the logsumexp of the row's P partials and the first
// R of its P * R candidates in selection order, R rounds each taking the
// first candidate strictly after the previous pick. A partial's R
// candidates are in selection order, so the k-th pick (from 0) is at
// position k or before in its partial (all that rank before it there were
// picked earlier): round k reads positions 0..k of each partial.
__global__ void __launch_bounds__(MERGE_THREADS)
    lm_head_merge(const float* __restrict__ part_m,
                  const float* __restrict__ part_l,
                  const float* __restrict__ part_v,
                  const int* __restrict__ part_i, int P, int R,
                  float* __restrict__ vals, int64_t* __restrict__ idx,
                  float* __restrict__ lse) {
  __shared__ float sv[MERGE_WARPS];
  __shared__ int si[MERGE_WARPS];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float* m = part_m + (size_t)row * P;
  const float* l = part_l + (size_t)row * P;
  float M = -INFINITY;
  for (int c = tid; c < P; c += MERGE_THREADS) M = fmaxf(M, m[c]);
  M = warp_max(M);
  if (lane == 0) sv[warp] = M;
  __syncthreads();
  M = sv[0];
  for (int w = 1; w < MERGE_WARPS; ++w) M = fmaxf(M, sv[w]);
  __syncthreads();
  float S = 0.f;
  for (int c = tid; c < P; c += MERGE_THREADS) S += l[c] * expf(m[c] - M);
  S = warp_sum(S);
  if (lane == 0) sv[warp] = S;
  __syncthreads();
  if (tid == 0) {
    S = 0.f;
    for (int w = 0; w < MERGE_WARPS; ++w) S += sv[w];
    lse[row] = M + logf(S);
  }
  const float* cv = part_v + (size_t)row * P * R;
  const int* ci = part_i + (size_t)row * P * R;
  float pv = INFINITY;
  int pi = -1;
  for (int k = 0; k < R; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int e = tid; e < P * (k + 1); e += MERGE_THREADS) {
      const int at = e / (k + 1) * R + e % (k + 1);  // partial, position
      const float v = cv[at];
      const int i = ci[at];
      if (ranks_before(pv, pi, v, i) && ranks_before(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_best(bv, bi);
    __syncthreads();  // the previous round's reads of sv/si are done
    if (lane == 0) {
      sv[warp] = bv;
      si[warp] = bi;
    }
    __syncthreads();
    bv = sv[0];
    bi = si[0];
    for (int w = 1; w < MERGE_WARPS; ++w)
      if (ranks_before(sv[w], si[w], bv, bi)) {
        bv = sv[w];
        bi = si[w];
      }
    if (tid == 0) {
      vals[(size_t)row * R + k] = bv;
      idx[(size_t)row * R + k] = bi;
    }
    pv = bv;
    pi = bi;
  }
}

// ---- host ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled, reached through the runtime
// so that the library needs no -lcuda; null if the installed CUDA driver
// lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of the bf16 matrix [rows, D] (row-major) in boxes of [box_rows,
// KT], swizzled for wgmma; reads past the edges fill with zeros.
bool bf16_map(CUtensorMap* map, const void* p, int rows, int D,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KT, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(p), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_wgmma(const void* h, const void* w, int B, int V, int D,
                         int R, int P, int stages, int grid, int smem,
                         float* part_m, float* part_l, float* part_v,
                         int* part_i, cudaStream_t stream) {
  const int ks = (D + KT - 1) / KT;
  if (smem != wgmma_smem(ks, BN, stages) || smem > SMEM_LIMIT ||
      stages < 2 || grid < 1 || grid > P || D % 8 ||
      reinterpret_cast<uintptr_t>(h) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  if (!bf16_map(&hmap, h, B, D, TM) || !bf16_map(&wmap, w, V, D, BN))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      lm_head_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  lm_head_wgmma<BN><<<grid, WG_THREADS, smem, stream>>>(
      hmap, wmap, B, V, ks, stages, R, P, part_m, part_l, part_v, part_i);
  return cudaGetLastError();
}

cudaError_t launch_streamed(const void* h, const void* w, int B, int V,
                            int D, int R, int P, int stages, int grid,
                            int smem, float* part_m, float* part_l,
                            float* part_v, int* part_i, cudaStream_t stream) {
  const int ks = (D + KT - 1) / KT;
  const int tiles = (B + ST_M - 1) / ST_M * P;
  if (smem != streamed_smem(stages) || smem > SMEM_LIMIT || stages < 2 ||
      grid < 1 || grid > tiles || D % 8 ||
      reinterpret_cast<uintptr_t>(h) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  if (!bf16_map(&hmap, h, B, D, ST_M) || !bf16_map(&wmap, w, V, D, ST_N))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      lm_head_wgmma_streamed, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  lm_head_wgmma_streamed<<<grid, WG_THREADS, smem, stream>>>(
      hmap, wmap, B, V, ks, stages, R, P, part_m, part_l, part_v, part_i);
  return cudaGetLastError();
}

}  // namespace
}  // namespace capdec

// Both passes. The plan (tile_n, stages, threads, blocks, smem) is the
// wrapper's: bf16 tile_n 128 (weight-stationary) or 256 (the streamed
// kernel's tiles of 128 rows) on 384 threads over `blocks` persistent
// blocks; f32 tile_n 128, one stage, 256 threads, blocks = P
// vocab chunks (by the row tiles), its static shared memory. P is
// ceil(V / tile_n).
extern "C" int capdec_lm_head_topk(const void* h, const void* w, int B, int V,
                                   int D, int R, int P, float* part_m,
                                   float* part_l, float* part_v, int* part_i,
                                   float* vals, int64_t* idx, float* lse,
                                   int tile_n, int stages, int threads,
                                   int blocks, int smem, int dtype,
                                   cudaStream_t stream) {
  using namespace capdec;
  if (B < 1 || V < 1 || D < 1 || tile_n < 1 || R < 1 || R > tile_n ||
      R > V || P != (V + tile_n - 1) / tile_n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kBF16) {
    if (threads != WG_THREADS) return static_cast<int>(cudaErrorInvalidValue);
    switch (tile_n) {
      case 128:
        err = launch_wgmma<128>(h, w, B, V, D, R, P, stages, blocks, smem,
                                part_m, part_l, part_v, part_i, stream);
        break;
      case ST_N:
        err = launch_streamed(h, w, B, V, D, R, P, stages, blocks, smem,
                              part_m, part_l, part_v, part_i, stream);
        break;
      default:
        err = cudaErrorInvalidValue;
    }
  } else {
    if (tile_n != VC || stages != 1 || threads != THREADS ||
        smem != SMEM_BYTES || blocks != P)
      return static_cast<int>(cudaErrorInvalidValue);
    lm_head_fma<<<dim3((B + FTB - 1) / FTB, P), THREADS, 0, stream>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), B, V, D,
        R, P, part_m, part_l, part_v, part_i);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  lm_head_merge<<<B, MERGE_THREADS, 0, stream>>>(part_m, part_l, part_v,
                                                 part_i, P, R, vals, idx, lse);
  return static_cast<int>(cudaGetLastError());
}
