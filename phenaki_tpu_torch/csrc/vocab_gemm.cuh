// The main loop of the two bf16 kernels that fold the vocab projection
// logits = h . W^T (+ bias) into per-row statistics without writing the
// logits: the projection sampler (proj_sample.cu, kernel 2) and the fused
// cross-entropy forward (fused_ce.cu, kernel 7). Each passes its own
// epilogue; this header owns the tiling, the copies and the products.
//
//  - A block (two warpgroups, 256 threads) owns 128 rows of h (64 a
//    warpgroup) and one of S vocab splits, and walks the split's 128-id
//    vocab tiles. The grid is (row tiles, S), row tiles fastest, so the
//    blocks of one split read the same W tiles at about the same time and W
//    comes from HBM about once; L2 serves it once a row tile.
//  - d streams through a ring of PB_STAGES shared-memory stages of 64-column
//    slices (16 KB of W a stage), filled with 16-byte cp.async in the
//    128-byte swizzle a TMA copy would write; the products are wgmma
//    m64n128k16 with both operands in shared memory (W is a K-major B: its
//    rows are vocab ids, d contiguous). Up to d = 512 the block's rows of h
//    stay in shared memory (128 KB; 211 KB in all); past that h streams
//    through the ring beside W.
//  - The epilogue runs on the accumulator registers (wgmma.cuh layout: a
//    thread holds rows row0 and row0 + 8 at columns 8 n + 2 c and
//    8 n + 2 c + 1 of each 8-column block n). The bias arrives in shared
//    memory with the tile's first slice.
//  - Two accumulators: a pass issues tile t's products slice by slice, then
//    runs tile t - 1's epilogue under the products still in flight.
// h must hold round_up(rows, 128) rows (the wrappers zero-pad it); V is a
// multiple of 128 and every split holds at least one tile.
#pragma once

#include "wgmma.cuh"

namespace phenaki {
namespace {

constexpr int PB_ROWS = 128;   // rows of h a block: 64 a warpgroup
constexpr int PB_VT = 128;     // vocab ids a tile
constexpr int PB_KS = 64;      // d columns a ring slice: one 128-byte swizzle row
constexpr int PB_STAGES = 5;   // ring stages: 3 slices load ahead of the products
constexpr int PB_THREADS = 2 * WG_THREADS;
constexpr int PB_SLICE = PB_ROWS * PB_KS * 2;  // bytes of a slice of h, and of W
constexpr int PB_RESIDENT_NS = 8;              // h stays in shared memory up to d = 512
constexpr int PB_BIAS_SLOTS = 4;  // tiles' bias in flight: loaded 1-2 passes before
                                  // its epilogue, read for one pass
constexpr int PB_BLOCKS = PB_VT / 8;  // 8-column blocks of a tile
constexpr float LN2 = 0.6931471805599453f;
// an epilogue's running sum-exp of 2^(x - m), x a logit in log2 units,
// keeps a reference m that rises only when an x passes it by more than this:
// 2^64 of headroom in f32, one ex2 a logit and no running max
constexpr float PB_RESCALE = 64.f;

// The main loop reads its operands from the kernel's parameter struct P,
// which has (at least) h (round_up(rows, 128), D) and w (V, D) bf16, bias
// (V,) f32 or null, and D, V and splits, the grid's vocab splits. (A struct
// of the loop's own nested in each kernel's parameters compiled kernel 2 to
// the same instructions in another schedule, 5-7% slower with the noise
// hook on an H100.)

// a ring stage: the W slice, then (h streamed) the h slice
template <bool RES>
__host__ __device__ constexpr int pb_stage() { return RES ? PB_SLICE : 2 * PB_SLICE; }

// shared memory: resident h (NS slices), the ring, the bias slots, 1 KB to
// align: 211 KB at d = 512, 163 KB with h streamed
template <bool RES>
int pb_smem(int NS) {
  return (RES ? NS * PB_SLICE : 0) + PB_STAGES * pb_stage<RES>() + PB_BIAS_SLOTS * PB_VT * 4 + 1024;
}

// rows [r0, r0 + 128) x columns [c0, c0 + 64) of a row-major (., D) bf16
// array into 128 swizzled rows of 128 bytes (8-row groups 1024 B apart)
__device__ __forceinline__ void load_slice(uint32_t dst, const bf16* src, size_t r0, int c0, int D) {
#pragma unroll
  for (int it = 0; it < PB_ROWS * 8 / PB_THREADS; ++it) {
    const int e = threadIdx.x + it * PB_THREADS;
    const int r = e >> 3, ch = e & 7;
    cp_async16(dst + r * 128 + ((ch ^ (r & 7)) << 4), src + (r0 + r) * D + c0 + ch * 8, 16);
  }
}

// (m, se) of sum-exps in log2 units merged with (om, ose)
__device__ __forceinline__ void merge_lse2(float& m, float& se, float om, float ose) {
  const float mn = fmaxf(m, om);
  if (mn == -INFINITY) return;
  se = (m == -INFINITY ? 0.f : se * ex2(m - mn)) + (om == -INFINITY ? 0.f : ose * ex2(om - mn));
  m = mn;
}

// the block's per-launch constants and its position in the ring
struct Walk {
  uint32_t hres;   // resident h (NS slices), 1 KB aligned; the ring follows
  uint32_t ring;
  float* sbias;    // the bias slots after the ring, generic
  size_t r0;       // the block's first row
  int t_begin, nt, NS, passes, total;
  int row0, c, wg;  // this thread's first accumulator row (global), its column pair, its warpgroup
};

// the walk of this block: row tile blockIdx.x, vocab split blockIdx.y
template <bool RES, class P>
__device__ __forceinline__ Walk make_walk(const P& p, unsigned char* smem_raw) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int split = blockIdx.y, T = p.V / PB_VT;
  Walk k;
  k.NS = p.D / PB_KS;
  k.hres = smem_base_1k(smem_raw);
  k.ring = k.hres + (RES ? k.NS * PB_SLICE : 0);
  k.sbias = reinterpret_cast<float*>(smem_raw + (k.ring - smem_u32(smem_raw)) + PB_STAGES * pb_stage<RES>());
  k.r0 = (size_t)blockIdx.x * PB_ROWS;
  k.t_begin = split * T / p.splits;
  k.nt = (split + 1) * T / p.splits - k.t_begin;
  // passes: the split's tiles, then one whose epilogue is the last tile's,
  // rounded up to an even count (two passes a trip below)
  k.passes = (k.nt + 2) & ~1;
  k.total = k.passes * k.NS;
  k.wg = tid >> 7;
  k.c = lane & 3;
  k.row0 = (int)k.r0 + k.wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  return k;
}

// step i of the ring (tile i / NS of the split, d slice i % NS) into its
// stage, and with a tile's first slice its bias into slot tile % 4; the
// steps of the padding tiles past the split's last reload that one
template <bool RES, class P>
__device__ __forceinline__ void load_step(const P& p, const Walk& k, int i) {
  const uint32_t st = k.ring + (i % PB_STAGES) * pb_stage<RES>();
  const int tl = i / k.NS, t = k.t_begin + min(tl, k.nt - 1), c0 = (i % k.NS) * PB_KS;
  load_slice(st, p.w, (size_t)t * PB_VT, c0, p.D);
  if (!RES) load_slice(st + PB_SLICE, p.h, k.r0, c0, p.D);
  if (p.bias && c0 == 0 && tl < k.nt && threadIdx.x < PB_VT / 4)
    cp_async16(smem_u32(k.sbias + (tl % PB_BIAS_SLOTS) * PB_VT + threadIdx.x * 4),
               p.bias + (size_t)t * PB_VT + threadIdx.x * 4, 16);
}

// tile tl's products into `an`, then tile tl - 1's epilogue from `ac`, which
// runs under the products still in flight: epi(ac, v0, sbias) with v0 the
// tile's first vocab id and sbias its bias in shared memory (or null).
// `ac`'s products retire before `an`'s are issued, so only `an` is ever in
// flight while `ac` is read; every pass issues its products (past the
// split's last tile they are padding), and nothing but wgmma writes an
// accumulator: one written on some paths only would be copied at the join,
// and ptxas then serializes the wgmma pipeline.
template <bool RES, class P, class Epi>
__device__ __forceinline__ void tile_pass(const P& p, const Walk& k, Epi& epi, float (&an)[64],
                                          float (&ac)[64], int tl) {
  wg_wait<0>();
  fence_regs(ac);
  for (int s = 0; s < k.NS; ++s) {
    const int i = tl * k.NS + s;
    cp_async_wait<PB_STAGES - 3>();  // this thread's copies of step i have landed
    fence_proxy_async();
    // every thread's copies of step i are visible, and every warpgroup's
    // products of step i - 2 are done: its stage is free
    __syncthreads();
    if (i + PB_STAGES - 2 < k.total) load_step<RES>(p, k, i + PB_STAGES - 2);
    cp_async_commit();
    const uint32_t sw = k.ring + (i % PB_STAGES) * pb_stage<RES>();
    const uint32_t sh = (RES ? k.hres + s * PB_SLICE : sw + PB_SLICE) + k.wg * (64 * 128);
    fence_regs(an);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < PB_KS / 16; ++kk)
      wgmma_ss<128, 0>(an, kmajor_desc(sh, kk), kmajor_desc(sw, kk), s > 0 || kk > 0);
    wg_commit();
    wg_wait<1>();  // step i - 1's products are done
  }
  if (tl >= 1 && tl <= k.nt) {  // tile tl - 1 is one of the split's
    const int v0 = (k.t_begin + tl - 1) * PB_VT;
    const float* sbias = p.bias ? k.sbias + ((tl - 1) % PB_BIAS_SLOTS) * PB_VT : nullptr;
    epi(ac, v0, sbias);
  }
}

// the whole walk of the block's split: every tile's logits (without the
// bias) reach `epi` once, in vocab order
template <bool RES, class P, class Epi>
__device__ __forceinline__ void vocab_walk(const P& p, const Walk& k, Epi& epi) {
  float acc0[64], acc1[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc0[x] = acc1[x] = 0.f;

  // resident h: all of the block's rows, with the first step's copies
  if (RES)
    for (int s = 0; s < k.NS; ++s) load_slice(k.hres + s * PB_SLICE, p.h, k.r0, s * PB_KS, p.D);
#pragma unroll
  for (int i = 0; i < PB_STAGES - 2; ++i) {
    load_step<RES>(p, k, i);  // a split has at least one tile: 2 NS >= PB_STAGES - 2 steps
    cp_async_commit();
  }
  // two passes a trip, so each accumulator keeps its role in the code
  for (int tl = 0; tl < k.passes; tl += 2) {
    tile_pass<RES>(p, k, epi, acc0, acc1, tl);
    tile_pass<RES>(p, k, epi, acc1, acc0, tl + 1);
  }
  wg_wait<0>();
  cp_async_wait<0>();
}

}  // namespace
}  // namespace phenaki
