// Flash-attention forward for QK-norm cosine attention on Hopper (sm_90a),
// and its ring-chunk variant.
//
// Replaces the TPU kernel phenaki_tpu/ops/pallas_attention.py::_flash_kernel
// in its two uses: kernel 1 (flash_qk_attention -> _flash_forward ->
// pl.pallas_call) and kernel 3, the ring-attention chunk (flash_attend_chunk
// -> _flash_forward(c2_external=, offsets=, return_raw=True), the
// `offs_ref` operand).
// Math contract, per (batch b, head h, query row r):
//   s[c]  = scale * q[r] . k[c] + bias[h, r, c] + kmask[b, c]
//   s[c]  = -inf where causal and c + k_off > r + q_off
// Kernel 1 (queries are the last i of j keys: q_off = j - i, k_off = 0):
//   out[r] = softmax(s) @ v,  lse[r] = logsumexp(s)   (f32 statistics)
// Kernel 3 (one K/V shard of a ring; global offsets, a global bound c2):
//   p[c] = 2^(s[c] * log2(e) - c2),  acc[r] = sum_c p[c] v[c],  l[r] = sum_c p[c]
//   (f32, unnormalised, no running max: every chunk of the ring shares c2,
//   so the chunks' acc and l add). c2 is an f32 scalar read from device
//   memory, so the ring never syncs the host for it.
// An additive kmask value <= -1e29 is a hard mask (weight exactly 0). A row
// whose keys are all masked is defined as out = 0, lse = -inf (kernel 1, as
// the TPU kernel's max(l, 1e-37) normalisation gives), and acc = 0, l = 0
// (kernel 3). The bias is read with a row stride `ldb`, so kernel 3 reads
// its (h, i, j) column slice of the local rows' (h, i, N) bias in place.
//
// What bounds it on the H100: at the flagship self-attention (2, 8, 1152,
// 64) with its (8, 1152, 1152) bf16 bias, the call must move 30.7 MB, 21.2
// MB of it the bias (9.2 us at 3.35 TB/s), against 5.4 GFLOP of products
// (5.5 us at 989 TFLOP/s): bound by bytes, the bias first. Between the two
// products sits the softmax, an exp per score on the multi-function unit
// (16 a clock an SM) and a handful of ALU instructions per score, which at
// d = 64 cost more issue slots than the products.
//
// The design (bf16, d = 64: flash_fwd_wgmma_kernel): one warpgroup
// (128 threads) owns 64 query rows of one (b, h) and walks the key tiles.
//  - S = Q K^T is one wgmma m64n64k16 chain per 64-key tile, Q and K read by
//    the tensor cores from shared memory in the 128-byte-swizzled K-major
//    layout; S stays in registers (32 f32 a thread).
//  - The epilogue runs on the accumulator registers: the scale with log2(e)
//    folded in; the bias tile read from shared memory by ldmatrix straight
//    into the accumulator layout; the kmask, causal and ragged-edge masks
//    only on a tile that one of them reaches; the online softmax's row max
//    (4 lanes share a row: two xor shuffles) and ex2. Kernel 3 (template
//    flag RAW) shifts by the fixed c2 instead of the running max.
//  - P never leaves registers: the accumulator layout of S is the register
//    A-operand layout of the next wgmma, so P is packed to bf16 in place and
//    O += P V runs as wgmma m64n{64,128}k16 with V (keys x d, d contiguous)
//    read from shared memory as an MN-major B (the transpose flag). O stays
//    in registers and is rescaled there.
//  - K, V and the bias tile stream through a two-stage ring in shared
//    memory, filled with 16-byte cp.async (zero-filled past the ragged
//    edges, which the masks then hide): tile t + 1's copies are in flight
//    while tile t computes. Shared memory is 59 KB a block (Q 8 KB, two
//    stages of K 8 KB + V 8 KB + bias 9 KB, 1 KB alignment slack), and the
//    registers stay under 168 (__launch_bounds__), so three blocks (twelve
//    warps) fit on an SM and the flagship grid of 288 blocks runs in one
//    wave on 132 SMs (396 slots). Overlapping tile t's softmax with tile
//    t - 1's P V inside the warpgroup (a software pipeline) measured no
//    faster on the card at the flagship shapes, with more registers, and
//    was left out.
//  - The bias, the largest operand, moves from HBM once per (h, query
//    tile): the batch is the fastest grid index (blockIdx.x), so the blocks
//    of one (h, query tile) run side by side and L2 serves every batch row
//    after the first. One block walking the batch rows over a resident bias
//    tile was the other choice; it would put the batch rows in series inside
//    a block and cut the grid (and the blocks that hide each other's
//    softmax) by the batch size.
// At d = 128 (flash_fwd_wgmma_d128, the 4 heads x 128 flagship) the same
// loop, with O an m64n128 accumulator (64 registers a thread), was bound by
// two things at the train step's (4, 4, 1152, 128) with the bias and an
// all-zero key mask, which a probe of that kernel on the H100 separated
// (examples/flash_d128_probe.py): the key mask, read column by column from
// global memory inside the softmax's chain, nearly doubled its time; and at
// 99 KB a block (two stages of 64 x 128 K and V) two blocks fit an SM, so
// the grid's 288 blocks ran 264 at once and then a second wave of 24. The
// d = 128 kernel therefore
//  - copies each key tile's mask terms (kmask log2(e), or -inf past J or
//    where the key is hard-masked) into shared memory with the tile and
//    folds them into the bias's FMA, on the tiles a key mask or the ragged
//    edge reaches (the other tiles run the d = 64 kernel's epilogue);
//  - runs a ring of one stage or two, picked at launch: two (101 KB, two
//    blocks an SM) while the grid fits one wave of two blocks an SM, as the
//    sample's 144 blocks do; one (59 KB, 168 registers, three blocks an SM)
//    past that, so that the train step's 288 blocks run in one wave. With one
//    stage tile t + 1's K and bias are copied under tile t's softmax and P V,
//    and its V under tile t + 1's S and softmax; a block alone waits longer
//    for its copies, which is why a grid that fits keeps two.
// FlashAttention-3's shape, 128 query rows a block in two warpgroups that
// share each K, V and bias tile, needs about 133 KB: one block an SM, and the
// train grid's 144 blocks would again run a second wave on 132 SMs. It was
// not built.
// The wrapper guarantees what the 16-byte copies need: q, k, v, out and the
// bias 16-byte aligned, and the bias row stride a multiple of 8 (it copies
// an operand that is not); the entry points return cudaErrorMisalignedAddress
// otherwise. f32 and other head sizes run both products on the CUDA cores in
// f32 (flash_fwd_kernel, 64 x 64 tiles in shared memory), also with the RAW
// flag; no main path runs it.

#include <type_traits>

#include "wgmma.cuh"

namespace phenaki {
namespace {

constexpr int THREADS = 256; // 16 x 16 thread grid
constexpr float LN2 = 0.6931471805599453f;

struct Fwd {
  const void *q, *k, *v, *bias;
  const float* kmask;
  const float* c2;  // kernel 3: the shared bound (log2 units), on the device
  void* out;        // kernel 1: (b, h, i, d) in the input dtype; kernel 3: acc f32
  float* lse;       // kernel 1: (b, h, i) or null; kernel 3: l (b, h, i)
  int B, H, I, J, D, ldb;
  float scale;
  int causal, q_off, k_off;
};

// the number of 64-key tiles a block of queries [q0, q0 + 64) must visit:
// with causal masking, keys past the tile's last row are masked for every row
__device__ __forceinline__ int key_tiles(const Fwd& a, int q0) {
  int n = (a.J + BK - 1) / BK;
  if (a.causal) {
    const int last_key = min(a.J - 1, q0 + BQ - 1 + a.q_off - a.k_off);
    n = last_key < 0 ? 0 : min(n, last_key / BK + 1);
  }
  return n;
}

// thread (ty, tx) owns query rows ty + 16*rr and key columns tx + 16*cc of
// every score tile, and output columns tx + 16*oc of the accumulator
template <typename T, int DP, bool RAW>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Fwd a) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][DP]
  float* Ks = Qs + BQ * DP;            // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);      // [BK][DP]
  float* Ps = Vs + BK * DP;            // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int I = a.I, J = a.J, D = a.D;
  const size_t bh = (size_t)bb * a.H + hh;
  const T* qp = (const T*)a.q + bh * I * D;
  const T* kp = (const T*)a.k + bh * J * D;
  const T* vp = (const T*)a.v + bh * J * D;
  const T* biasp = a.bias ? (const T*)a.bias + (size_t)hh * I * a.ldb : nullptr;
  const float* kmaskp = a.kmask ? a.kmask + (size_t)bb * J : nullptr;
  const float c2 = RAW ? *a.c2 : 0.f;

  for (int e = tid; e < BQ * DP; e += THREADS) {
    int r = e / DP, c = e % DP;
    float val = 0.f;
    if (q0 + r < I && c < D) val = to_f32(qp[(size_t)(q0 + r) * D + c]) * a.scale;
    Qs[e] = val;
  }

  constexpr int OC = DP / 16;
  float acc[4][OC];
  float m[4], l[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) acc[rr][oc] = 0.f;
  }

  const int num_k_tiles = key_tiles(a, q0);
  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's Ks/Vs/Ps are consumed
    for (int e = tid; e < BK * DP; e += THREADS) {
      int r = e / DP, c = e % DP;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < J && c < D) {
        kv = to_f32(kp[(size_t)(k0 + r) * D + c]);
        vv = to_f32(vp[(size_t)(k0 + r) * D + c]);
      }
      Ks[r * (DP + 1) + c] = kv;
      Vs[r * DP + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[rr][cc] = 0.f;
#pragma unroll 8
    for (int x = 0; x < DP; ++x) {
      float qa[4], kb[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) qa[rr] = Qs[(ty + 16 * rr) * DP + x];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) kb[cc] = Ks[(tx + 16 * cc) * (DP + 1) + x];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[rr][cc] = fmaf(qa[rr], kb[cc], s[rr][cc]);
    }

#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int row = q0 + ty + 16 * rr;
      float tile_max = -INFINITY;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = k0 + tx + 16 * cc;
        bool valid = col < J && row < I;
        if (a.causal && col + a.k_off > row + a.q_off) valid = false;
        float sv = s[rr][cc];
        if (valid) {
          if (biasp) sv += to_f32(biasp[(size_t)row * a.ldb + col]);
          if (kmaskp) {
            float km = kmaskp[col];
            if (km <= MASKED) valid = false;
            sv += km;
          }
        }
        s[rr][cc] = valid ? sv : -INFINITY;
        tile_max = fmaxf(tile_max, s[rr][cc]);
      }
      float alpha = 1.f, m_new = 0.f;
      if (!RAW) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off, 16));
        m_new = fmaxf(m[rr], tile_max);
        alpha = (m[rr] == -INFINITY) ? 0.f : expf(m[rr] - m_new);
      }
      float psum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float p;
        if (RAW)
          p = (s[rr][cc] == -INFINITY) ? 0.f : exp2f(s[rr][cc] * LOG2E - c2);
        else
          p = (s[rr][cc] == -INFINITY) ? 0.f : expf(s[rr][cc] - m_new);
        Ps[(ty + 16 * rr) * (BK + 1) + tx + 16 * cc] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off, 16);
      l[rr] = l[rr] * alpha + psum;
      if (!RAW) {
        m[rr] = m_new;
#pragma unroll
        for (int oc = 0; oc < OC; ++oc) acc[rr][oc] *= alpha;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vb[OC];
#pragma unroll
      for (int oc = 0; oc < OC; ++oc) vb[oc] = Vs[c * DP + tx + 16 * oc];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float p = Ps[(ty + 16 * rr) * (BK + 1) + c];
#pragma unroll
        for (int oc = 0; oc < OC; ++oc) acc[rr][oc] = fmaf(p, vb[oc], acc[rr][oc]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + ty + 16 * rr;
    if (row >= I) continue;
    if (RAW) {
      float* op = (float*)a.out + (bh * I + row) * D;
#pragma unroll
      for (int oc = 0; oc < OC; ++oc) {
        const int c = tx + 16 * oc;
        if (c < D) op[c] = acc[rr][oc];
      }
      if (tx == 0) a.lse[bh * I + row] = l[rr];
      continue;
    }
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    T* op = (T*)a.out + (bh * I + row) * D;
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) {
      const int c = tx + 16 * oc;
      if (c < D) op[c] = from_f32<T>(acc[rr][oc] * inv);
    }
    if (a.lse && tx == 0)
      a.lse[bh * I + row] = l[rr] > 0.f ? m[rr] + logf(l[rr]) : -INFINITY;
  }
}


// ---------------------------------------------------------------------------
// bf16 at d = 64: wgmma with register-resident scores (see the note at the
// top; the accumulator layout and the helpers are in wgmma.cuh).
// ---------------------------------------------------------------------------

template <int DP>
struct WgSmem {
  static constexpr int tile = BK * DP * 2;      // Q, K or V: 64 rows of DP bf16
  static constexpr int bias = BQ * BIAS_LD * 2;  // one 64 x 64 bias tile, padded rows
  static constexpr int stage = 2 * tile + bias;  // K, V, bias
  static constexpr int total = tile + 2 * stage + 1024;  // Q, two stages, 1 KB to align
};

template <int DP, bool RAW>
__global__ void __launch_bounds__(WG_THREADS, DP == 64 ? 3 : 2) flash_fwd_wgmma_kernel(Fwd a) {
  using L = WgSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);
  const uint32_t sQ = base;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int bb = blockIdx.x, q0 = blockIdx.y * BQ, hh = blockIdx.z;
  const int I = a.I, J = a.J, ldb = a.ldb;
  const size_t bh = (size_t)bb * a.H + hh;
  const bf16* qp = (const bf16*)a.q + bh * I * DP;
  const bf16* kp = (const bf16*)a.k + bh * J * DP;
  const bf16* vp = (const bf16*)a.v + bh * J * DP;
  const bf16* biasp = a.bias ? (const bf16*)a.bias + (size_t)hh * I * ldb : nullptr;
  const float* kmaskp = a.kmask ? a.kmask + (size_t)bb * J : nullptr;
  const float scale2 = a.scale * LOG2E;
  const float c2 = RAW ? *a.c2 : 0.f;
  const int lr0 = warp * 16 + g;  // this thread's two rows within the tile: lr0, lr0 + 8
  const int row0 = q0 + lr0, row1 = row0 + 8;

  float o[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  // running max (log2 units; c2 in RAW mode) and this thread's share of the row sums
  float m0 = RAW ? c2 : -INFINITY, m1 = m0, l0 = 0.f, l1 = 0.f;

  // K, V and the bias of tile t into stage t & 1
  auto load_stage = [&](int t) {
    const uint32_t st = base + L::tile + (t & 1) * L::stage;
    load_sw128<DP>(st, kp, t * BK, J);
    load_sw128<DP>(st + L::tile, vp, t * BK, J);
    if (biasp) load_bias(st + 2 * L::tile, biasp, ldb, q0, t * BK, I, J);
  };

  // Tile t + 1's copies are issued before tile t's products, into the stage
  // tile t - 1 left (the barrier at the end of each tile frees it), so the
  // copies of one tile run under the products and softmax of the one before.
  const int n_tiles = key_tiles(a, q0);
  if (n_tiles > 0) {
    load_sw128<DP>(sQ, qp, q0, I);
    load_stage(0);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t (and Q) have landed
    fence_proxy_async();  // visible to wgmma
    __syncthreads();

    float s[32];
    const uint32_t sK = base + L::tile + (t & 1) * L::stage;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<64, 0>(s, kmajor_desc(sQ, kk), kmajor_desc(sK, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // scores in log2 units: s * scale * log2(e) + (bias + kmask) * log2(e),
    // -inf where masked; only a tile that a key mask, causal masking or the
    // ragged edge reaches pays for the mask
    const int k0 = t * BK;
    if (biasp) {
      const uint32_t sb = base + L::tile + (t & 1) * L::stage + 2 * L::tile;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int nq = 0; nq < 2; ++nq) {
          uint32_t bv[4];  // column blocks 4 nq .. 4 nq + 3 of this thread's row lr0 + 8 half
          ldmatrix_x4(bv, sb + ((warp * 16 + half * 8 + (lane & 7)) * BIAS_LD + (nq * 4 + (lane >> 3)) * 8) * 2);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 b = bf16x2_to_float2(bv[j]);
            float* sp = s + 4 * (nq * 4 + j) + 2 * half;
            sp[0] = fmaf(sp[0], scale2, b.x * LOG2E);
            sp[1] = fmaf(sp[1], scale2, b.y * LOG2E);
          }
        }
      }
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] *= scale2;
    }
    if (kmaskp || a.causal || k0 + BK > J) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * n + 2 * c + e;
          bool ok = col < J;
          float km = 0.f;
          if (kmaskp && ok) {
            km = __ldg(kmaskp + col);
            ok = km > MASKED;
          }
          bool ok0 = ok, ok1 = ok;
          if (a.causal) {
            ok0 = ok0 && col + a.k_off <= row0 + a.q_off;
            ok1 = ok1 && col + a.k_off <= row1 + a.q_off;
          }
          s[4 * n + e] = ok0 ? fmaf(km, LOG2E, s[4 * n + e]) : -INFINITY;
          s[4 * n + 2 + e] = ok1 ? fmaf(km, LOG2E, s[4 * n + 2 + e]) : -INFINITY;
        }
      }
    }
    float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      tmax0 = fmaxf(tmax0, fmaxf(s[4 * n], s[4 * n + 1]));
      tmax1 = fmaxf(tmax1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    // the shift: the running row max (a row with no key yet shifts by 0),
    // or the ring's c2; O and the row sums are rescaled by alpha
    float sh0 = c2, sh1 = c2, al0 = 1.f, al1 = 1.f;
    if (!RAW) {
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, 1));
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, 2));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, 1));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, 2));
      const float mn0 = fmaxf(m0, tmax0), mn1 = fmaxf(m1, tmax1);
      sh0 = mn0 == -INFINITY ? 0.f : mn0;
      sh1 = mn1 == -INFINITY ? 0.f : mn1;
      al0 = ex2(m0 - sh0);
      al1 = ex2(m1 - sh1);
      m0 = mn0;
      m1 = mn1;
    }
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * n + e] = ex2(s[4 * n + e] - sh0);
        s[4 * n + 2 + e] = ex2(s[4 * n + 2 + e] - sh1);
        l0 += s[4 * n + e];
        l1 += s[4 * n + 2 + e];
      }
    }

    if (!RAW) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[4 * n] *= al0;
        o[4 * n + 1] *= al0;
        o[4 * n + 2] *= al1;
        o[4 * n + 3] *= al1;
      }
    }
    // P (bf16) as the A operand of O += P V: the accumulator's key columns
    // [16 kk, 16 kk + 16) are registers 8 kk .. 8 kk + 7, in the A layout's
    // order; V (keys x d) is an MN-major B: 16 keys (two 8-row groups, 1024 B
    // apart) from key 16 kk, the next 64 d-columns (d = 128) one swizzled
    // block (SW_BLOCK) further
    const uint32_t sV = sK + L::tile;
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s, kk);
      wgmma_rs(o, pa, mnmajor_desc(sV, kk));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    __syncthreads();  // every thread is done with stage t & 1 before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= I) continue;
    const float l = half ? l1 : l0;
    if (RAW) {
      float* op = (float*)a.out + (bh * I + row) * DP;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        *reinterpret_cast<float2*>(op + 8 * n + 2 * c) = make_float2(o[4 * n + 2 * half], o[4 * n + 2 * half + 1]);
      if (c == 0) a.lse[bh * I + row] = l;
    } else {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      bf16* op = (bf16*)a.out + (bh * I + row) * DP;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * n + 2 * c) =
            __floats2bfloat162_rn(o[4 * n + 2 * half] * inv, o[4 * n + 2 * half + 1] * inv);
      if (a.lse && c == 0)
        a.lse[bh * I + row] = l > 0.f ? ((half ? m1 : m0) + log2f(l)) * LN2 : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at d = 128 (flash_fwd_wgmma_d128): the products and softmax of
// flash_fwd_wgmma_kernel with the key terms staged in shared memory, and a
// ring of one or two stages (see the note at the top).
// ---------------------------------------------------------------------------

// Q, then STAGES stages of K, V (64 x 128 each, two swizzled 64-column
// blocks), the bias tile and the 64 key terms (f32), each stage rounded up to
// 1 KB; 1 KB to align: 59 KB with one stage (three blocks an SM), 101 KB
// with two (two blocks an SM)
template <int STAGES>
struct D128Smem {
  static constexpr int tile = BK * 128 * 2;
  static constexpr int bias = 2 * tile, kadd = bias + BQ * BIAS_LD * 2;
  static constexpr int stage = (kadd + BK * 4 + 1023) / 1024 * 1024;
  static constexpr int total = tile + STAGES * stage + 1024;
};

template <bool RAW, int STAGES>
__global__ void __launch_bounds__(WG_THREADS, STAGES == 1 ? 3 : 2) flash_fwd_wgmma_d128(Fwd a) {
  using L = D128Smem<STAGES>;
  constexpr int DP = 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));  // base, generic
  const uint32_t sQ = base;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int bb = blockIdx.x, q0 = blockIdx.y * BQ, hh = blockIdx.z;
  const int I = a.I, J = a.J, ldb = a.ldb;
  const size_t bh = (size_t)bb * a.H + hh;
  const bf16* qp = (const bf16*)a.q + bh * I * DP;
  const bf16* kp = (const bf16*)a.k + bh * J * DP;
  const bf16* vp = (const bf16*)a.v + bh * J * DP;
  const bf16* biasp = a.bias ? (const bf16*)a.bias + (size_t)hh * I * ldb : nullptr;
  const float* kmaskp = a.kmask ? a.kmask + (size_t)bb * J : nullptr;
  const float scale2 = a.scale * LOG2E;
  const float c2 = RAW ? *a.c2 : 0.f;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's two query rows

  float o[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  // running max (log2 units; c2 in RAW mode) and this thread's share of the row sums
  float m0 = RAW ? c2 : -INFINITY, m1 = m0, l0 = 0.f, l1 = 0.f;

  // K, the bias and the key mask of tile t into its stage, V with them
  // (two stages) or as a group of its own (one)
  auto stage_of = [&](int t) { return base + L::tile + (STAGES == 1 ? 0 : (t & 1) * L::stage); };
  auto load_v = [&](int t) { load_sw128<DP>(stage_of(t) + L::tile, vp, t * BK, J); };
  auto load_k = [&](int t) {
    const uint32_t st = stage_of(t);
    load_sw128<DP>(st, kp, t * BK, J);
    if (STAGES == 2) load_v(t);
    if (biasp) load_bias(st + L::bias, biasp, ldb, q0, t * BK, I, J);
    if (kmaskp && tid < BK) {
      const bool ok = t * BK + tid < J;
      cp_async4(st + L::kadd + tid * 4, ok ? kmaskp + t * BK + tid : kmaskp, ok ? 4 : 0);
    }
  };

  // Two stages: tile t + 1's copies run under tile t's products and
  // softmax, as in flash_fwd_wgmma_kernel. One stage: tile t + 1's K and
  // bias are copied while tile t's softmax and P V run, its V while tile
  // t + 1's S and softmax run. cp.async groups complete in order, so waiting
  // for all but the newest group waits for the operand needed next.
  const int n_tiles = key_tiles(a, q0);
  if (n_tiles > 0) {
    load_sw128<DP>(sQ, qp, q0, I);
    load_k(0);
    cp_async_commit();
    if (STAGES == 1) {
      load_v(0);
      cp_async_commit();
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const uint32_t sK = stage_of(t), sV = sK + L::tile, sb = sK + L::bias;
    float* const kadd_s = reinterpret_cast<float*>(gbase + (sK - base) + L::kadd);
    if (STAGES == 2) {
      if (t + 1 < n_tiles) load_k(t + 1);
      cp_async_commit();
    }
    cp_async_wait<1>();  // this thread's copies of Q, K and the bias of tile t have landed
    // a tile that a key mask or the ragged edge reaches takes each key's
    // additive term in log2 units, written by the thread that copied its
    // mask: -inf past J or where the key is hard-masked
    const bool key_terms = kmaskp || k0 + BK > J;
    if (key_terms && tid < BK) {
      const float km = kmaskp ? kadd_s[tid] : 0.f;
      kadd_s[tid] = k0 + tid < J && km > MASKED ? km * LOG2E : -INFINITY;
    }
    fence_proxy_async();  // visible to wgmma
    __syncthreads();

    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<64, 0>(s, kmajor_desc(sQ, kk), kmajor_desc(sK, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // scores in log2 units: s * scale * log2(e) + (bias + kmask) * log2(e),
    // -inf where masked; the causal mask only on a tile it reaches. KEYS
    // says whether the tile takes the key terms: one branch a tile
    auto scores = [&](auto keys) {
      constexpr bool KEYS = decltype(keys)::value;
      if (biasp) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int nq = 0; nq < 2; ++nq) {
            uint32_t bv[4];  // column blocks 4 nq .. 4 nq + 3 of this thread's row (half)
            ldmatrix_x4(bv, sb + ((warp * 16 + half * 8 + (lane & 7)) * BIAS_LD + (nq * 4 + (lane >> 3)) * 8) * 2);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 b = bf16x2_to_float2(bv[j]);
              float* sp = s + 4 * (nq * 4 + j) + 2 * half;
              if constexpr (KEYS) {
                const float2 ka = *reinterpret_cast<const float2*>(kadd_s + 8 * (nq * 4 + j) + 2 * c);
                sp[0] = fmaf(sp[0], scale2, fmaf(b.x, LOG2E, ka.x));
                sp[1] = fmaf(sp[1], scale2, fmaf(b.y, LOG2E, ka.y));
              } else {
                sp[0] = fmaf(sp[0], scale2, b.x * LOG2E);
                sp[1] = fmaf(sp[1], scale2, b.y * LOG2E);
              }
            }
          }
        }
      } else if constexpr (KEYS) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 ka = *reinterpret_cast<const float2*>(kadd_s + 8 * n + 2 * c);
          s[4 * n] = fmaf(s[4 * n], scale2, ka.x);
          s[4 * n + 1] = fmaf(s[4 * n + 1], scale2, ka.y);
          s[4 * n + 2] = fmaf(s[4 * n + 2], scale2, ka.x);
          s[4 * n + 3] = fmaf(s[4 * n + 3], scale2, ka.y);
        }
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) s[x] *= scale2;
      }
    };
    if (key_terms) scores(std::true_type{});
    else scores(std::false_type{});
    if (a.causal && k0 + BK - 1 + a.k_off > q0 + a.q_off) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * n + 2 * c + e;
          if (col + a.k_off > row0 + a.q_off) s[4 * n + e] = -INFINITY;
          if (col + a.k_off > row1 + a.q_off) s[4 * n + 2 + e] = -INFINITY;
        }
      }
    }
    if (STAGES == 1) {
      __syncthreads();  // every thread is done with K, the bias and the key terms of tile t
      if (t + 1 < n_tiles) load_k(t + 1);
      cp_async_commit();
    }

    float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      tmax0 = fmaxf(tmax0, fmaxf(s[4 * n], s[4 * n + 1]));
      tmax1 = fmaxf(tmax1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    // the shift: the running row max (a row with no key yet shifts by 0),
    // or the ring's c2; O and the row sums are rescaled by alpha
    float sh0 = c2, sh1 = c2, al0 = 1.f, al1 = 1.f;
    if (!RAW) {
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, 1));
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, 2));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, 1));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, 2));
      const float mn0 = fmaxf(m0, tmax0), mn1 = fmaxf(m1, tmax1);
      sh0 = mn0 == -INFINITY ? 0.f : mn0;
      sh1 = mn1 == -INFINITY ? 0.f : mn1;
      al0 = ex2(m0 - sh0);
      al1 = ex2(m1 - sh1);
      m0 = mn0;
      m1 = mn1;
    }
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * n + e] = ex2(s[4 * n + e] - sh0);
        s[4 * n + 2 + e] = ex2(s[4 * n + 2 + e] - sh1);
        l0 += s[4 * n + e];
        l1 += s[4 * n + 2 + e];
      }
    }
    if (!RAW) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[4 * n] *= al0;
        o[4 * n + 1] *= al0;
        o[4 * n + 2] *= al1;
        o[4 * n + 3] *= al1;
      }
    }

    if (STAGES == 1) {
      cp_async_wait<1>();  // this thread's copies of V of tile t have landed
      fence_proxy_async();
      __syncthreads();
    }
    // O += P V: P (bf16) packed in place as the A operand, V (keys x d) read
    // MN-major, the second 64 d-columns one swizzled block further
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s, kk);
      wgmma_rs(o, pa, mnmajor_desc(sV, kk));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    __syncthreads();  // every thread is done with V (and, two stages, all) of tile t
    if (STAGES == 1) {
      if (t + 1 < n_tiles) load_v(t + 1);
      cp_async_commit();
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= I) continue;
    const float l = half ? l1 : l0;
    if (RAW) {
      float* op = (float*)a.out + (bh * I + row) * DP;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        *reinterpret_cast<float2*>(op + 8 * n + 2 * c) = make_float2(o[4 * n + 2 * half], o[4 * n + 2 * half + 1]);
      if (c == 0) a.lse[bh * I + row] = l;
    } else {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      bf16* op = (bf16*)a.out + (bh * I + row) * DP;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * n + 2 * c) =
            __floats2bfloat162_rn(o[4 * n + 2 * half] * inv, o[4 * n + 2 * half + 1] * inv);
      if (a.lse && c == 0)
        a.lse[bh * I + row] = l > 0.f ? ((half ? m1 : m0) + log2f(l)) * LN2 : -INFINITY;
    }
  }
}

template <bool RAW>
cudaError_t launch_wgmma(const Fwd& a, cudaStream_t stream) {
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.out) ||
      (a.bias && (!aligned16(a.bias) || a.ldb % 8 != 0)))
    return cudaErrorMisalignedAddress;
  // the batch fastest: the blocks that share a bias tile run together
  const dim3 grid(a.B, (a.I + BQ - 1) / BQ, a.H);
  void (*kern)(Fwd) = flash_fwd_wgmma_kernel<64, RAW>;
  int smem = WgSmem<64>::total;
  if (a.D == 128) {
    // two stages while the grid fits one wave of two blocks an SM; past
    // that, one stage and three blocks an SM, so that no second wave runs
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
    }
    const bool one_stage = (long)grid.x * grid.y * grid.z > 2L * sms;
    kern = one_stage ? flash_fwd_wgmma_d128<RAW, 1> : flash_fwd_wgmma_d128<RAW, 2>;
    smem = one_stage ? D128Smem<1>::total : D128Smem<2>::total;
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, WG_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP, bool RAW>
cudaError_t launch(const Fwd& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * DP + BK * (DP + 1) + BK * DP + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, DP, RAW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.I + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool RAW>
cudaError_t dispatch_d(const Fwd& a, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32, RAW>(a, stream);
  if (a.D <= 64) return launch<T, 64, RAW>(a, stream);
  if (a.D <= 128) return launch<T, 128, RAW>(a, stream);
  return cudaErrorInvalidValue;
}

template <bool RAW>
int run(const Fwd& a, int dtype, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.I <= 0 || a.J <= 0 || a.D <= 0 || a.ldb < a.J)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return dispatch_d<float, RAW>(a, s);
  if (dtype == kBF16 && (a.D == 64 || a.D == 128)) return launch_wgmma<RAW>(a, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16, RAW>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace phenaki

// kernel 1: out (b, h, i, d) and lse (b, h, i) f32 (or null); the bias (h,
// i, ldb) is read at columns [0, j) of each row
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* kmask,
                                   void* out, void* lse, int B, int H, int I,
                                   int J, int D, int ldb, float scale, int causal,
                                   int dtype, void* stream) {
  const phenaki::Fwd a{q, k, v, bias, (const float*)kmask, nullptr, out, (float*)lse,
                       B, H, I, J, D, bias ? ldb : J, scale, causal, J - I, 0};
  return phenaki::run<false>(a, dtype, stream);
}

// kernel 3: acc (b, h, i, d) f32 and l (b, h, i) f32 of one K/V chunk; the
// bias (h, i, ldb) is read at columns [0, j) of each row; c2 is a device
// pointer to one f32
extern "C" int flash_attend_chunk_fwd(const void* q, const void* k, const void* v,
                                      const void* bias, const void* kmask, const void* c2,
                                      void* acc, void* l, int B, int H, int I, int J, int D,
                                      int ldb, float scale, int causal, int q_off, int k_off,
                                      int dtype, void* stream) {
  if (c2 == nullptr || acc == nullptr || l == nullptr) return cudaErrorInvalidValue;
  const phenaki::Fwd a{q, k, v, bias, (const float*)kmask, (const float*)c2, acc, (float*)l,
                       B, H, I, J, D, bias ? ldb : J, scale, causal, q_off, k_off};
  return phenaki::run<true>(a, dtype, stream);
}

extern "C" const char* phenaki_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
