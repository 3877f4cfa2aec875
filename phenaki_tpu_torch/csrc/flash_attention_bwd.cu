// Flash-attention backward for QK-norm cosine attention on Hopper (sm_90a):
// three kernels, dQ, dK/dV and dBias.
//
// Replace the TPU kernels of phenaki_tpu/ops/pallas_attention.py
// (_bwd_dq_kernel, _bwd_dkv_kernel, _bwd_dbias_kernel, reached from
// flash_qk_attention's and flash_attend_chunk's custom VJPs ->
// _flash_backward -> pl.pallas_call).
// Math contract, per (batch b, head h), with the forward's saved f32
// lse (b, h, i) and delta = rowsum(dO * O) (b, h, i) computed by the wrapper:
//   s[r, c]  = scale * q[r] . k[c] + bias[h, r, c] + kmask[b, c]
//   p[r, c]  = exp(s[r, c] - lse[r]), 0 where causal and c + k_off > r + q_off
//              (q_off = j - i, k_off = 0 over one sequence; a ring chunk's
//              global positions otherwise),
//              where kmask[b, c] <= -1e29 (a hard mask), past the ragged
//              edge, and on a row with lse = -inf (no unmasked key: the
//              forward defines out = 0 there, so every gradient is 0)
//   dS[r, c] = p[r, c] * (dO[r] . v[c] - delta[r])
//   dQ = scale * dS @ K,  dK = scale * dS^T @ Q,  dV = p^T @ dO,
//   dBias[h] = sum_b dS (f32).
// A ring chunk (kernel 3's raw acc = sum p v, l = sum p with p = 2^(s log2e
// - c2)) rides the same kernels with lse = c2 ln 2, dO = d(acc) and
// delta = -d(l): then dS = p * (dO . v + d(l)) is exactly the gradient of
// the unnormalised sums. The bias is read with a row stride (ldb), so a
// chunk's column slice of its rows' (h, i, N) bias needs no copy.
//
// What bounds it on the H100: the backward recomputes the scores, so every
// (64 x 64) tile pair costs two d-deep products (Q K^T, dO V^T) before the
// one or two products that accumulate a gradient: at d = 64 that is ~2.5x
// the forward's arithmetic against the same bytes, so the kernels are bound
// by arithmetic, and between the products sits an exp per score.
//
// bf16 on wgmma: dQ, dK/dV and dBias at d = 64 and 128
// (flash_bwd_dq_wgmma<64|128>, flash_bwd_dkv_wgmma<64|128>,
// flash_bwd_dbias_wgmma<64|128>).
// The forward's design: one warpgroup a block, wgmma m64nNk16 for every
// product, the scores never in shared memory.
//  - dQ owns 64 query rows: Q and dO stay in shared memory; K, V, the
//    (query x key) bias tile and the keys' mask terms stream through a
//    two-stage ring of cp.async copies (tile t + 1 lands while tile t
//    computes). S = Q K^T and dP = dO V^T come from shared memory into
//    registers; the epilogue runs there (scale with log2(e) folded in, the
//    bias by ldmatrix in the accumulator layout, the key terms, -inf past
//    the ragged edge or on a hard-masked key, read per column from shared
//    memory, the causal mask only on tiles it reaches, ex2 against the
//    row's lse); dS = p (dP - delta) is packed to bf16 in place as the
//    register A operand of dQ += dS K, with K read MN-major from the same
//    swizzled tile that was S's K-major B. At d = 128 the same loop takes 8
//    k-steps for S and dP, Q and dO stay as 64 x 128 tiles (two swizzled
//    64-column blocks), and dQ is one m64n128 accumulator (64 registers a
//    thread; 254 in all, no spill). Q, dO and two stages of K, V and the
//    bias would take 117 KB, one block an SM, and the train shape's 288
//    blocks would run in three waves; with one bias buffer, refilled once
//    every thread has read it (one more barrier a tile), they take 108 KB,
//    two blocks an SM, and it measured faster at the self and the cross
//    shape on the H100.
//  - dK/dV owns 64 keys: K and V stay in shared memory; Q, dO, the bias
//    tile, lse and delta stream through the ring. S^T = K Q^T and dP^T = V
//    dO^T put the keys on the accumulator rows, so the key mask is one
//    constant a row; the bias tile arrives transposed by ldmatrix.trans;
//    lse and delta are read per column from shared memory. P^T and dS^T are
//    packed in place as the A operands of dV += P^T dO and dK += dS^T Q (dO
//    and Q read MN-major).
//    At d = 64 registers stay at or under 168 a thread and shared memory is
//    69 KB a block, so three blocks fit an SM. At d = 128 registers bound
//    it: dK and dV for 64 keys x 128 columns are two m64n128 f32
//    accumulators, 128 registers a thread before S^T and dP^T (64 more);
//    K, V and two stages of Q, dO and the bias take 117 KB. So one 128-thread
//    block an SM (__launch_bounds__(128, 1): 255 registers, no spill), the
//    same loop with 8 k-steps for S^T and dP^T and m64n128 products for dK
//    and dV. A design with dV and dK on two warpgroups of one block (P^T
//    handed from the first to the second through 16 KB of shared memory and
//    a named barrier) needed fewer registers, with no spill either, but ran
//    slower at both main-path shapes on the H100: its warpgroups wait on
//    each other every tile, and one warpgroup issues all four products back
//    to back.
//  - dBias (flash_bwd_dbias_wgmma) owns a (64 query x 64 key) tile of one
//    head and loops over the batch inside the block, in order: S and dP as
//    in dQ, into registers; the bias tile, the same for every batch row, is
//    read once by ldmatrix into registers in the accumulator layout; per
//    batch row the epilogue adds p (dP - delta) into an f32 accumulator in
//    registers. Row b + 1's Q, dO, K, V, key mask, lse and delta arrive by
//    cp.async (two stages) while row b computes. The f32 tile goes out
//    through shared memory in whole rows, 16-byte stores where j % 4 == 0:
//    the 42 MB output at the flagship train shape is half the bound's bytes.
//    67 KB of shared memory, three blocks an SM. At d = 128 the two
//    recompute products take 8 k-steps: each batch row streams as two
//    64-column halves of d through the same ring (a stage of 64 x 128 tiles
//    would take 64 KB and leave one block an SM), S and dP sum over the
//    halves and the epilogue runs after the second; the register cap (three
//    blocks an SM), the shared memory and the grid stay those of d = 64.
// f32, and bf16 at head sizes other than 64 and 128, run the products on the
// CUDA cores in f32 (bf16 inputs are widened as they land in shared memory),
// one 16 x 16 thread grid per block with 4 x 4 score entries a thread: bound
// by the f32 rate, far below the tensor cores'; no main path runs them.
// Every kernel keeps the (i, j) score and probability
// matrices out of device memory, and none needs float atomics: dQ owns a
// query tile and loops over the key tiles, dK/dV owns a key tile and loops
// over the query tiles, and dBias owns a (query tile, key tile) pair and
// loops over the batch inside the block, as the TPU kernel's sequential
// batch axis does, so every sum is taken in a fixed order.

#include <type_traits>

#include "wgmma.cuh"

namespace phenaki {
namespace {

constexpr int THREADS = 256; // 16 x 16 thread grid

// the additive terms of a score (bias + kmask) and whether the entry takes
// part in the softmax at all
template <typename T>
__device__ __forceinline__ bool score_terms(const T* biasp, const float* kmaskp, int row,
                                            int col, int I, int J, int ldb, int q_offset,
                                            int causal, float* extra) {
  bool valid = row < I && col < J;
  if (causal && col > row + q_offset) valid = false;
  float e = 0.f;
  if (valid) {
    if (biasp) e += to_f32(biasp[(size_t)row * ldb + col]);
    if (kmaskp) {
      const float km = kmaskp[col];
      if (km <= MASKED) valid = false;
      e += km;
    }
  }
  *extra = e;
  return valid;
}

__device__ __forceinline__ float recompute_p(float s, float extra, bool valid, float lse) {
  return (valid && lse != -INFINITY) ? expf(s + extra - lse) : 0.f;
}

// rows [r0, r0 + rows) of a (nrows, D) array into a [rows][DP + 1] f32 tile,
// zero past nrows and past D
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int rows, int nrows,
                                          int D) {
  for (int e = threadIdx.x; e < rows * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    float val = 0.f;
    if (r0 + r < nrows && c < D) val = to_f32(src[(size_t)(r0 + r) * D + c]);
    dst[r * (DP + 1) + c] = val;
  }
}

// s = A_rows . B_cols and dp = C_rows . E_cols over the head dim, for the
// thread's 4 x 4 (row ty + 16 rr, column tx + 16 cc) entries
template <int DP>
__device__ __forceinline__ void two_products(const float* A, const float* Bm, const float* C,
                                             const float* E, float s[4][4], float dp[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) s[rr][cc] = dp[rr][cc] = 0.f;
#pragma unroll 4
  for (int x = 0; x < DP; ++x) {
    float a[4], b[4], c[4], e[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      a[rr] = A[(ty + 16 * rr) * (DP + 1) + x];
      c[rr] = C[(ty + 16 * rr) * (DP + 1) + x];
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      b[cc] = Bm[(tx + 16 * cc) * (DP + 1) + x];
      e[cc] = E[(tx + 16 * cc) * (DP + 1) + x];
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        s[rr][cc] = fmaf(a[rr], b[cc], s[rr][cc]);
        dp[rr][cc] = fmaf(c[rr], e[cc], dp[rr][cc]);
      }
  }
}

struct Bwd {
  const void *q, *k, *v, *bias;
  const float* kmask;
  const void* dout;
  const float *lse, *delta;
  int B, H, I, J, D;
  int ldb;  // the bias's row stride (j, or N for a column slice of (h, i, N))
  float scale;
  int causal, q_off, k_off;  // causal iff col + k_off <= row + q_off
};

// the key tiles a query tile [q0, q0 + 64) must visit (causal: none past its
// last row), and the first query tile a key tile [k0, k0 + 64) is seen by
__device__ __forceinline__ int key_tiles(const Bwd& a, int q0) {
  int n = (a.J + BK - 1) / BK;
  if (a.causal) {
    const int last_key = min(a.J - 1, q0 + BQ - 1 + a.q_off - a.k_off);
    n = last_key < 0 ? 0 : min(n, last_key / BK + 1);
  }
  return n;
}
__device__ __forceinline__ int first_query_tile(const Bwd& a, int k0) {
  const int first_row = k0 - (a.q_off - a.k_off);
  return a.causal && first_row > 0 ? first_row / BQ : 0;
}

// ---- dQ: one block per (query tile, h, b), a loop over the key tiles ----
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Bwd a, T* __restrict__ dq) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][DP + 1]
  float* dOs = Qs + BQ * (DP + 1);    // [BQ][DP + 1]
  float* Ks = dOs + BQ * (DP + 1);    // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);     // [BK][DP + 1]
  float* dSs = Vs + BK * (DP + 1);    // [BQ][BK + 1]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, bb = blockIdx.z;
  const int I = a.I, J = a.J, D = a.D, q_offset = a.q_off - a.k_off;
  const size_t bh = (size_t)bb * a.H + hh;
  const T* kp = (const T*)a.k + bh * J * D;
  const T* vp = (const T*)a.v + bh * J * D;
  const T* biasp = a.bias ? (const T*)a.bias + (size_t)hh * I * a.ldb : nullptr;
  const float* kmaskp = a.kmask ? a.kmask + (size_t)bb * J : nullptr;

  load_rows<T, DP>(Qs, (const T*)a.q + bh * I * D, q0, BQ, I, D);
  load_rows<T, DP>(dOs, (const T*)a.dout + bh * I * D, q0, BQ, I, D);
  float lse[4], delta[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + ty + 16 * rr;
    lse[rr] = row < I ? a.lse[bh * I + row] : -INFINITY;
    delta[rr] = row < I ? a.delta[bh * I + row] : 0.f;
  }

  constexpr int OC = DP / 16;
  float acc[4][OC];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) acc[rr][oc] = 0.f;

  const int num_k_tiles = key_tiles(a, q0);
  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/dSs are consumed
    load_rows<T, DP>(Ks, kp, k0, BK, J, D);
    load_rows<T, DP>(Vs, vp, k0, BK, J, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<DP>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int row = q0 + ty + 16 * rr, col = k0 + tx + 16 * cc;
        float extra;
        const bool valid = score_terms(biasp, kmaskp, row, col, I, J, a.ldb, q_offset, a.causal, &extra);
        const float p = recompute_p(s[rr][cc] * a.scale, extra, valid, lse[rr]);
        dSs[(ty + 16 * rr) * (BK + 1) + tx + 16 * cc] = p * (dp[rr][cc] - delta[rr]);
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kb[OC];
#pragma unroll
      for (int oc = 0; oc < OC; ++oc) kb[oc] = Ks[c * (DP + 1) + tx + 16 * oc];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float ds = dSs[(ty + 16 * rr) * (BK + 1) + c];
#pragma unroll
        for (int oc = 0; oc < OC; ++oc) acc[rr][oc] = fmaf(ds, kb[oc], acc[rr][oc]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + ty + 16 * rr;
    if (row >= I) continue;
    T* out = dq + (bh * I + row) * D;
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) {
      const int c = tx + 16 * oc;
      if (c < D) out[c] = from_f32<T>(acc[rr][oc] * a.scale);
    }
  }
}

// ---- dK/dV: one block per (key tile, h, b), a loop over the query tiles ----
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(Bwd a, T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ float smem[];
  float* Ks = smem;                   // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);     // [BK][DP + 1]
  float* Qs = Vs + BK * (DP + 1);     // [BQ][DP + 1]
  float* dOs = Qs + BQ * (DP + 1);    // [BQ][DP + 1]
  float* Ps = dOs + BQ * (DP + 1);    // [BQ][BK + 1]
  float* dSs = Ps + BQ * (BK + 1);    // [BQ][BK + 1]
  float* lse_s = dSs + BQ * (BK + 1); // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, hh = blockIdx.y, bb = blockIdx.z;
  const int I = a.I, J = a.J, D = a.D, q_offset = a.q_off - a.k_off;
  const size_t bh = (size_t)bb * a.H + hh;
  const T* qp = (const T*)a.q + bh * I * D;
  const T* dop = (const T*)a.dout + bh * I * D;
  const T* biasp = a.bias ? (const T*)a.bias + (size_t)hh * I * a.ldb : nullptr;
  const float* kmaskp = a.kmask ? a.kmask + (size_t)bb * J : nullptr;

  load_rows<T, DP>(Ks, (const T*)a.k + bh * J * D, k0, BK, J, D);
  load_rows<T, DP>(Vs, (const T*)a.v + bh * J * D, k0, BK, J, D);

  constexpr int OC = DP / 16;
  float dk_acc[4][OC], dv_acc[4][OC];  // key rows ty + 16 rr, columns tx + 16 oc
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) dk_acc[rr][oc] = dv_acc[rr][oc] = 0.f;

  const int num_q_tiles = (I + BQ - 1) / BQ;
  for (int qt = first_query_tile(a, k0); qt < num_q_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs are consumed
    load_rows<T, DP>(Qs, qp, q0, BQ, I, D);
    load_rows<T, DP>(dOs, dop, q0, BQ, I, D);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const int row = q0 + r;
      lse_s[r] = row < I ? a.lse[bh * I + row] : -INFINITY;
      delta_s[r] = row < I ? a.delta[bh * I + row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // query rows ty + 16 rr, keys tx + 16 cc
    two_products<DP>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = ty + 16 * rr;
      const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = tx + 16 * cc;
        float extra;
        const bool valid =
            score_terms(biasp, kmaskp, q0 + r, k0 + c, I, J, a.ldb, q_offset, a.causal, &extra);
        const float p = recompute_p(s[rr][cc] * a.scale, extra, valid, lse);
        Ps[r * (BK + 1) + c] = p;
        dSs[r * (BK + 1) + c] = p * (dp[rr][cc] - delta);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float od[OC], qd[OC];
#pragma unroll
      for (int oc = 0; oc < OC; ++oc) {
        od[oc] = dOs[r * (DP + 1) + tx + 16 * oc];
        qd[oc] = Qs[r * (DP + 1) + tx + 16 * oc];
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float p = Ps[r * (BK + 1) + ty + 16 * rr];
        const float ds = dSs[r * (BK + 1) + ty + 16 * rr];
#pragma unroll
        for (int oc = 0; oc < OC; ++oc) {
          dv_acc[rr][oc] = fmaf(p, od[oc], dv_acc[rr][oc]);
          dk_acc[rr][oc] = fmaf(ds, qd[oc], dk_acc[rr][oc]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int key = k0 + ty + 16 * rr;
    if (key >= J) continue;
    T* dko = dk + (bh * J + key) * D;
    T* dvo = dv + (bh * J + key) * D;
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) {
      const int c = tx + 16 * oc;
      if (c < D) {
        dko[c] = from_f32<T>(dk_acc[rr][oc] * a.scale);
        dvo[c] = from_f32<T>(dv_acc[rr][oc]);
      }
    }
  }
}

// ---- dBias: one block per (key tile, query tile, h), a loop over b ----
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dbias_kernel(Bwd a, float* __restrict__ dbias) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][DP + 1]
  float* dOs = Qs + BQ * (DP + 1);    // [BQ][DP + 1]
  float* Ks = dOs + BQ * (DP + 1);    // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);     // [BK][DP + 1]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, q0 = blockIdx.y * BQ, hh = blockIdx.z;
  const int I = a.I, J = a.J, D = a.D, q_offset = a.q_off - a.k_off;
  const T* biasp = (const T*)a.bias + (size_t)hh * I * a.ldb;

  float acc[4][4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[rr][cc] = 0.f;

  // a tile wholly above the causal diagonal has dBias = 0
  const bool live = !a.causal || k0 <= q0 + BQ - 1 + q_offset;
  for (int bb = 0; live && bb < a.B; ++bb) {
    const size_t bh = (size_t)bb * a.H + hh;
    const float* kmaskp = a.kmask ? a.kmask + (size_t)bb * J : nullptr;
    __syncthreads();  // the previous batch row's tiles are consumed
    load_rows<T, DP>(Qs, (const T*)a.q + bh * I * D, q0, BQ, I, D);
    load_rows<T, DP>(dOs, (const T*)a.dout + bh * I * D, q0, BQ, I, D);
    load_rows<T, DP>(Ks, (const T*)a.k + bh * J * D, k0, BK, J, D);
    load_rows<T, DP>(Vs, (const T*)a.v + bh * J * D, k0, BK, J, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<DP>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int row = q0 + ty + 16 * rr;
      const float lse = row < I ? a.lse[bh * I + row] : -INFINITY;
      const float delta = row < I ? a.delta[bh * I + row] : 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = k0 + tx + 16 * cc;
        float extra;
        const bool valid = score_terms(biasp, kmaskp, row, col, I, J, a.ldb, q_offset, a.causal, &extra);
        const float p = recompute_p(s[rr][cc] * a.scale, extra, valid, lse);
        acc[rr][cc] = fmaf(p, dp[rr][cc] - delta, acc[rr][cc]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + ty + 16 * rr;
    if (row >= I) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = k0 + tx + 16 * cc;
      if (col < J) dbias[((size_t)hh * I + row) * J + col] = acc[rr][cc];
    }
  }
}


// ---------------------------------------------------------------------------
// bf16, kernels 4 and 5 (d = 64 and 128): wgmma with S and dP in
// registers (see the note at the top; the accumulator layout and the helpers
// are in wgmma.cuh). One warpgroup a block. Every tile is 64 rows; the operand
// tiles sit in shared memory in the 128-byte swizzle, so each one is read
// by wgmma K-major (as the B of a recompute product) or MN-major (as the B
// of an accumulating product) through the same layout.
// ---------------------------------------------------------------------------

constexpr int WD = 64;                     // the head dim of the tensor-core kernels
constexpr int WG_TILE = BK * WD * 2;       // one 64 x 64 bf16 tile: 8 KB
constexpr int WG_BIAS = BQ * BIAS_LD * 2;  // one 64 x 64 bias tile, padded rows: 9 KB

// Q and dO (dQ at d = 64), or K and V (dK/dV), resident, then two stages of
// the streamed operand pair, the bias tile and 64 f32 terms a column (dQ:
// each key's mask term; dK/dV: each query row's lse, then its delta), each
// stage rounded up to 1 KB so its tiles stay on the swizzle grid; 1 KB to
// align: 69 KB at d = 64, 117 KB at d = 128
template <int DP>
struct WgSmem {
  static constexpr int tile = BK * DP * 2;  // 64 rows of DP bf16
  static constexpr int stats = 2 * tile + WG_BIAS;
  static constexpr int stage = (stats + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int total = 2 * tile + 2 * stage + 1024;
};

// lse in log2 units for p = 2^(s log2(e) - lse log2(e)); +inf on a row past
// I or with no unmasked key (lse = -inf), where p must be 0
__device__ __forceinline__ float lse_log2(float lse, bool row_ok) {
  return row_ok && lse != -INFINITY ? lse * LOG2E : INFINITY;
}

// dQ at d = 128: Q and dO, two stages of K, V and the key terms, then one
// bias tile, refilled once every thread has read it; 1 KB to align: 108 KB,
// two blocks an SM
struct DqSmem128 {
  static constexpr int tile = BK * 128 * 2;
  static constexpr int stats = 2 * tile;
  static constexpr int stage = (stats + BK * 4 + 1023) / 1024 * 1024;
  static constexpr int bias = 2 * tile + 2 * stage;
  static constexpr int total = bias + WG_BIAS + 1024;
};

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, DP == WD ? 3 : 2)
flash_bwd_dq_wgmma(Bwd a, bf16* __restrict__ dq) {
  constexpr bool ONE_BIAS = DP == 128;  // one bias buffer (DqSmem128), or one a stage (WgSmem)
  using L = std::conditional_t<ONE_BIAS, DqSmem128, WgSmem<DP>>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);
  const uint32_t sQ = base, sdO = base + L::tile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int bb = blockIdx.x, q0 = blockIdx.y * BQ, hh = blockIdx.z;
  const int I = a.I, J = a.J, ldb = a.ldb;
  const size_t bh = (size_t)bb * a.H + hh;
  const bf16* kp = (const bf16*)a.k + bh * J * DP;
  const bf16* vp = (const bf16*)a.v + bh * J * DP;
  const bf16* biasp = a.bias ? (const bf16*)a.bias + (size_t)hh * I * ldb : nullptr;
  const float* kmaskp = a.kmask ? a.kmask + (size_t)bb * J : nullptr;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));  // base, generic
  const int tid = threadIdx.x;
  const float scale2 = a.scale * LOG2E;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's two query rows
  const float ls0 = lse_log2(row0 < I ? a.lse[bh * I + row0] : 0.f, row0 < I);
  const float ls1 = lse_log2(row1 < I ? a.lse[bh * I + row1] : 0.f, row1 < I);
  const float dl0 = row0 < I ? a.delta[bh * I + row0] : 0.f;
  const float dl1 = row1 < I ? a.delta[bh * I + row1] : 0.f;

  float acc[DP / 2];  // dQ / scale
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) acc[x] = 0.f;

  // K, V, the key mask and (one bias tile a stage) the bias of key tile t
  // into stage t & 1
  auto load_stage = [&](int t) {
    const int k0 = t * BK;
    const uint32_t st = base + 2 * L::tile + (t & 1) * L::stage;
    load_sw128<DP>(st, kp, k0, J);
    load_sw128<DP>(st + L::tile, vp, k0, J);
    if (biasp && !ONE_BIAS) load_bias(st + 2 * L::tile, biasp, ldb, q0, k0, I, J);
    if (kmaskp && tid < BK) {
      const bool ok = k0 + tid < J;
      cp_async4(st + L::stats + tid * 4, ok ? kmaskp + k0 + tid : kmaskp, ok ? 4 : 0);
    }
  };

  // tile t + 1's copies run under tile t's products, as in the forward; with
  // one bias buffer tile t + 1's bias is copied, a group of its own, once
  // tile t's has been read, and lands under tile t's dQ product
  const int n_tiles = key_tiles(a, q0);
  if (n_tiles > 0) {
    load_sw128<DP>(sQ, (const bf16*)a.q + bh * I * DP, q0, I);
    load_sw128<DP>(sdO, (const bf16*)a.dout + bh * I * DP, q0, I);
    load_stage(0);
    if constexpr (ONE_BIAS) {
      if (biasp) load_bias(base + L::bias, biasp, ldb, q0, 0, I, J);
    }
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t (and Q, dO) have landed
    // each key's additive term in log2 units, written by the thread that
    // copied its mask: -inf past J or where the key is hard-masked
    const int k0 = t * BK;
    const int st_off = 2 * L::tile + (t & 1) * L::stage;
    float* kadd_s = reinterpret_cast<float*>(gbase + st_off + L::stats);
    if (tid < BK) {
      const float km = kmaskp ? kadd_s[tid] : 0.f;
      kadd_s[tid] = k0 + tid < J && km > MASKED ? km * LOG2E : -INFINITY;
    }
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T and dP = dO V^T, K and V read K-major
    const uint32_t sK = base + st_off, sV = sK + L::tile;
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<64, 0>(s, kmajor_desc(sQ, kk), kmajor_desc(sK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<64, 0>(dp, kmajor_desc(sdO, kk), kmajor_desc(sV, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // scores in log2 units: s scale log2(e) + (bias + kmask) log2(e), -inf
    // where masked; the causal mask only on a tile it reaches
    float2 ka[8];  // the key terms of this thread's columns 8 n + 2 c, + 1
#pragma unroll
    for (int n = 0; n < 8; ++n) ka[n] = *reinterpret_cast<const float2*>(kadd_s + 8 * n + 2 * c);
    if (biasp) {
      uint32_t sb;
      if constexpr (ONE_BIAS) sb = base + L::bias;
      else sb = sK + 2 * L::tile;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int nq = 0; nq < 2; ++nq) {
          uint32_t bv[4];  // column blocks 4 nq .. 4 nq + 3 of this thread's row (half)
          ldmatrix_x4(bv, sb + ((warp * 16 + half * 8 + (lane & 7)) * BIAS_LD + (nq * 4 + (lane >> 3)) * 8) * 2);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 b = bf16x2_to_float2(bv[j]);
            const float2 k2 = ka[nq * 4 + j];
            float* sp = s + 4 * (nq * 4 + j) + 2 * half;
            sp[0] = fmaf(sp[0], scale2, fmaf(b.x, LOG2E, k2.x));
            sp[1] = fmaf(sp[1], scale2, fmaf(b.y, LOG2E, k2.y));
          }
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[4 * n] = fmaf(s[4 * n], scale2, ka[n].x);
        s[4 * n + 1] = fmaf(s[4 * n + 1], scale2, ka[n].y);
        s[4 * n + 2] = fmaf(s[4 * n + 2], scale2, ka[n].x);
        s[4 * n + 3] = fmaf(s[4 * n + 3], scale2, ka[n].y);
      }
    }
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
    if constexpr (ONE_BIAS) {
      __syncthreads();  // every thread has read the bias tile
      if (biasp && t + 1 < n_tiles) load_bias(base + L::bias, biasp, ldb, q0, k0 + BK, I, J);
      cp_async_commit();
    }
    // dS = p (dP - delta), in place of dP
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * n + e] = ex2(s[4 * n + e] - ls0) * (dp[4 * n + e] - dl0);
        dp[4 * n + 2 + e] = ex2(s[4 * n + 2 + e] - ls1) * (dp[4 * n + 2 + e] - dl1);
      }
    }

    // dQ += dS K: dS (bf16) packed in place as the A operand, K (keys x d)
    // read MN-major
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      pack_a(da, dp, kk);
      wgmma_rs(acc, da, mnmajor_desc(sK, kk));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every thread is done with stage t & 1 before it is refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= I) continue;
    bf16* op = dq + (bh * I + row) * DP;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * n + 2 * c) =
          __floats2bfloat162_rn(acc[4 * n + 2 * half] * a.scale, acc[4 * n + 2 * half + 1] * a.scale);
  }
}

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, DP == WD ? 3 : 1)
flash_bwd_dkv_wgmma(Bwd a, bf16* __restrict__ dk, bf16* __restrict__ dv) {
  using L = WgSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));  // base, generic
  const uint32_t sK = base, sV = base + L::tile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int bb = blockIdx.x, k0 = blockIdx.y * BK, hh = blockIdx.z;
  const int I = a.I, J = a.J, ldb = a.ldb;
  const size_t bh = (size_t)bb * a.H + hh;
  const bf16* qp = (const bf16*)a.q + bh * I * DP;
  const bf16* dop = (const bf16*)a.dout + bh * I * DP;
  const float* lsep = a.lse + bh * I;
  const float* deltap = a.delta + bh * I;
  const bf16* biasp = a.bias ? (const bf16*)a.bias + (size_t)hh * I * ldb : nullptr;
  const float scale2 = a.scale * LOG2E;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;  // this thread's two keys
  // each key's own term, constant over the loop: its kmask in log2 units,
  // -inf past J or where the key is hard-masked
  float kadd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key1 : key0;
    float km = 0.f;
    bool ok = key < J;
    if (ok && a.kmask) {
      km = a.kmask[(size_t)bb * J + key];
      ok = km > MASKED;
    }
    kadd[half] = ok ? km * LOG2E : -INFINITY;
  }

  float dk_acc[DP / 2], dv_acc[DP / 2];  // dK / scale, dV
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;

  // Q, dO, the bias, lse and delta of query tile t into stage t & 1
  auto load_stage = [&](int t) {
    const int q0 = t * BQ;
    const uint32_t st = base + 2 * L::tile + (t & 1) * L::stage;
    load_sw128<DP>(st, qp, q0, I);
    load_sw128<DP>(st + L::tile, dop, q0, I);
    if (biasp) load_bias(st + 2 * L::tile, biasp, ldb, q0, k0, I, J);
    const int r = tid & (BQ - 1);
    const float* src = tid < BQ ? lsep : deltap;
    const bool ok = q0 + r < I;
    cp_async4(st + L::stats + tid * 4, ok ? src + q0 + r : src, ok ? 4 : 0);
  };

  const int first = first_query_tile(a, k0), n_tiles = (I + BQ - 1) / BQ;
  if (first < n_tiles) {
    load_sw128<DP>(sK, (const bf16*)a.k + bh * J * DP, k0, J);
    load_sw128<DP>(sV, (const bf16*)a.v + bh * J * DP, k0, J);
    load_stage(first);
    cp_async_commit();
  }
  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    const int st_off = 2 * L::tile + (t & 1) * L::stage;
    if (t + 1 < n_tiles) load_stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    // the thread that copied a row's lse turns it into lse_log2 for all
    float* lse_s = reinterpret_cast<float*>(gbase + st_off + L::stats);
    const float* delta_s = lse_s + BQ;
    if (tid < BQ) lse_s[tid] = lse_log2(lse_s[tid], q0 + tid < I);
    fence_proxy_async();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T (keys x queries), Q and dO read K-major
    const uint32_t sQ = base + st_off, sdO = sQ + L::tile;
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<64, 0>(s, kmajor_desc(sK, kk), kmajor_desc(sQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<64, 0>(dp, kmajor_desc(sV, kk), kmajor_desc(sdO, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // scores in log2 units: the bias tile (query rows x keys) arrives
    // transposed, in the accumulator layout, by ldmatrix.trans
    if (biasp) {
      const uint32_t sb = sQ + 2 * L::tile;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int nq = 0; nq < 2; ++nq) {
          uint32_t bv[4];  // query blocks 4 nq .. 4 nq + 3 of this thread's key (half)
          ldmatrix_x4_trans(bv, sb + ((8 * (nq * 4 + (lane >> 3)) + (lane & 7)) * BIAS_LD + warp * 16 + half * 8) * 2);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 b = bf16x2_to_float2(bv[j]);
            float* sp = s + 4 * (nq * 4 + j) + 2 * half;
            sp[0] = fmaf(sp[0], scale2, fmaf(b.x, LOG2E, kadd[half]));
            sp[1] = fmaf(sp[1], scale2, fmaf(b.y, LOG2E, kadd[half]));
          }
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int x = 0; x < 4; ++x) s[4 * n + x] = fmaf(s[4 * n + x], scale2, kadd[x >> 1]);
      }
    }
    if (a.causal && k0 + BK - 1 + a.k_off > q0 + a.q_off) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qrow = q0 + 8 * n + 2 * c + e;
          if (key0 + a.k_off > qrow + a.q_off) s[4 * n + e] = -INFINITY;
          if (key1 + a.k_off > qrow + a.q_off) s[4 * n + 2 + e] = -INFINITY;
        }
      }
    }
    // P^T = 2^(s - lse) in place of S^T, dS^T = P^T (dP^T - delta) in place of dP^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * c);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* sp = s + 4 * n + 2 * half;
        float* dpp = dp + 4 * n + 2 * half;
        sp[0] = ex2(sp[0] - ls.x);
        sp[1] = ex2(sp[1] - ls.y);
        dpp[0] = sp[0] * (dpp[0] - dl.x);
        dpp[1] = sp[1] * (dpp[1] - dl.y);
      }
    }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T (bf16) packed in place as
    // the A operands, dO and Q (queries x d) read MN-major
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s, kk);
      wgmma_rs(dv_acc, pa, mnmajor_desc(sdO, kk));
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t da[4];
      pack_a(da, dp, kk);
      wgmma_rs(dk_acc, da, mnmajor_desc(sQ, kk));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // every thread is done with stage t & 1 before it is refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key1 : key0;
    if (key >= J) continue;
    bf16* dko = dk + (bh * J + key) * DP;
    bf16* dvo = dv + (bh * J + key) * DP;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const float* kx = dk_acc + 4 * n + 2 * half;
      const float* vx = dv_acc + 4 * n + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(dko + 8 * n + 2 * c) =
          __floats2bfloat162_rn(kx[0] * a.scale, kx[1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvo + 8 * n + 2 * c) = __floats2bfloat162_rn(vx[0], vx[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at d = 64 and 128, kernel 6 (dBias): B4's products and epilogue with
// one warpgroup a block and the batch loop inside it (see the note at the
// top); at d = 128 each batch row streams as two 64-column halves of d
// ---------------------------------------------------------------------------

// two stages of a batch row's Q, dO (the block's query tile), K, V (its key
// tile), 64 columns of d each, then 64 f32 terms each of the keys' mask, the
// rows' lse and their delta, each stage rounded up to 1 KB; 1 KB to align:
// 67 KB, three blocks an SM, at d = 64 and 128. The bias tile passes through
// stage 1 before the loop, the f32 output tile through stage 0 after it.
struct DbSmem {
  static constexpr int stats = 4 * WG_TILE;
  static constexpr int stage = (stats + 3 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int total = 2 * stage + 1024;
  static constexpr int out_ld = BK + 8;  // f32 output rows: float2 stores of a half warp hit 32 banks
  static_assert(BQ * out_ld * 4 <= stage && BQ * BIAS_LD * 2 <= stage, "a stage holds the bias and the output");
};

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 3)
flash_bwd_dbias_wgmma(Bwd a, float* __restrict__ dbias) {
  constexpr int NH = DP / WD;  // the 64-column parts of d a batch row streams in
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));  // base, generic

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int k0 = blockIdx.x * BK, q0 = blockIdx.y * BQ, hh = blockIdx.z;
  const int I = a.I, J = a.J, ldb = a.ldb;
  const bf16* biasp = (const bf16*)a.bias + (size_t)hh * I * ldb;
  const float scale2 = a.scale * LOG2E;
  const int r0 = warp * 16 + g;                       // this thread's first row in the tile
  const int row0 = q0 + r0, row1 = row0 + 8;          // and its two query rows
  // a tile wholly above the causal diagonal has dBias = 0; one that the
  // diagonal cuts takes the mask entry by entry
  const bool live = !a.causal || k0 + a.k_off <= q0 + BQ - 1 + a.q_off;
  const bool cut = a.causal && k0 + BK - 1 + a.k_off > q0 + a.q_off;

  float acc[32];  // dBias, summed over the batch in order
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.f;

  // step u = NH b + h: columns [64 h, 64 h + 64) of batch row b's Q, dO, K
  // and V into stage u & 1, with the last part its key mask, lse and delta
  auto load_stage = [&](int u) {
    const int bb = u / NH, dc = (u % NH) * WD;
    const size_t bh = (size_t)bb * a.H + hh;
    const uint32_t st = base + (u & 1) * DbSmem::stage;
    load_sw128<WD>(st, (const bf16*)a.q + bh * I * DP + dc, q0, I, DP);
    load_sw128<WD>(st + WG_TILE, (const bf16*)a.dout + bh * I * DP + dc, q0, I, DP);
    load_sw128<WD>(st + 2 * WG_TILE, (const bf16*)a.k + bh * J * DP + dc, k0, J, DP);
    load_sw128<WD>(st + 3 * WG_TILE, (const bf16*)a.v + bh * J * DP + dc, k0, J, DP);
    if (u % NH != NH - 1) return;
    const uint32_t stats = st + DbSmem::stats;
    if (tid < BK) {
      const bool ok = a.kmask && k0 + tid < J;
      cp_async4(stats + tid * 4, ok ? a.kmask + (size_t)bb * J + k0 + tid : a.lse, ok ? 4 : 0);
    }
    const int r = tid & (BQ - 1);  // thread r copies row r's lse, thread 64 + r its delta
    const float* src = (tid < BQ ? a.lse : a.delta) + bh * I;
    const bool ok = q0 + r < I;
    cp_async4(stats + (BK + tid) * 4, ok ? src + q0 + r : src, ok ? 4 : 0);
  };

  if (live) {
    // the bias tile, the same for every batch row: through stage 1 into
    // registers, bf16 pairs in the accumulator layout (ldmatrix), once
    load_bias(base + DbSmem::stage, biasp, ldb, q0, k0, I, J);
    load_stage(0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    uint32_t bv[2][2][4];  // [row half][column quarter nq][block j]: column block 4 nq + j
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int nq = 0; nq < 2; ++nq)
        ldmatrix_x4(bv[half][nq], base + DbSmem::stage +
                                      ((warp * 16 + half * 8 + (lane & 7)) * BIAS_LD + (nq * 4 + (lane >> 3)) * 8) * 2);
    __syncthreads();  // every thread has its bias before stage 1 is refilled

    // step u + 1's copies run under step u's products; S and dP sum over the
    // NH parts of a batch row, and the epilogue runs after its last
    float s[32], dp[32];
    for (int u = 0; u < NH * a.B; ++u) {
      const bool last = u % NH == NH - 1;
      if (u + 1 < NH * a.B) load_stage(u + 1);
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of step u have landed
      // the thread that copied them turns key tid's mask into its additive
      // term in log2 units (-inf past J or where the key is hard-masked) and
      // row tid's lse into lse_log2
      const int st_off = (u & 1) * DbSmem::stage;
      float* kadd_s = reinterpret_cast<float*>(gbase + st_off + DbSmem::stats);
      float* lse_s = kadd_s + BK;
      const float* delta_s = lse_s + BQ;
      if (last && tid < BK) {
        const float km = a.kmask ? kadd_s[tid] : 0.f;
        kadd_s[tid] = k0 + tid < J && km > MASKED ? km * LOG2E : -INFINITY;
        lse_s[tid] = lse_log2(lse_s[tid], q0 + tid < I);
      }
      fence_proxy_async();
      __syncthreads();

      // S = Q K^T and dP = dO V^T, K and V read K-major
      const uint32_t sQ = base + st_off, sdO = sQ + WG_TILE, sK = sQ + 2 * WG_TILE, sV = sQ + 3 * WG_TILE;
      const bool sum = u % NH > 0;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WD / 16; ++kk) wgmma_ss<64, 0>(s, kmajor_desc(sQ, kk), kmajor_desc(sK, kk), sum || kk > 0);
#pragma unroll
      for (int kk = 0; kk < WD / 16; ++kk) wgmma_ss<64, 0>(dp, kmajor_desc(sdO, kk), kmajor_desc(sV, kk), sum || kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (!last) {
        __syncthreads();  // every thread is done with stage u & 1 before it is refilled
        continue;
      }

      // p = 2^(s scale log2(e) + (bias + kmask) log2(e) - lse log2(e)), 0
      // where masked; acc += p (dP - delta)
      const float ls[2] = {lse_s[r0], lse_s[r0 + 8]};
      const float dl[2] = {delta_s[r0], delta_s[r0 + 8]};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 ka = *reinterpret_cast<const float2*>(kadd_s + 8 * n + 2 * c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 b = bf16x2_to_float2(bv[half][n >> 2][n & 3]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * n + 2 * half + e;
            float t = fmaf(s[x], scale2, fmaf(e ? b.y : b.x, LOG2E, e ? ka.y : ka.x));
            if (cut && k0 + 8 * n + 2 * c + e + a.k_off > (half ? row1 : row0) + a.q_off) t = -INFINITY;
            acc[x] = fmaf(ex2(t - ls[half]), dp[x] - dl[half], acc[x]);
          }
        }
      }
      __syncthreads();  // every thread is done with stage u & 1 before it is refilled
    }
  }
  cp_async_wait<0>();

  // the (64 x 64) f32 tile through stage 0, out in whole rows: 16-byte
  // stores where the rows keep 16-byte alignment (J % 4 == 0), else 4-byte
  float* out_s = reinterpret_cast<float*>(gbase);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(out_s + (r0 + 8 * half) * DbSmem::out_ld + 8 * n + 2 * c) =
          make_float2(acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
  __syncthreads();
  float* dst = dbias + ((size_t)hh * I + q0) * J + k0;
  if ((J & 3) == 0) {
#pragma unroll
    for (int it = 0; it < BQ * BK / 4 / WG_THREADS; ++it) {
      const int e = tid + it * WG_THREADS, r = e >> 4, col = (e & 15) * 4;
      if (q0 + r < I && k0 + col < J)
        *reinterpret_cast<float4*>(dst + (size_t)r * J + col) =
            *reinterpret_cast<const float4*>(out_s + r * DbSmem::out_ld + col);
    }
  } else {
    for (int e = tid; e < BQ * BK; e += WG_THREADS) {
      const int r = e >> 6, col = e & 63;
      if (q0 + r < I && k0 + col < J) dst[(size_t)r * J + col] = out_s[r * DbSmem::out_ld + col];
    }
  }
}

template <int DP>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BQ * (DP + 1) + 2 * BK * (DP + 1) + BQ * (BK + 1));
}
template <int DP>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * BK * (DP + 1) + 2 * BQ * (DP + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}
template <int DP>
constexpr size_t dbias_smem() {
  return sizeof(float) * (2 * BQ * (DP + 1) + 2 * BK * (DP + 1));
}

enum Which { kDQ, kDKV, kDBias };

template <typename... Out>
cudaError_t launch_wgmma(void (*kernel)(Bwd, Out...), dim3 grid, int threads, int smem, cudaStream_t stream,
                         const Bwd& a, Out... out) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a, out...);
  return cudaGetLastError();
}

// bf16 on wgmma: dQ, dK/dV and dBias at d = 64 and 128. The dQ and dK/dV
// grids run the batch fastest, so the blocks that share a bias tile run
// together (as the forward's); dBias loops over the batch inside the block,
// its grid (key tiles, query tiles, heads).
cudaError_t launch_tensor_cores(Which which, const Bwd& a, void* o1, void* o2, cudaStream_t stream) {
  const int qt = (a.I + BQ - 1) / BQ, kt = (a.J + BK - 1) / BK;
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.dout) ||
      (a.bias && (!aligned16(a.bias) || a.ldb % 8 != 0)) || (which == kDBias && !aligned16(o1)))
    return cudaErrorMisalignedAddress;
  const bool d64 = a.D == WD;
  if (which == kDBias)
    return launch_wgmma(d64 ? flash_bwd_dbias_wgmma<WD> : flash_bwd_dbias_wgmma<128>, dim3(kt, qt, a.H),
                        WG_THREADS, DbSmem::total, stream, a, (float*)o1);
  if (which == kDQ)
    return launch_wgmma(d64 ? flash_bwd_dq_wgmma<WD> : flash_bwd_dq_wgmma<128>, dim3(a.B, qt, a.H), WG_THREADS,
                        d64 ? WgSmem<WD>::total : DqSmem128::total, stream, a, (bf16*)o1);
  return launch_wgmma(d64 ? flash_bwd_dkv_wgmma<WD> : flash_bwd_dkv_wgmma<128>, dim3(a.B, kt, a.H),
                      WG_THREADS, d64 ? WgSmem<WD>::total : WgSmem<128>::total, stream, a, (bf16*)o1,
                      (bf16*)o2);
}

template <typename T, int DP>
cudaError_t launch(Which which, const Bwd& a, void* o1, void* o2, cudaStream_t stream) {
  const int qt = (a.I + BQ - 1) / BQ, kt = (a.J + BK - 1) / BK;
  cudaError_t err;
  if (which == kDQ) {
    auto kern = flash_bwd_dq_kernel<T, DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem<DP>());
    if (err != cudaSuccess) return err;
    kern<<<dim3(qt, a.H, a.B), THREADS, dq_smem<DP>(), stream>>>(a, (T*)o1);
  } else if (which == kDKV) {
    auto kern = flash_bwd_dkv_kernel<T, DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem<DP>());
    if (err != cudaSuccess) return err;
    kern<<<dim3(kt, a.H, a.B), THREADS, dkv_smem<DP>(), stream>>>(a, (T*)o1, (T*)o2);
  } else {
    auto kern = flash_bwd_dbias_kernel<T, DP>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dbias_smem<DP>());
    if (err != cudaSuccess) return err;
    kern<<<dim3(kt, qt, a.H), THREADS, dbias_smem<DP>(), stream>>>(a, (float*)o1);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which which, const Bwd& a, void* o1, void* o2, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32>(which, a, o1, o2, stream);
  if (a.D <= 64) return launch<T, 64>(which, a, o1, o2, stream);
  if (a.D <= 128) return launch<T, 128>(which, a, o1, o2, stream);
  return cudaErrorInvalidValue;
}

int run(Which which, const void* q, const void* k, const void* v, const void* bias,
        const void* kmask, const void* dout, const void* lse, const void* delta, void* o1,
        void* o2, int B, int H, int I, int J, int D, int ldb, float scale, int causal, int q_off,
        int k_off, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || I <= 0 || J <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (which == kDBias && bias == nullptr) return cudaErrorInvalidValue;
  if (bias == nullptr) ldb = J;
  if (ldb < J) return cudaErrorInvalidValue;
  const Bwd a{q, k, v, bias, (const float*)kmask, dout, (const float*)lse, (const float*)delta,
              B, H, I, J, D, ldb, scale, causal, q_off, k_off};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return dispatch_d<float>(which, a, o1, o2, s);
  // bf16 at d = 64 and 128 on wgmma; other head sizes on the CUDA cores
  if (dtype == kBF16 && (D == WD || D == 128))
    return launch_tensor_cores(which, a, o1, o2, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(which, a, o1, o2, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace phenaki

// The three entries share one argument list: q, k, v (b, h, i|j, d), bias
// (h, i, ldb) read at columns [0, j) or null, kmask (b, j) f32 or null, dO,
// lse and delta (b, h, i) f32, the outputs, then the sizes, the bias row
// stride, scale, causal and the causal offsets (q_off, k_off): key c is seen
// by row r iff c + k_off <= r + q_off. Attention over one whole sequence
// passes (j - i, 0); a ring chunk passes its global positions. In bf16 at
// d = 64 and 128 each entry returns cudaErrorMisalignedAddress unless q, k,
// v, dO, the bias (and dbias) start on a 16-byte boundary and ldb is a
// multiple of 8.
#define PHENAKI_BWD_ARGS                                                                     \
  const void *q, const void *k, const void *v, const void *bias, const void *kmask,          \
      const void *dout, const void *lse, const void *delta
#define PHENAKI_BWD_SIZES                                                                     \
  int B, int H, int I, int J, int D, int ldb, float scale, int causal, int q_off, int k_off, \
      int dtype, void *stream

extern "C" int flash_attention_bwd_dq(PHENAKI_BWD_ARGS, void* dq, PHENAKI_BWD_SIZES) {
  return phenaki::run(phenaki::kDQ, q, k, v, bias, kmask, dout, lse, delta, dq, nullptr, B, H, I,
                      J, D, ldb, scale, causal, q_off, k_off, dtype, stream);
}

extern "C" int flash_attention_bwd_dkv(PHENAKI_BWD_ARGS, void* dk, void* dv, PHENAKI_BWD_SIZES) {
  return phenaki::run(phenaki::kDKV, q, k, v, bias, kmask, dout, lse, delta, dk, dv, B, H, I, J,
                      D, ldb, scale, causal, q_off, k_off, dtype, stream);
}

extern "C" int flash_attention_bwd_dbias(PHENAKI_BWD_ARGS, void* dbias, PHENAKI_BWD_SIZES) {
  return phenaki::run(phenaki::kDBias, q, k, v, bias, kmask, dout, lse, delta, dbias, nullptr, B,
                      H, I, J, D, ldb, scale, causal, q_off, k_off, dtype, stream);
}
