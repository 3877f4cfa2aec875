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
// by arithmetic. bf16 at d = 64 (the flagship) runs the products on the
// tensor cores (WMMA, the *_wmma kernels), which leaves the elementwise
// recompute (an exp per score) as the larger cost. f32 and other head sizes
// run the products on the CUDA cores in f32 (bf16 inputs are widened as they
// land in shared memory), one 16 x 16 thread grid per block with 4 x 4
// score entries a thread, limited by shared-memory bandwidth (two FMAs per
// shared load). Both keep the (i, j) score and probability matrices out of
// device memory, and need no float atomics: dQ owns a query tile and loops
// over the key tiles, dK/dV owns a key tile and loops over the query tiles,
// and dBias owns a (query tile, key tile) pair and loops over the batch
// inside the block, as the TPU kernel's sequential batch axis does, so its
// sum is deterministic. wgmma with register-resident tiles is the next step.

#include <mma.h>

#include "common.cuh"

namespace phenaki {
namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256; // 16 x 16 thread grid
constexpr float MASKED = -1e29f;

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

  int num_k_tiles = (J + BK - 1) / BK;
  if (a.causal) {
    const int last_key = min(J - 1, q0 + BQ - 1 + q_offset);
    num_k_tiles = last_key < 0 ? 0 : min(num_k_tiles, last_key / BK + 1);
  }

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

  // causal: key c is seen by the query rows r >= c - (j - i)
  int first_q_tile = 0;
  if (a.causal && k0 - q_offset > 0) first_q_tile = (k0 - q_offset) / BQ;
  const int num_q_tiles = (I + BQ - 1) / BQ;

  for (int qt = first_q_tile; qt < num_q_tiles; ++qt) {
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
// bf16 at d = 64: the products on the tensor cores (WMMA 16x16x16, f32
// accumulate). Four warps a block; each owns 16 rows of the block's tile (its
// query rows for dQ and dBias, its keys for dK/dV), computes its two 16 x 64
// recompute products (S and dP, or their transposes) into f32 shared
// scratch, runs the elementwise part there (two lanes per row, on
// interleaved columns), rounds p and dS to bf16 as the TPU kernels do before
// the products that consume them, and keeps its dQ, or dK and dV,
// accumulators in WMMA fragments across the loop: unlike the forward's
// online softmax, nothing has to be rescaled.
// ---------------------------------------------------------------------------

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int WMMA_THREADS = 128;
constexpr int WD = 64;            // the head dim of the WMMA kernels
constexpr int LDT = WD + 8;       // bf16 [64][LDT] Q, K, V, dO tiles
constexpr int LDB = BK + 8;       // bf16 [.][LDB] bias tile, P and dS
constexpr int LDS = BK + 4;       // f32 [16][LDS] per-warp scratch
constexpr size_t TILE = (size_t)64 * LDT * 2;
constexpr size_t BIAS_TILE = (size_t)BQ * LDB * 2;
constexpr size_t SCRATCH = (size_t)16 * LDS * 4;
constexpr size_t HALF_TILE = (size_t)16 * LDB * 2;

using Acc = wm::fragment<wm::accumulator, 16, 16, 16, float>;

// rows [r0, r0 + 64) of a (nrows, 64) bf16 array into a [64][LDT] tile,
// zero past nrows
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int nrows) {
  constexpr int PER_ROW = WD / 8;
  for (int e = threadIdx.x; e < 64 * PER_ROW; e += WMMA_THREADS) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * WD + c);
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
  }
}

// the (query rows q0.., keys k0..) 64 x 64 bias tile into [64][LDB], zero
// past the edges
__device__ __forceinline__ void load_bias_tile(bf16* dst, const bf16* biasp, int q0, int k0, int I,
                                               int J, int ldb) {
  // 16-byte loads need an aligned base and row stride
  if (ldb % 8 == 0 && (reinterpret_cast<uintptr_t>(biasp) & 15) == 0 && k0 + BK <= J) {
    for (int e = threadIdx.x; e < BQ * BK / 8; e += WMMA_THREADS) {
      const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < I) val = *reinterpret_cast<const uint4*>(biasp + (size_t)(q0 + r) * ldb + k0 + c);
      *reinterpret_cast<uint4*>(dst + r * LDB + c) = val;
    }
  } else {
    for (int e = threadIdx.x; e < BQ * BK; e += WMMA_THREADS) {
      const int r = e / BK, c = e % BK;
      dst[r * LDB + c] = (q0 + r < I && k0 + c < J) ? biasp[(size_t)(q0 + r) * ldb + k0 + c]
                                                    : __float2bfloat16(0.f);
    }
  }
}

// S (16 x 64, f32 row-major, ld LDS) = A (16 x 64) . B (64 x 64)^T, A and B
// row-major bf16 tiles with ld LDT
__device__ __forceinline__ void mma_abt(const bf16* A, const bf16* B, float* S) {
  Acc acc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wm::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kd = 0; kd < WD; kd += 16) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
    wm::load_matrix_sync(a, A + kd, LDT);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> b;
      wm::load_matrix_sync(b, B + n * 16 * LDT + kd, LDT);
      wm::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wm::store_matrix_sync(S + n * 16, acc[n], LDS, wm::mem_row_major);
}

// O (16 x 64) += A (16 x 64, bf16 ld LDB) . B (64 x 64, bf16 row-major ld LDT)
__device__ __forceinline__ void mma_ab_acc(const bf16* A, const bf16* B, Acc (&o)[WD / 16]) {
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
    wm::load_matrix_sync(a, A + kk, LDB);
#pragma unroll
    for (int n = 0; n < WD / 16; ++n) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
      wm::load_matrix_sync(b, B + kk * LDT + n * 16, LDT);
      wm::mma_sync(o[n], a, b, o[n]);
    }
  }
}

// a warp's accumulator (16 x 64) * mult into rows [row0, row0 + 16) of a
// (nrows, 64) bf16 array, through the f32 scratch
__device__ __forceinline__ void store_rows(Acc (&o)[WD / 16], float* scratch, bf16* out, int row0,
                                           int nrows, float mult) {
  const int lane = threadIdx.x & 31, r = lane >> 1, half = lane & 1;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < WD / 16; ++n) wm::store_matrix_sync(scratch + n * 16, o[n], LDS, wm::mem_row_major);
  __syncwarp();
  if (row0 + r < nrows) {
    bf16* dst = out + (size_t)(row0 + r) * WD;
    for (int c = half; c < WD; c += 2) dst[c] = __float2bfloat16(scratch[r * LDS + c] * mult);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(WMMA_THREADS) flash_bwd_dq_wmma(Bwd a, bf16* __restrict__ dq) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw + TILE);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + 2 * TILE);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + 3 * TILE);
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw + 4 * TILE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r = lane >> 1, half = lane & 1;
  unsigned char* wbase = smem_raw + 4 * TILE + BIAS_TILE + warp * (2 * SCRATCH + HALF_TILE);
  float* Ss = reinterpret_cast<float*>(wbase);
  float* dPs = reinterpret_cast<float*>(wbase + SCRATCH);
  bf16* dSs = reinterpret_cast<bf16*>(wbase + 2 * SCRATCH);

  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, bb = blockIdx.z;
  const int I = a.I, J = a.J, q_offset = a.q_off - a.k_off;
  const size_t bh = (size_t)bb * a.H + hh;
  const bf16* biasp = a.bias ? (const bf16*)a.bias + (size_t)hh * I * a.ldb : nullptr;
  const float* kmaskp = a.kmask ? a.kmask + (size_t)bb * J : nullptr;
  load_tile(Qs, (const bf16*)a.q + bh * I * WD, q0, I);
  load_tile(dOs, (const bf16*)a.dout + bh * I * WD, q0, I);
  const int row = q0 + warp * 16 + r;
  const float lse = row < I ? a.lse[bh * I + row] : -INFINITY;
  const float delta = row < I ? a.delta[bh * I + row] : 0.f;

  Acc acc[WD / 16];
#pragma unroll
  for (int n = 0; n < WD / 16; ++n) wm::fill_fragment(acc[n], 0.f);

  int num_k_tiles = (J + BK - 1) / BK;
  if (a.causal) {
    const int last_key = min(J - 1, q0 + BQ - 1 + q_offset);
    num_k_tiles = last_key < 0 ? 0 : min(num_k_tiles, last_key / BK + 1);
  }

  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V/bias tiles
    load_tile(Ks, (const bf16*)a.k + bh * J * WD, k0, J);
    load_tile(Vs, (const bf16*)a.v + bh * J * WD, k0, J);
    if (biasp) load_bias_tile(Bs, biasp, q0, k0, I, J, a.ldb);
    __syncthreads();
    mma_abt(Qs + warp * 16 * LDT, Ks, Ss);
    mma_abt(dOs + warp * 16 * LDT, Vs, dPs);
    __syncwarp();
#pragma unroll 8
    for (int c = half; c < BK; c += 2) {
      const int col = k0 + c;
      bool valid = col < J && row < I;
      if (a.causal && col > row + q_offset) valid = false;
      float extra = biasp ? __bfloat162float(Bs[(warp * 16 + r) * LDB + c]) : 0.f;
      if (valid && kmaskp) {
        const float km = kmaskp[col];
        if (km <= MASKED) valid = false;
        extra += km;
      }
      const float p = recompute_p(Ss[r * LDS + c] * a.scale, extra, valid, lse);
      dSs[r * LDB + c] = __float2bfloat16(p * (dPs[r * LDS + c] - delta));
    }
    __syncwarp();
    mma_ab_acc(dSs, Ks, acc);  // dQ += dS . K
  }
  store_rows(acc, Ss, dq + bh * I * WD, q0 + warp * 16, I, a.scale);
}

__global__ void __launch_bounds__(WMMA_THREADS)
flash_bwd_dkv_wmma(Bwd a, bf16* __restrict__ dk, bf16* __restrict__ dv) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + TILE);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + 2 * TILE);
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw + 3 * TILE);
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw + 4 * TILE);  // [query][key]
  float* lse_s = reinterpret_cast<float*>(smem_raw + 4 * TILE + BIAS_TILE);
  float* delta_s = lse_s + BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r = lane >> 1, half = lane & 1;
  unsigned char* wbase =
      smem_raw + 4 * TILE + BIAS_TILE + 2 * BQ * 4 + warp * (2 * SCRATCH + 2 * HALF_TILE);
  float* Ss = reinterpret_cast<float*>(wbase);  // S^T: the warp's 16 keys x 64 queries
  float* dPs = reinterpret_cast<float*>(wbase + SCRATCH);
  bf16* Ps = reinterpret_cast<bf16*>(wbase + 2 * SCRATCH);
  bf16* dSs = reinterpret_cast<bf16*>(wbase + 2 * SCRATCH + HALF_TILE);

  const int k0 = blockIdx.x * BK, hh = blockIdx.y, bb = blockIdx.z;
  const int I = a.I, J = a.J, q_offset = a.q_off - a.k_off;
  const size_t bh = (size_t)bb * a.H + hh;
  const bf16* biasp = a.bias ? (const bf16*)a.bias + (size_t)hh * I * a.ldb : nullptr;
  load_tile(Ks, (const bf16*)a.k + bh * J * WD, k0, J);
  load_tile(Vs, (const bf16*)a.v + bh * J * WD, k0, J);
  const int key = k0 + warp * 16 + r;
  // the key's mask term is constant over the loop
  float km = 0.f;
  bool key_ok = key < J;
  if (key_ok && a.kmask) {
    km = a.kmask[(size_t)bb * J + key];
    if (km <= MASKED) key_ok = false;
  }

  Acc dk_acc[WD / 16], dv_acc[WD / 16];
#pragma unroll
  for (int n = 0; n < WD / 16; ++n) {
    wm::fill_fragment(dk_acc[n], 0.f);
    wm::fill_fragment(dv_acc[n], 0.f);
  }

  int first_q_tile = 0;
  if (a.causal && k0 - q_offset > 0) first_q_tile = (k0 - q_offset) / BQ;
  const int num_q_tiles = (I + BQ - 1) / BQ;

  for (int qt = first_q_tile; qt < num_q_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous Q/dO/bias tiles
    load_tile(Qs, (const bf16*)a.q + bh * I * WD, q0, I);
    load_tile(dOs, (const bf16*)a.dout + bh * I * WD, q0, I);
    if (biasp) load_bias_tile(Bs, biasp, q0, k0, I, J, a.ldb);
    for (int e = threadIdx.x; e < BQ; e += WMMA_THREADS) {
      lse_s[e] = q0 + e < I ? a.lse[bh * I + q0 + e] : -INFINITY;
      delta_s[e] = q0 + e < I ? a.delta[bh * I + q0 + e] : 0.f;
    }
    __syncthreads();
    mma_abt(Ks + warp * 16 * LDT, Qs, Ss);   // S^T = K . Q^T
    mma_abt(Vs + warp * 16 * LDT, dOs, dPs); // dP^T = V . dO^T
    __syncwarp();
#pragma unroll 8
    for (int c = half; c < BQ; c += 2) {
      const int qrow = q0 + c;
      bool valid = key_ok && qrow < I;
      if (a.causal && key > qrow + q_offset) valid = false;
      const float extra = km + (biasp ? __bfloat162float(Bs[c * LDB + warp * 16 + r]) : 0.f);
      const float p = recompute_p(Ss[r * LDS + c] * a.scale, extra, valid, lse_s[c]);
      Ps[r * LDB + c] = __float2bfloat16(p);
      dSs[r * LDB + c] = __float2bfloat16(p * (dPs[r * LDS + c] - delta_s[c]));
    }
    __syncwarp();
    mma_ab_acc(Ps, dOs, dv_acc);  // dV += P^T . dO
    mma_ab_acc(dSs, Qs, dk_acc);  // dK += dS^T . Q
  }
  store_rows(dk_acc, Ss, dk + bh * J * WD, k0 + warp * 16, J, a.scale);
  store_rows(dv_acc, Ss, dv + bh * J * WD, k0 + warp * 16, J, 1.f);
}

__global__ void __launch_bounds__(WMMA_THREADS) flash_bwd_dbias_wmma(Bwd a, float* __restrict__ dbias) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw + TILE);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + 2 * TILE);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + 3 * TILE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r = lane >> 1, half = lane & 1;
  unsigned char* wbase = smem_raw + 4 * TILE + warp * 2 * SCRATCH;
  float* Ss = reinterpret_cast<float*>(wbase);
  float* dPs = reinterpret_cast<float*>(wbase + SCRATCH);

  const int k0 = blockIdx.x * BK, q0 = blockIdx.y * BQ, hh = blockIdx.z;
  const int I = a.I, J = a.J, q_offset = a.q_off - a.k_off;
  const int row = q0 + warp * 16 + r;
  const bf16* biasp = (const bf16*)a.bias + (size_t)hh * I * a.ldb;
  // the bias is the same for every batch row: read the lane's 32 values once
  float bias_v[BK / 2], acc[BK / 2];
#pragma unroll
  for (int c = 0; c < BK / 2; ++c) {
    const int col = k0 + 2 * c + half;
    bias_v[c] = (row < I && col < J) ? __bfloat162float(biasp[(size_t)row * a.ldb + col]) : 0.f;
    acc[c] = 0.f;
  }

  const bool live = !a.causal || k0 <= q0 + BQ - 1 + q_offset;
  for (int bb = 0; live && bb < a.B; ++bb) {
    const size_t bh = (size_t)bb * a.H + hh;
    const float* kmaskp = a.kmask ? a.kmask + (size_t)bb * J : nullptr;
    __syncthreads();  // every warp is done with the previous batch row's tiles
    load_tile(Qs, (const bf16*)a.q + bh * I * WD, q0, I);
    load_tile(dOs, (const bf16*)a.dout + bh * I * WD, q0, I);
    load_tile(Ks, (const bf16*)a.k + bh * J * WD, k0, J);
    load_tile(Vs, (const bf16*)a.v + bh * J * WD, k0, J);
    __syncthreads();
    mma_abt(Qs + warp * 16 * LDT, Ks, Ss);
    mma_abt(dOs + warp * 16 * LDT, Vs, dPs);
    __syncwarp();
    const float lse = row < I ? a.lse[bh * I + row] : -INFINITY;
    const float delta = row < I ? a.delta[bh * I + row] : 0.f;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const int cl = 2 * c + half, col = k0 + cl;
      bool valid = col < J && row < I;
      if (a.causal && col > row + q_offset) valid = false;
      float extra = bias_v[c];
      if (valid && kmaskp) {
        const float km = kmaskp[col];
        if (km <= MASKED) valid = false;
        extra += km;
      }
      const float p = recompute_p(Ss[r * LDS + cl] * a.scale, extra, valid, lse);
      acc[c] = fmaf(p, dPs[r * LDS + cl] - delta, acc[c]);
    }
  }
  if (row < I) {
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const int col = k0 + 2 * c + half;
      if (col < J) dbias[((size_t)hh * I + row) * J + col] = acc[c];
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


constexpr size_t DQ_WMMA_SMEM = 4 * TILE + BIAS_TILE + 4 * (2 * SCRATCH + HALF_TILE);
constexpr size_t DKV_WMMA_SMEM = 4 * TILE + BIAS_TILE + 2 * BQ * 4 + 4 * (2 * SCRATCH + 2 * HALF_TILE);
constexpr size_t DBIAS_WMMA_SMEM = 4 * TILE + 4 * 2 * SCRATCH;

cudaError_t launch_wmma(Which which, const Bwd& a, void* o1, void* o2, cudaStream_t stream) {
  const int qt = (a.I + BQ - 1) / BQ, kt = (a.J + BK - 1) / BK;
  cudaError_t err;
  if (which == kDQ) {
    err = cudaFuncSetAttribute(flash_bwd_dq_wmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)DQ_WMMA_SMEM);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_wmma<<<dim3(qt, a.H, a.B), WMMA_THREADS, DQ_WMMA_SMEM, stream>>>(a, (bf16*)o1);
  } else if (which == kDKV) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_wmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)DKV_WMMA_SMEM);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_wmma<<<dim3(kt, a.H, a.B), WMMA_THREADS, DKV_WMMA_SMEM, stream>>>(a, (bf16*)o1,
                                                                                   (bf16*)o2);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dbias_wmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)DBIAS_WMMA_SMEM);
    if (err != cudaSuccess) return err;
    flash_bwd_dbias_wmma<<<dim3(kt, qt, a.H), WMMA_THREADS, DBIAS_WMMA_SMEM, stream>>>(a, (float*)o1);
  }
  return cudaGetLastError();
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
  if (dtype == kBF16 && D == WD) return launch_wmma(which, a, o1, o2, s);
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
// passes (j - i, 0); a ring chunk passes its global positions.
#define PHENAKI_BWD_ARGS                                                                      \
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
