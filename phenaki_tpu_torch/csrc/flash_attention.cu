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
// (kernel 3). The bias is read with a row stride `ldb` (j for kernel 1), so
// kernel 3 reads its (h, i, j) column slice of the local rows' (h, i, N)
// bias in place.
//
// What bounds it on the H100: at the flagship shapes (d = 64, i up to 1152)
// the score and PV products are 4*i*j*d FLOPs against i*j bias bytes, so the
// kernel is bound by arithmetic, and by the softmax epilogue between the two
// products. The TPU design's bounded-shift softmax and ones-augmented V were
// MXU/VPU workarounds; kernel 1 uses a standard online softmax (running max
// and sum per row), which is exact and cheap. Kernel 3 keeps the bounded
// shift because it is the ring's contract (chunks add without a max), and
// returns acc and l as two tensors instead of the TPU's 128-lane
// [acc | l | 0...] block. The design keeps the (i, j) score matrix out of
// device memory: one block owns one (b, h, 64-query tile) and loops over
// 64-key tiles, holding Q, the K/V (and bias) tile and the tile's
// probabilities in shared memory. bf16 at d = 64 or 128 runs both products on
// the tensor cores (WMMA, flash_fwd_wmma_kernel); f32 and other head sizes
// run them on the CUDA cores in f32 (flash_fwd_kernel). Both kernels take
// the chunk mode as the template flag RAW. wgmma/TMA and a register-resident
// accumulator are the next steps for speed.

#include <mma.h>

#include "common.cuh"

namespace phenaki {
namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per inner tile
constexpr int THREADS = 256; // 16 x 16 thread grid
constexpr float MASKED = -1e29f;
constexpr float LOG2E = 1.4426950408889634f;

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
// bf16 at d = 64 or 128: the two products on the tensor cores (WMMA
// 16x16x16, f32 accumulate). Four warps; each owns 16 query rows of the
// block's 64, computes its 16x64 score tile into shared memory, runs the
// softmax there (two lanes per row, on interleaved columns so that the
// shared-memory accesses do not collide on banks), rounds the probabilities to bf16
// (as the plain version does before its PV product) and accumulates P @ V
// into an f32 output tile in shared memory.
// ---------------------------------------------------------------------------

constexpr int WMMA_THREADS = 128;

template <int DP>
struct WmmaSmem {
  static constexpr int LDT = DP + 8;                  // bf16 Q, K, V tiles
  static constexpr int LDB = BK + 8;                  // bf16 bias tile and P
  static constexpr int LDS = (DP > BK ? DP : BK) + 4;  // f32 scores / PV scratch
  static constexpr int LDO = DP + 2;                  // f32 output accumulator
  static constexpr size_t tile = (size_t)BK * LDT * 2;
  static constexpr size_t bias = (size_t)BQ * LDB * 2;
  static constexpr size_t warp_s = (size_t)16 * LDS * 4;
  static constexpr size_t warp_p = (size_t)16 * LDB * 2;
  static constexpr size_t warp_o = (size_t)16 * LDO * 4;
  static constexpr size_t per_warp = warp_s + warp_p + warp_o;
  static constexpr size_t total = 3 * tile + bias + 4 * per_warp;
};

// rows [r0, r0 + 64) of a (nrows, DP) bf16 array into a padded smem tile,
// zero past nrows
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int nrows) {
  constexpr int PER_ROW = DP / 8;
  for (int e = threadIdx.x; e < BK * PER_ROW; e += WMMA_THREADS) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DP + c);
    *reinterpret_cast<uint4*>(dst + r * WmmaSmem<DP>::LDT + c) = val;
  }
}

template <int DP, bool RAW>
__global__ void __launch_bounds__(WMMA_THREADS) flash_fwd_wmma_kernel(Fwd a) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  using L = WmmaSmem<DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L::tile);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + 2 * L::tile);
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw + 3 * L::tile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wbase = smem_raw + 3 * L::tile + L::bias + warp * L::per_warp;
  float* Ss = reinterpret_cast<float*>(wbase);
  bf16* Ps = reinterpret_cast<bf16*>(wbase + L::warp_s);
  float* Os = reinterpret_cast<float*>(wbase + L::warp_s + L::warp_p);

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int I = a.I, J = a.J, ldb = a.ldb;
  const float scale = a.scale;
  const size_t bh = (size_t)bb * a.H + hh;
  const bf16* biasp = a.bias ? (const bf16*)a.bias + (size_t)hh * I * ldb : nullptr;
  const float* kmaskp = a.kmask ? a.kmask + (size_t)bb * J : nullptr;
  const float c2 = RAW ? *a.c2 : 0.f;
  // 16-byte bias loads need an aligned base and row stride
  const bool bias_vec = biasp && ldb % 8 == 0 && (reinterpret_cast<uintptr_t>(biasp) & 15) == 0;

  load_tile<DP>(Qs, (const bf16*)a.q + bh * I * DP, q0, I);
  for (int e = lane; e < 16 * L::LDO; e += 32) Os[e] = 0.f;

  const int r = lane >> 1, half = lane & 1;  // two lanes per query row
  const int row = q0 + warp * 16 + r;
  float m = -INFINITY, l = 0.f;

  const int num_k_tiles = key_tiles(a, q0);
  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V/bias tiles
    load_tile<DP>(Ks, (const bf16*)a.k + bh * J * DP, k0, J);
    load_tile<DP>(Vs, (const bf16*)a.v + bh * J * DP, k0, J);
    if (bias_vec && k0 + BK <= J) {
      for (int e = threadIdx.x; e < BQ * BK / 8; e += WMMA_THREADS) {
        const int br = e / (BK / 8), bc = (e % (BK / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + br < I) val = *reinterpret_cast<const uint4*>(biasp + (size_t)(q0 + br) * ldb + k0 + bc);
        *reinterpret_cast<uint4*>(Bs + br * L::LDB + bc) = val;
      }
    } else if (biasp) {
      for (int e = threadIdx.x; e < BQ * BK; e += WMMA_THREADS) {
        const int br = e / BK, bc = e % BK;
        const int gr = q0 + br, gc = k0 + bc;
        Bs[br * L::LDB + bc] = (gr < I && gc < J) ? biasp[(size_t)gr * ldb + gc] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    {  // S = Q K^T for this warp's 16 rows
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(sf[n], 0.f);
#pragma unroll
      for (int kd = 0; kd < DP; kd += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Qs + (warp * 16) * L::LDT + kd, L::LDT);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Ks + (n * 16) * L::LDT + kd, L::LDT);
          wmma::mma_sync(sf[n], fa, fb, sf[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(Ss + n * 16, sf[n], L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    float sv[BK / 2];
    float tile_max = -INFINITY;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const int cl = 2 * c + half;
      const int col = k0 + cl;
      bool valid = col < J && row < I;
      if (a.causal && col + a.k_off > row + a.q_off) valid = false;
      float x = Ss[r * L::LDS + cl] * scale;
      if (valid) {
        if (biasp) x += __bfloat162float(Bs[(warp * 16 + r) * L::LDB + cl]);
        if (kmaskp) {
          const float km = kmaskp[col];
          if (km <= MASKED) valid = false;
          x += km;
        }
      }
      sv[c] = valid ? x : -INFINITY;
      tile_max = fmaxf(tile_max, sv[c]);
    }
    float alpha = 1.f, m_new = 0.f;
    if (!RAW) {
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      m_new = fmaxf(m, tile_max);
      alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    }
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      float p;
      if (RAW)
        p = (sv[c] == -INFINITY) ? 0.f : exp2f(sv[c] * LOG2E - c2);
      else
        p = (sv[c] == -INFINITY) ? 0.f : expf(sv[c] - m_new);
      Ps[r * L::LDB + 2 * c + half] = __float2bfloat16(p);
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    if (!RAW) m = m_new;
    __syncwarp();

    {  // this tile's P @ V into the scratch, then O = O * alpha + P @ V
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DP / 16];
#pragma unroll
      for (int n = 0; n < DP / 16; ++n) wmma::fill_fragment(of[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Ps + kk, L::LDB);
#pragma unroll
        for (int n = 0; n < DP / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Vs + kk * L::LDT + n * 16, L::LDT);
          wmma::mma_sync(of[n], fa, fb, of[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < DP / 16; ++n)
        wmma::store_matrix_sync(Ss + n * 16, of[n], L::LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll 8
    for (int c = half; c < DP; c += 2)
      Os[r * L::LDO + c] = Os[r * L::LDO + c] * alpha + Ss[r * L::LDS + c];
    __syncwarp();  // Ss is overwritten by the next tile's scores
  }

  if (row < I) {
    if (RAW) {
      float* op = (float*)a.out + (bh * I + row) * DP;
      for (int c = half; c < DP; c += 2) op[c] = Os[r * L::LDO + c];
      if (half == 0) a.lse[bh * I + row] = l;
    } else {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      bf16* op = (bf16*)a.out + (bh * I + row) * DP;
      for (int c = half; c < DP; c += 2) op[c] = __float2bfloat16(Os[r * L::LDO + c] * inv);
      if (a.lse && half == 0) a.lse[bh * I + row] = l > 0.f ? m + logf(l) : -INFINITY;
    }
  }
}

template <int DP, bool RAW>
cudaError_t launch_wmma(const Fwd& a, cudaStream_t stream) {
  const size_t smem = WmmaSmem<DP>::total;
  auto kern = flash_fwd_wmma_kernel<DP, RAW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.I + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, WMMA_THREADS, smem, stream>>>(a);
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
  if (dtype == kBF16 && a.D == 64) return launch_wmma<64, RAW>(a, s);
  if (dtype == kBF16 && a.D == 128) return launch_wmma<128, RAW>(a, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16, RAW>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace phenaki

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* kmask,
                                   void* out, void* lse, int B, int H, int I,
                                   int J, int D, float scale, int causal,
                                   int dtype, void* stream) {
  const phenaki::Fwd a{q, k, v, bias, (const float*)kmask, nullptr, out, (float*)lse,
                       B, H, I, J, D, J, scale, causal, J - I, 0};
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
