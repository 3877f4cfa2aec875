// Flash-attention forward for QK-norm cosine attention on Hopper (sm_90a).
//
// Replaces the TPU kernel phenaki_tpu/ops/pallas_attention.py::_flash_kernel
// (reached from flash_qk_attention -> _flash_forward -> pl.pallas_call).
// Math contract, per (batch b, head h, query row r):
//   s[c]  = scale * q[r] . k[c] + bias[h, r, c] + kmask[b, c]
//   s[c]  = -inf where causal and c > r + (j - i)   (queries are the last i of j)
//   out[r] = softmax(s) @ v,  lse[r] = logsumexp(s)   (f32 statistics)
// An additive kmask value <= -1e29 is a hard mask (weight exactly 0). A row
// whose keys are all masked is defined as out = 0, lse = -inf, as the TPU
// kernel's max(l, 1e-37) normalisation gives.
//
// What bounds it on the H100: at the flagship shapes (d = 64, i up to 1152)
// the score and PV products are 4*i*j*d FLOPs against i*j bias bytes, so the
// kernel is bound by arithmetic, and by the online-softmax epilogue between
// the two products. The TPU design's bounded-shift softmax and ones-augmented
// V were MXU/VPU workarounds; here a standard online softmax (running max and
// sum per row) is exact and cheap. The design keeps the (i, j) score matrix
// out of device memory: one block owns one (b, h, 64-query tile) and loops
// over 64-key tiles, holding Q, the K/V (and bias) tile and the tile's
// probabilities in shared memory. bf16 at d = 64 or 128 runs both products on
// the tensor cores (WMMA, flash_fwd_wmma_kernel); f32 and other head sizes
// run them on the CUDA cores in f32 (flash_fwd_kernel). wgmma/TMA and a
// register-resident accumulator are the next steps for speed.

#include <mma.h>

#include "common.cuh"

namespace phenaki {
namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per inner tile
constexpr int THREADS = 256; // 16 x 16 thread grid
constexpr float MASKED = -1e29f;

// thread (ty, tx) owns query rows ty + 16*rr and key columns tx + 16*cc of
// every score tile, and output columns tx + 16*oc of the accumulator
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ bias,
                 const float* __restrict__ kmask, T* __restrict__ out,
                 float* __restrict__ lse, int H, int I, int J, int D,
                 float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][DP]
  float* Ks = Qs + BQ * DP;            // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);      // [BK][DP]
  float* Ps = Vs + BK * DP;            // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const size_t bh = (size_t)bb * H + hh;
  const T* qp = q + bh * I * D;
  const T* kp = k + bh * J * D;
  const T* vp = v + bh * J * D;
  const T* biasp = bias ? bias + (size_t)hh * I * J : nullptr;
  const float* kmaskp = kmask ? kmask + (size_t)bb * J : nullptr;
  const int q_offset = J - I;

  for (int e = tid; e < BQ * DP; e += THREADS) {
    int r = e / DP, c = e % DP;
    float val = 0.f;
    if (q0 + r < I && c < D) val = to_f32(qp[(size_t)(q0 + r) * D + c]) * scale;
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

  int num_k_tiles = (J + BK - 1) / BK;
  if (causal) {
    // keys past the last query row of this tile are masked for every row
    int last_key = min(J - 1, q0 + BQ - 1 + q_offset);
    num_k_tiles = min(num_k_tiles, last_key / BK + 1);
  }

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
        if (causal && col > row + q_offset) valid = false;
        float sv = s[rr][cc];
        if (valid) {
          if (biasp) sv += to_f32(biasp[(size_t)row * J + col]);
          if (kmaskp) {
            float km = kmaskp[col];
            if (km <= MASKED) valid = false;
            sv += km;
          }
        }
        s[rr][cc] = valid ? sv : -INFINITY;
        tile_max = fmaxf(tile_max, s[rr][cc]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off, 16));
      const float m_new = fmaxf(m[rr], tile_max);
      const float alpha = (m[rr] == -INFINITY) ? 0.f : expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float p = (s[rr][cc] == -INFINITY) ? 0.f : expf(s[rr][cc] - m_new);
        Ps[(ty + 16 * rr) * (BK + 1) + tx + 16 * cc] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off, 16);
      l[rr] = l[rr] * alpha + psum;
      m[rr] = m_new;
#pragma unroll
      for (int oc = 0; oc < OC; ++oc) acc[rr][oc] *= alpha;
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
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    T* op = out + (bh * I + row) * D;
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) {
      const int c = tx + 16 * oc;
      if (c < D) op[c] = from_f32<T>(acc[rr][oc] * inv);
    }
    if (lse && tx == 0)
      lse[bh * I + row] = l[rr] > 0.f ? m[rr] + logf(l[rr]) : -INFINITY;
  }
}


// ---------------------------------------------------------------------------
// bf16 at d = 64 or 128: the two products on the tensor cores (WMMA
// 16x16x16, f32 accumulate). Four warps; each owns 16 query rows of the
// block's 64, computes its 16x64 score tile into shared memory, runs the
// online softmax there (two lanes per row, on interleaved columns so that the
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

template <int DP>
__global__ void __launch_bounds__(WMMA_THREADS)
flash_fwd_wmma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ bias,
                      const float* __restrict__ kmask, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int H, int I, int J, float scale,
                      int causal) {
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
  const size_t bh = (size_t)bb * H + hh;
  const bf16* biasp = bias ? bias + (size_t)hh * I * J : nullptr;
  const float* kmaskp = kmask ? kmask + (size_t)bb * J : nullptr;
  const int q_offset = J - I;

  load_tile<DP>(Qs, q + bh * I * DP, q0, I);
  for (int e = lane; e < 16 * L::LDO; e += 32) Os[e] = 0.f;

  const int r = lane >> 1, half = lane & 1;  // two lanes per query row
  const int row = q0 + warp * 16 + r;
  float m = -INFINITY, l = 0.f;

  int num_k_tiles = (J + BK - 1) / BK;
  if (causal) {
    int last_key = min(J - 1, q0 + BQ - 1 + q_offset);
    num_k_tiles = min(num_k_tiles, last_key / BK + 1);
  }

  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V/bias tiles
    load_tile<DP>(Ks, k + bh * J * DP, k0, J);
    load_tile<DP>(Vs, v + bh * J * DP, k0, J);
    if (biasp && J % 8 == 0 && k0 + BK <= J) {
      for (int e = threadIdx.x; e < BQ * BK / 8; e += WMMA_THREADS) {
        const int br = e / (BK / 8), bc = (e % (BK / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + br < I) val = *reinterpret_cast<const uint4*>(biasp + (size_t)(q0 + br) * J + k0 + bc);
        *reinterpret_cast<uint4*>(Bs + br * L::LDB + bc) = val;
      }
    } else if (biasp) {
      for (int e = threadIdx.x; e < BQ * BK; e += WMMA_THREADS) {
        const int br = e / BK, bc = e % BK;
        const int gr = q0 + br, gc = k0 + bc;
        Bs[br * L::LDB + bc] = (gr < I && gc < J) ? biasp[(size_t)gr * J + gc] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    {  // S = Q K^T for this warp's 16 rows
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(sf[n], 0.f);
#pragma unroll
      for (int kd = 0; kd < DP; kd += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + (warp * 16) * L::LDT + kd, L::LDT);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, Ks + (n * 16) * L::LDT + kd, L::LDT);
          wmma::mma_sync(sf[n], a, b, sf[n]);
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
      if (causal && col > row + q_offset) valid = false;
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
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const float p = (sv[c] == -INFINITY) ? 0.f : expf(sv[c] - m_new);
      Ps[r * L::LDB + 2 * c + half] = __float2bfloat16(p);
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    {  // this tile's P @ V into the scratch, then O = O * alpha + P @ V
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DP / 16];
#pragma unroll
      for (int n = 0; n < DP / 16; ++n) wmma::fill_fragment(of[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + kk, L::LDB);
#pragma unroll
        for (int n = 0; n < DP / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Vs + kk * L::LDT + n * 16, L::LDT);
          wmma::mma_sync(of[n], a, b, of[n]);
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
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* op = out + (bh * I + row) * DP;
    for (int c = half; c < DP; c += 2) op[c] = __float2bfloat16(Os[r * L::LDO + c] * inv);
    if (lse && half == 0) lse[bh * I + row] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <int DP>
cudaError_t launch_wmma(const void* q, const void* k, const void* v, const void* bias,
                        const float* kmask, void* out, float* lse, int B, int H, int I,
                        int J, float scale, int causal, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = WmmaSmem<DP>::total;
  auto kern = flash_fwd_wmma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((I + BQ - 1) / BQ, H, B);
  kern<<<grid, WMMA_THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                             (const bf16*)bias, kmask, (bf16*)out, lse, H, I,
                                             J, scale, causal);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const float* kmask, void* out, float* lse,
                   int B, int H, int I, int J, int D, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * DP + BK * (DP + 1) + BK * DP + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((I + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bias, kmask, (T*)out,
      lse, H, I, J, D, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* bias, const float* kmask, void* out,
                       float* lse, int B, int H, int I, int J, int D,
                       float scale, int causal, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, bias, kmask, out, lse, B, H, I, J, D, scale, causal, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, bias, kmask, out, lse, B, H, I, J, D, scale, causal, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, bias, kmask, out, lse, B, H, I, J, D, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace phenaki

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* kmask,
                                   void* out, void* lse, int B, int H, int I,
                                   int J, int D, float scale, int causal,
                                   int dtype, void* stream) {
  using namespace phenaki;
  if (B <= 0 || H <= 0 || I <= 0 || J <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return dispatch_d<float>(q, k, v, bias, (const float*)kmask, out,
                             (float*)lse, B, H, I, J, D, scale, causal, s);
  if (dtype == kBF16 && D == 64)
    return launch_wmma<64>(q, k, v, bias, (const float*)kmask, out, (float*)lse, B, H, I, J,
                           scale, causal, s);
  if (dtype == kBF16 && D == 128)
    return launch_wmma<128>(q, k, v, bias, (const float*)kmask, out, (float*)lse, B, H, I, J,
                            scale, causal, s);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, bias, (const float*)kmask, out,
                                     (float*)lse, B, H, I, J, D, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* phenaki_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
