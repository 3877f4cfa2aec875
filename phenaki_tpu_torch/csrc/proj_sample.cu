// Fused vocab projection + tempered gumbel sampling + re-mask score on
// Hopper (sm_90a).
//
// Replaces the TPU kernel phenaki_tpu/ops/pallas_sampling.py::_proj_kernel
// (reached from project_gumbel_sample_with_score -> pl.pallas_call). Per row
// r of h (rows, d) over the vocab V:
//   logits = h[r] @ W^T + bias                 (W is the (V, d) Linear weight)
//   u      = (philox_bits >> 8) * 2^-24        or the injected noise[r, v]
//   g      = -log(-log(u + 1e-10) + 1e-10)
//   y      = logits / max(T, 1e-10) + g
//   id     = argmax y   (ties -> lowest id, like jnp.argmax)
//   score  = 1 - exp(logits[id] - max logits) / sum exp(logits - max)
// The (rows, V) logits never reach device memory.
//
// What bounds it on the H100: the product is 2*rows*d*V FLOPs (77 GFLOP per
// flagship step at b = 1) against one 64 MB read of W, so it is bound by the
// tensor cores, then by the per-logit transcendentals of the epilogue. The
// TPU kernel carried its running statistics across a sequential vocab grid
// axis; Hopper blocks run in no order, so the design is two passes:
//   1. proj_partials_kernel: each block owns a 64-column vocab chunk, copies
//      that chunk of W into shared memory once, and walks over every 64-row
//      tile of h (h is small and stays in L2). A tile's logits come from
//      bf16 WMMA (16x16x16, f32 accumulate) into shared memory; one warp per
//      row then folds the tile into five partials per (row, chunk): best y,
//      its id, the logit at that id, the max logit and the sum-exp. Where
//      the chunk's (64, D) slice of W does not fit shared memory (D > 768),
//      the block stages it 512 columns of d at a time for every row tile and
//      accumulates the tile's logits across the slices.
//   2. proj_merge_kernel: one warp per row merges the chunk partials with
//      the same (y desc, id asc) order, so ties go to the lowest id, and the
//      online max/sum-exp rule.
// The noise is Philox-4x32-10 keyed by the seed with counter (v / 4, row),
// so a sample does not depend on the tiling.

#include <mma.h>

#include "common.cuh"

namespace phenaki {
namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int RT = 64;        // rows per tile of h
constexpr int VC = 64;        // vocab columns per block
constexpr int THREADS = 256;  // 8 warps
constexpr int NPART = 5;      // best y, id bits, chosen logit, max, sum-exp

__device__ __forceinline__ void better_of(float& y, int& id, float& ch,
                                          float oy, int oid, float och) {
  if (oy > y || (oy == y && oid < id)) {
    y = oy;
    id = oid;
    ch = och;
  }
}

__device__ __forceinline__ void merge_lse(float& m, float& se, float om, float ose) {
  const float mn = fmaxf(m, om);
  if (mn == -INFINITY) return;
  const float a = (m == -INFINITY) ? 0.f : se * expf(m - mn);
  const float b = (om == -INFINITY) ? 0.f : ose * expf(om - mn);
  se = a + b;
  m = mn;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

constexpr int MAX_RESIDENT_D = 768;  // all of d of a W chunk in shared memory (f32: 197 KB)
constexpr int SLICE = 512;            // d columns a staged slice holds beyond that

// d columns of the staged W chunk: all of D, or a slice
__host__ __device__ constexpr int staged_d(int D) { return D <= MAX_RESIDENT_D ? D : SLICE; }

// shared-memory row stride of the W chunk: padded so that the tile loads
// spread over the banks (a multiple of 8 elements for WMMA)
template <typename T>
__host__ __device__ constexpr int w_stride(int DC) {
  return sizeof(T) == 2 ? DC + 8 : DC + 1;
}

// bytes of the W chunk, rounded up to 128 so that Ls stays aligned for WMMA
template <typename T>
__host__ __device__ constexpr size_t w_bytes(int DC) {
  return ((size_t)VC * w_stride<T>(DC) * sizeof(T) + 127) / 128 * 128;
}

// Ws[r][c] = w[v0 + r][c0 + c] for the chunk's VC rows, K columns of d
template <typename T>
__device__ __forceinline__ void stage_w(T* Ws, int ldw, const T* __restrict__ w, int v0, int c0,
                                        int K, int D) {
  for (int e = threadIdx.x; e < VC * K; e += THREADS) {
    const int r = e / K, c = e % K;
    Ws[r * ldw + c] = w[(size_t)(v0 + r) * D + c0 + c];
  }
}

// a tile's logits h[r0 : r0 + RT] @ Ws^T, accumulated over slices of d
template <typename T>
struct TileLogits;

// bf16 on the tensor cores: warp w owns 16-row group w / 2 and two
// 16-column groups
template <>
struct TileLogits<bf16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;

  __device__ __forceinline__ void zero() {
    wmma::fill_fragment(c0, 0.f);
    wmma::fill_fragment(c1, 0.f);
  }

  // += h[r0 : r0 + RT, col0 : col0 + K] @ Ws[:, :K]^T; h has row stride D
  __device__ __forceinline__ void add(const bf16* h, const bf16* Ws, int r0, int col0, int K,
                                      int D, int ldw) {
    const int warp = threadIdx.x >> 5;
    const int rw = warp >> 1, cw0 = (warp & 1) * 2;
    const bf16* ha = h + (size_t)(r0 + rw * 16) * D + col0;
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b0, b1;
      wmma::load_matrix_sync(a, ha + k0, D);
      wmma::load_matrix_sync(b0, Ws + (cw0 * 16) * ldw + k0, ldw);
      wmma::load_matrix_sync(b1, Ws + ((cw0 + 1) * 16) * ldw + k0, ldw);
      wmma::mma_sync(c0, a, b0, c0);
      wmma::mma_sync(c1, a, b1, c1);
    }
  }

  __device__ __forceinline__ void store(float* Ls) const {
    const int warp = threadIdx.x >> 5;
    const int rw = warp >> 1, cw0 = (warp & 1) * 2;
    wmma::store_matrix_sync(Ls + (rw * 16) * VC + cw0 * 16, c0, VC, wmma::mem_row_major);
    wmma::store_matrix_sync(Ls + (rw * 16) * VC + (cw0 + 1) * 16, c1, VC, wmma::mem_row_major);
  }
};

// f32 on the CUDA cores (f32 inputs make the card checks exact): thread t
// owns columns t % 16 + 16 c of rows t / 16 + 16 r
template <>
struct TileLogits<float> {
  float acc[4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[rr][cc] = 0.f;
  }

  __device__ __forceinline__ void add(const float* h, const float* Ws, int r0, int col0, int K,
                                      int D, int ldw) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    for (int k = 0; k < K; ++k) {
      float hv[4], wv[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) hv[rr] = h[(size_t)(r0 + ty + 16 * rr) * D + col0 + k];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) wv[cc] = Ws[(tx + 16 * cc) * ldw + k];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[rr][cc] = fmaf(hv[rr], wv[cc], acc[rr][cc]);
    }
  }

  __device__ __forceinline__ void store(float* Ls) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) Ls[(ty + 16 * rr) * VC + tx + 16 * cc] = acc[rr][cc];
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
proj_partials_kernel(const T* __restrict__ h, const T* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ noise,
                     float* __restrict__ partials, int rows, int rows_pad,
                     int D, int V, float inv_temp, uint2 key) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DC = staged_d(D);
  const int ldw = w_stride<T>(DC);
  T* Ws = reinterpret_cast<T*>(smem_raw);                           // [VC][ldw]
  float* Ls = reinterpret_cast<float*>(smem_raw + w_bytes<T>(DC));  // [RT][VC]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int chunk = blockIdx.x;
  const int nchunks = V / VC;
  const int v0 = chunk * VC;
  const bool resident = DC == D;

  // this block's W chunk: VC contiguous rows of the (V, D) weight, all of d
  // once, or slice by slice for every row tile below
  if (resident) stage_w(Ws, ldw, w, v0, 0, D, D);

  for (int r0 = 0; r0 < rows_pad; r0 += RT) {
    TileLogits<T> tile;
    tile.zero();
    for (int c0 = 0; c0 < D; c0 += DC) {
      const int K = min(DC, D - c0);
      if (!resident || r0 == 0) {
        __syncthreads();  // the last slice's readers of Ws are done
        if (!resident) stage_w(Ws, ldw, w, v0, c0, K, D);
        __syncthreads();
      }
      tile.add(h, Ws, r0, c0, K, D, ldw);
    }
    __syncthreads();  // the previous tile's epilogue has read Ls
    tile.store(Ls);
    __syncthreads();

    for (int rl = warp * 8; rl < warp * 8 + 8; ++rl) {
      const int row = r0 + rl;
      if (row >= rows) break;  // warp-uniform
      const int c = lane * 2;
      const int gcol = v0 + c;
      float lg[2] = {Ls[rl * VC + c], Ls[rl * VC + c + 1]};
      if (bias) {
        lg[0] += bias[gcol];
        lg[1] += bias[gcol + 1];
      }
      float u[2];
      if (noise) {
        u[0] = noise[(size_t)row * V + gcol];
        u[1] = noise[(size_t)row * V + gcol + 1];
      } else {
        const uint4 bits = philox4x32_10(
            make_uint4((uint32_t)(gcol >> 2), (uint32_t)row, 0u, 0u), key);
        const bool lo = (gcol & 3) == 0;  // gcol is even: words (x,y) or (z,w)
        u[0] = uniform24(lo ? bits.x : bits.z);
        u[1] = uniform24(lo ? bits.y : bits.w);
      }
      float y[2];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        y[t] = lg[t] * inv_temp - logf(-logf(u[t] + 1e-10f) + 1e-10f);

      float best = y[0], ch = lg[0];
      int id = gcol;
      better_of(best, id, ch, y[1], gcol + 1, lg[1]);
      float mx = fmaxf(lg[0], lg[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oid = __shfl_xor_sync(0xffffffffu, id, off);
        const float och = __shfl_xor_sync(0xffffffffu, ch, off);
        better_of(best, id, ch, ob, oid, och);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      float se = expf(lg[0] - mx) + expf(lg[1] - mx);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        se += __shfl_xor_sync(0xffffffffu, se, off);
      if (lane == 0) {
        float* p = partials + ((size_t)row * nchunks + chunk) * NPART;
        p[0] = best;
        p[1] = __int_as_float(id);
        p[2] = ch;
        p[3] = mx;
        p[4] = se;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
proj_merge_kernel(const float* __restrict__ partials, int rows, int nchunks,
                  int* __restrict__ ids, float* __restrict__ score) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + warp;
  if (row >= rows) return;
  float best = -INFINITY, ch = 0.f, m = -INFINITY, se = 0.f;
  int id = 0x7fffffff;
  for (int c = lane; c < nchunks; c += 32) {
    const float* p = partials + ((size_t)row * nchunks + c) * NPART;
    better_of(best, id, ch, p[0], __float_as_int(p[1]), p[2]);
    merge_lse(m, se, p[3], p[4]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oid = __shfl_xor_sync(0xffffffffu, id, off);
    const float och = __shfl_xor_sync(0xffffffffu, ch, off);
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float ose = __shfl_xor_sync(0xffffffffu, se, off);
    better_of(best, id, ch, ob, oid, och);
    merge_lse(m, se, om, ose);
  }
  if (lane == 0) {
    ids[row] = id;
    score[row] = 1.f - expf(ch - m) / se;
  }
}

template <typename T>
cudaError_t launch_partials(const void* h, const void* w, const void* bias,
                            const void* noise, void* partials, int rows, int D,
                            int V, float inv_temp, uint2 key, cudaStream_t s) {
  const size_t smem = w_bytes<T>(staged_d(D)) + sizeof(float) * RT * VC;
  cudaError_t err = cudaFuncSetAttribute(
      proj_partials_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_pad = (rows + RT - 1) / RT * RT;
  proj_partials_kernel<T><<<V / VC, THREADS, smem, s>>>(
      (const T*)h, (const T*)w, (const float*)bias, (const float*)noise,
      (float*)partials, rows, rows_pad, D, V, inv_temp, key);
  return cudaGetLastError();
}

}  // namespace
}  // namespace phenaki

// h must hold round_up(rows, 64) rows (the wrapper zero-pads it); partials
// holds rows * (V / 64) * 5 floats.
extern "C" int proj_sample(const void* h, const void* w, const void* bias,
                           const void* noise, void* ids, void* score,
                           void* partials, int rows, int D, int V,
                           float temperature, unsigned long long seed,
                           int dtype, void* stream) {
  using namespace phenaki;
  if (rows <= 0 || D <= 0 || D % 16 != 0 || V <= 0 || V % VC != 0)
    return cudaErrorInvalidValue;
  const float inv_temp = 1.f / fmaxf(temperature, 1e-10f);
  const uint2 key = make_uint2((uint32_t)(seed & 0xffffffffull),
                               (uint32_t)(seed >> 32));
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == kBF16)
    err = launch_partials<bf16>(h, w, bias, noise, partials, rows, D, V, inv_temp, key, s);
  else if (dtype == kF32)
    err = launch_partials<float>(h, w, bias, noise, partials, rows, D, V, inv_temp, key, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const int warps = THREADS / 32;
  proj_merge_kernel<<<(rows + warps - 1) / warps, THREADS, 0, s>>>(
      (const float*)partials, rows, V / VC, (int*)ids, (float*)score);
  return cudaGetLastError();
}
