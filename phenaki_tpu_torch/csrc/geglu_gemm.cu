// The GEGLU feedforward's first product with its gate in the epilogue, on
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package (phenaki_tpu/ops/feedforward.py,
// `FeedForward` and `geglu`) leaves the feedforward to XLA, which fuses the
// gate into the product. Per row r of x (rows, D), the normed input:
//   a, gate = x[r] . W_a^T, x[r] . W_gate^T      (proj_in's two halves)
//   h[r, j] = gelu_erf(gate_j) * a_j              (exact erf GELU, f32)
// The 2 * inner wide projection never reaches device memory (unless the
// caller asks for it, `pre`, which autograd's backward reads).
//
// The layout. proj_in's weight arrives packed (ops/feedforward.py
// `pack_proj_in`): each half zero-padded to Ip = round_up(inner, 64) rows,
// and 128-row tile t holding rows 64 t .. 64 t + 63 of a, then the same rows
// of gate. In the m64n128 accumulator layout (wgmma.cuh) a thread then holds
// a's column j in 8-column block n and gate's column j in block n + 8: the
// epilogue pairs them in registers, no shuffle. h is (rows, Ip), its padded
// columns exactly 0 (gelu(0) * 0), so proj_out reads an aligned K = Ip
// against its weight zero-padded to Ip columns: 1365 -> 1408 at dim 512,
// rows of 2816 bytes, where 1365's 2730 put cuBLAS on its pre-Hopper kernels.
//
// What bounds it on the H100, at the MaskGit's guided forward (x (36864,
// 512) bf16, packed W (2816, 512)): the products are 2 rows D 2 Ip = 106.3
// GFLOP, 0.107 ms at 989 TFLOP/s, against 37.7 MB of x, 2.9 MB of W and
// 103.8 MB of h (0.043 ms at 3.35 TB/s): the tensor cores. Behind the
// products comes the epilogue: one erf (a short polynomial or an exp) per
// value of h, 32 a thread a tile, on the CUDA cores.
//
// The design (bf16: geglu_gemm_kernel). The main loop is vocab_gemm.cuh's,
// which the projection sampler (kernel 2) and the fused CE forward (kernel
// 7) run: a block (two warpgroups) owns 128 rows of x, resident in shared
// memory up to D = 512 and streamed past it, and walks one of S splits of
// the packed weight's 128-row tiles through a cp.async ring, wgmma
// m64n128k16 from shared memory, two accumulators so that tile t - 1's
// epilogue runs under tile t's products. Rows past `rows` are read as zeros
// (kMaskRows), so x is never padded by a copy. The epilogue: gelu(gate) * a
// in f32, one rounding to bf16, into a per-warp staging buffer (16 rows x
// 128 bytes, 16-byte chunks swizzled by row so the accumulator-layout
// writes hit 32 banks), then 16-byte stores of whole 128-byte row segments.
// The wrapper picks S (ops/feedforward.py `geglu_splits`) from the row
// tiles and the SMs so the last wave is not mostly empty: 2 at 36,864 rows
// (576 blocks, 11 tiles each; x read twice, 75 MB from L2).
//
// f32 (geglu_gemm_f32_kernel, the CUDA cores, exact for the card checks of
// the small f32 models; no main path runs it): a block owns 64 rows and 32
// columns of h (64 packed weight rows), any D, x and W staged 32 columns of
// d at a time.

#include "vocab_gemm.cuh"

namespace phenaki {
namespace {

constexpr int GG_COLS = PB_VT / 2;               // h columns a packed tile: 64
constexpr int GG_WARP_STAGE = 16 * GG_COLS * 2;  // a warp's staging: 16 rows of 128 bytes
constexpr int GG_STAGE = (PB_THREADS / 32) * GG_WARP_STAGE;  // 16 KB a block
constexpr float INV_SQRT2 = 0.7071067811865476f;

// x * Phi(x), Phi by erf: PyTorch's gelu (approximate="none")
__device__ __forceinline__ float gelu_erf(float x) { return 0.5f * x * (1.f + erff(x * INV_SQRT2)); }

struct Geglu {
  const bf16 *h, *w;  // x (rows, D), the packed weight (V, D), V = 2 Ip
  const float* bias;  // null: the main loop's bias hook
  bf16* out;          // h (rows, Ip)
  bf16* pre;          // the packed pre-activation (rows, V), or null
  int rows, D, V, splits;
  static constexpr bool kMaskRows = true;  // x holds `rows` rows, unpadded
};

template <bool RES, bool PRE>
__global__ void __launch_bounds__(PB_THREADS, 1) geglu_gemm_kernel(const __grid_constant__ Geglu p) {
  extern __shared__ unsigned char smem_raw[];
  const Walk k = make_walk<RES>(p, smem_raw);
  const int lane = threadIdx.x & 31, g = lane >> 2, warp = threadIdx.x >> 5;
  // the staging buffers follow the main loop's bias slots
  unsigned char* stage = reinterpret_cast<unsigned char*>(k.sbias + PB_BIAS_SLOTS * PB_VT) + warp * GG_WARP_STAGE;
  const int Ip = p.V / 2;
  const int wrow0 = k.row0 - g;  // the warp's first row

  auto epilogue = [&](const float (&acc)[64], int v0, const float*) {
    if (PRE) {  // the packed pre-activation as it came from the products, bf16
#pragma unroll
      for (int n = 0; n < PB_BLOCKS; ++n) {
        bf16* dst = p.pre + (size_t)k.row0 * p.V + v0 + 8 * n + 2 * k.c;
        if (k.row0 < p.rows) *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[4 * n], acc[4 * n + 1]);
        if (k.row0 + 8 < p.rows)
          *reinterpret_cast<uint32_t*>(dst + (size_t)8 * p.V) = pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
      }
    }
    // a's block n pairs with gate's block n + 8: rows g and g + 8 of the
    // warp's 16, columns 8 n + 2 c and + 1, as 4-byte pairs at chunk n ^ g
#pragma unroll
    for (int n = 0; n < PB_BLOCKS / 2; ++n) {
      const int a = 4 * n, gt = 4 * (n + PB_BLOCKS / 2);
      const uint32_t lo = pack_bf16(gelu_erf(acc[gt]) * acc[a], gelu_erf(acc[gt + 1]) * acc[a + 1]);
      const uint32_t hi = pack_bf16(gelu_erf(acc[gt + 2]) * acc[a + 2], gelu_erf(acc[gt + 3]) * acc[a + 3]);
      const int at = ((n ^ g) << 4) + 4 * k.c;
      *reinterpret_cast<uint32_t*>(stage + g * 128 + at) = lo;
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * 128 + at) = hi;
    }
    __syncwarp();
    // the warp's 16 rows x 128 bytes: 8 lanes a row, 16 bytes each
    const int j0 = v0 / 2;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int e = it * 32 + lane, r = e >> 3, ch = e & 7;
      const uint4 v = *reinterpret_cast<const uint4*>(stage + r * 128 + ((ch ^ (r & 7)) << 4));
      const int row = wrow0 + r;
      if (row < p.rows) *reinterpret_cast<uint4*>(p.out + (size_t)row * Ip + j0 + ch * 8) = v;
    }
    __syncwarp();
  };
  vocab_walk<RES>(p, k, epilogue);
}

cudaError_t launch_wgmma(const Geglu& p, cudaStream_t s) {
  if (!aligned16(p.h) || !aligned16(p.w) || !aligned16(p.out) || (p.pre && !aligned16(p.pre)))
    return cudaErrorMisalignedAddress;
  const int NS = p.D / PB_KS;
  const bool res = NS <= PB_RESIDENT_NS;
  const int smem = (res ? pb_smem<true>(NS) : pb_smem<false>(NS)) + GG_STAGE;
  auto kern = res ? (p.pre ? geglu_gemm_kernel<true, true> : geglu_gemm_kernel<true, false>)
                  : (p.pre ? geglu_gemm_kernel<false, true> : geglu_gemm_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.rows + PB_ROWS - 1) / PB_ROWS, p.splits);
  kern<<<grid, PB_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FR = 64;   // rows of x a block
constexpr int FC = 32;   // columns of h a block: 32 of a and 32 of gate
constexpr int FK = 32;   // columns of d a staged step
constexpr int F_THREADS = 256;

// thread (tx, ty) = (t % 16, t / 16) owns rows ty + 16 i and h columns
// tx and tx + 16 (a's and gate's)
__global__ void __launch_bounds__(F_THREADS)
geglu_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ h,
                      float* __restrict__ pre, int rows, int D, int Ip) {
  __shared__ float xs[FK][FR + 1];
  __shared__ float ws[FK][2 * FC + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * FR, j0 = blockIdx.y * FC;
  const int pa = (j0 / GG_COLS) * PB_VT + j0 % GG_COLS;  // packed row of a's column j0; gate's is 64 on
  float acc[4][4];  // [row i][a tx, a tx + 16, gate tx, gate tx + 16]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += FK) {
    for (int e = threadIdx.x; e < FR * FK; e += F_THREADS) {
      const int r = e / FK, kk = e % FK;
      xs[kk][r] = (r0 + r < rows && k0 + kk < D) ? x[(size_t)(r0 + r) * D + k0 + kk] : 0.f;
    }
    for (int e = threadIdx.x; e < 2 * FC * FK; e += F_THREADS) {
      const int c = e / FK, kk = e % FK;
      const int prow = pa + (c < FC ? c : GG_COLS + c - FC);
      ws[kk][c] = k0 + kk < D ? w[(size_t)prow * D + k0 + kk] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < FK; ++kk) {
      float xv[4];
      const float wv[4] = {ws[kk][tx], ws[kk][tx + 16], ws[kk][FC + tx], ws[kk][FC + tx + 16]};
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float a = acc[i][q], gate = acc[i][2 + q];
      h[(size_t)row * Ip + j0 + tx + 16 * q] = gelu_erf(gate) * a;
      if (pre) {
        pre[(size_t)row * 2 * Ip + pa + tx + 16 * q] = a;
        pre[(size_t)row * 2 * Ip + pa + GG_COLS + tx + 16 * q] = gate;
      }
    }
  }
}

}  // namespace
}  // namespace phenaki

// x (rows, D) and the packed weight w (2 * Ip, D) in one dtype; h (rows, Ip)
// and pre (rows, 2 * Ip) or null in that dtype. bf16: D % 128 == 0, Ip % 64
// == 0, 1 <= splits <= 2 * Ip / 128. f32: any D, Ip % 64 == 0, splits unread.
extern "C" int geglu_gemm(const void* x, const void* w, void* h, void* pre, int rows, int D, int Ip,
                          int splits, int dtype, void* stream) {
  using namespace phenaki;
  if (rows <= 0 || D <= 0 || Ip <= 0 || Ip % GG_COLS != 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16) {
    if (D % 128 != 0 || splits < 1 || splits > 2 * Ip / PB_VT) return cudaErrorInvalidValue;
    Geglu p{(const bf16*)x, (const bf16*)w, nullptr, (bf16*)h, (bf16*)pre, rows, D, 2 * Ip, splits};
    return launch_wgmma(p, s);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const dim3 grid((rows + FR - 1) / FR, Ip / FC);
  geglu_gemm_f32_kernel<<<grid, F_THREADS, 0, s>>>((const float*)x, (const float*)w, (float*)h, (float*)pre,
                                                   rows, D, Ip);
  return cudaGetLastError();
}
