// Fused vocab projection + softmax cross-entropy on Hopper (sm_90a): the
// forward and its two backward kernels (dh; dW and dbias).
//
// Replace the TPU kernels of phenaki_tpu/ops/pallas_ce.py (_fwd_kernel,
// _bwd_dh_kernel, _bwd_dw_kernel, reached from fused_vocab_cross_entropy and
// its custom VJP -> pl.pallas_call). Math contract, per row r of h (R, D)
// with label y[r], over the V rows of the weight W (V, D), the nn.Linear
// layout:
//   logit[r, v] = h[r] . W[v] + bias[v]                 (f32 accumulate)
//   lse[r]      = log sum_v exp(logit[r, v])
//   loss[r]     = lse[r] - logit[r, y[r]]    (a label outside [0, V) picks
//                 no logit, so loss = lse: the TPU kernels' -1 pad label)
//   dlog[r, v]  = (exp(logit[r, v] - lse[r]) - [v == y[r]]) * g[r]
//   dh = dlog @ W and dW = dlog^T @ h, with dlog rounded to the input dtype
//   before the product as the TPU kernels do; dbias = sum_r dlog in f32.
// The (R, V) logits never reach device memory in either direction.
//
// What bounds it on the H100: every kernel is a GEMM-sized product,
// 2 * R * D * V FLOPs (0.31 TFLOP at the flagship train shape R = 4608,
// D = 512, V = 65,536), and each backward kernel recomputes the logits
// first, so does two. Against 64 MB of W and 4.7 MB of h that is hundreds
// of FLOPs a byte, so the tensor cores bound it in principle. The measured
// rate, about 95 TFLOP/s in bf16 on an H100 80GB HBM3 at 700 W, points at
// shared-memory traffic instead: holding all of D of one operand leaves
// room for a logits tile of only 32 x 64, one 16 x 16 WMMA fragment a warp,
// so every MMA there takes two fragment loads. Two blocks share an SM, so one block's tile
// staging overlaps the other's products. The TPU kernels carried their
// sums across a sequential grid axis; Hopper blocks run in no order, so
// each block keeps one operand resident in shared memory, all of D, and
// streams the other in tiles:
//   - forward: a block holds 32 rows of h and walks one of S vocab splits
//     in tiles of W, keeping each row's online max and sum-exp in
//     registers; it writes one (max, sum-exp) partial per (row, split), and
//     the one thread that meets a row's label writes that logit.
//     ce_merge_kernel folds the S partials into lse and loss.
//   - dh: the same blocks. Per vocab tile the logits are recomputed into
//     shared memory and turned into dlog, and dlog @ W_tile accumulates the
//     block's (32 x D) dh in registers. Each split writes its own partial
//     dh; ce_sum_kernel adds them in split order, so the result is
//     deterministic with no float atomics.
//   - dW/dbias: a block holds 32 rows of W (32 vocab ids) and walks every
//     row tile of h; dlog^T @ h_tile accumulates its (32 x D) dW in
//     registers, and dbias sums in f32 per thread, then in warp order.
// bf16 runs the products on the tensor cores (WMMA 16x16x16, f32
// accumulate); f32 runs them on the CUDA cores in exact f32, for the card
// checks. Register-tiled mma.sync or wgmma tiles streamed over D through a
// cp.async/TMA pipeline, with larger logits tiles, are the next step.
//
// D beyond 512 (up to the TPU gate's 2432) does not fit shared memory whole.
// There the kernels walk d in slices of 512 columns: a logits tile is the
// sum of its slices' products, both operands staged a slice at a time. dh
// and dW split their d-wide outputs into the same slices over one more grid
// axis; each such block recomputes the whole logits tile and ends its slice
// walk on its own output slice, so that the staged operand it multiplies
// dlog by is already in shared memory. At D <= 512 every kernel runs as
// before, one operand resident.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace phenaki {
namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr int RES = 32;       // resident rows of h (forward, dh) or of W (dW)
constexpr int SLICE = 512;    // d columns staged at a time (all of D up to this)
constexpr int LDR = RES + 8;  // row stride of the dW kernel's (STR x RES) tiles

// the streamed tile: vocab ids (forward, dh) or rows of h (dW) per step. At
// D = 512 two bf16 blocks fit an SM (113-115 KB of shared memory, 128
// registers a thread); f32 blocks take 206-218 KB, one an SM.
constexpr int STR = 64;

// row padding of a staged (rows, D) operand: bf16 rows stay 16-byte aligned
// for WMMA; the odd f32 stride sends column reads to 32 banks
template <typename T>
__host__ __device__ constexpr int pad() { return sizeof(T) == 2 ? 8 : 1; }

__host__ __device__ constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ void merge_lse(float& m, float& se, float om, float ose) {
  const float mn = fmaxf(m, om);
  if (mn == -INFINITY) return;
  const float a = (m == -INFINITY) ? 0.f : se * expf(m - mn);
  const float b = (om == -INFINITY) ? 0.f : ose * expf(om - mn);
  se = a + b;
  m = mn;
}

__device__ __forceinline__ void store16(bf16* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }
__device__ __forceinline__ void store16(float* p, uint4 v) {
  p[0] = __uint_as_float(v.x);
  p[1] = __uint_as_float(v.y);
  p[2] = __uint_as_float(v.z);
  p[3] = __uint_as_float(v.w);
}

// columns [c0, c0 + K) of rows [r0, r0 + n) of a (nrows, D) array into
// dst[n][ld], zero past nrows
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* __restrict__ src, int r0,
                                           int n, int nrows, int D, int c0, int K) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = K / VEC;
  for (int e = threadIdx.x; e < n * per_row; e += THREADS) {
    const int r = e / per_row, c = (e % per_row) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c0 + c);
    store16(dst + r * ld + c, val);
  }
}

// d-slices of a D-wide operand, and the width of slice s
__host__ __device__ constexpr int num_slices(int D) { return (D + SLICE - 1) / SLICE; }
__host__ __device__ constexpr int staged_d(int D) { return D < SLICE ? D : SLICE; }
__device__ __forceinline__ int slice_width(int D, int s) { return min(SLICE, D - s * SLICE); }

// L[m][n] = sum_k A[m][k] * B[n][k] for an (M x N) tile, accumulated over
// slices of d; A and B row-major in shared memory.
template <typename T, int M, int N>
struct TileAcc;

// bf16: each warp owns one 16-row group and FPW 16-column groups of WMMA
// fragments
template <int M, int N>
struct TileAcc<bf16, M, N> {
  static constexpr int FPW = (M / 16) * (N / 16) / (THREADS / 32);
  static constexpr int WPM = (N / 16) / FPW;  // warps per 16-row group
  static_assert(FPW >= 1 && (N / 16) % FPW == 0, "tile does not split over 8 warps");
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[FPW];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int f = 0; f < FPW; ++f) wmma::fill_fragment(c[f], 0.f);
  }

  __device__ __forceinline__ void add(const bf16* A, int lda, const bf16* B, int ldb, int K) {
    const int warp = threadIdx.x >> 5;
    const int fm = warp / WPM, fn0 = (warp % WPM) * FPW;
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + fm * 16 * lda + k, lda);
#pragma unroll
      for (int f = 0; f < FPW; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, B + (fn0 + f) * 16 * ldb + k, ldb);
        wmma::mma_sync(c[f], a, b, c[f]);
      }
    }
  }

  __device__ __forceinline__ void store(float* L, int ldl) const {
    const int warp = threadIdx.x >> 5;
    const int fm = warp / WPM, fn0 = (warp % WPM) * FPW;
#pragma unroll
    for (int f = 0; f < FPW; ++f)
      wmma::store_matrix_sync(L + fm * 16 * ldl + (fn0 + f) * 16, c[f], ldl, wmma::mem_row_major);
  }
};

// f32: thread t owns column t % N of rows t / N + (256 / N) * i
template <int M, int N>
struct TileAcc<float, M, N> {
  static constexpr int OPT = M * N / THREADS;
  static constexpr int RSTEP = THREADS / N;
  float acc[OPT];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < OPT; ++i) acc[i] = 0.f;
  }

  __device__ __forceinline__ void add(const float* A, int lda, const float* B, int ldb, int K) {
    const int n = threadIdx.x % N, m0 = threadIdx.x / N;
    for (int k = 0; k < K; ++k) {
      const float b = B[n * ldb + k];
#pragma unroll
      for (int i = 0; i < OPT; ++i) acc[i] = fmaf(A[(m0 + RSTEP * i) * lda + k], b, acc[i]);
    }
  }

  __device__ __forceinline__ void store(float* L, int ldl) const {
    const int n = threadIdx.x % N, m0 = threadIdx.x / N;
#pragma unroll
    for (int i = 0; i < OPT; ++i) L[(m0 + RSTEP * i) * ldl + n] = acc[i];
  }
};

// The (M x N) logits tile A[a0 : a0 + M] . B[b0 : b0 + N]^T of two (rows, D)
// operands into L, over ns d-slices. With one d-slice the caller keeps one operand resident
// (A where a_resident, else B) and this stages the other; with more, both
// are staged slice by slice, in the order that ends on slice `last`, so
// that As and Bs hold that slice afterwards. Starts with a barrier: every
// reader of As, Bs and L is done when it stages or stores.
template <typename T, int M, int N>
__device__ __forceinline__ void logits_tile(T* As, const T* A, int a0, int a_rows, T* Bs,
                                            const T* B, int b0, int b_rows, bool a_resident,
                                            int ld, int D, int ns, int last, float* L, int ldl) {
  TileAcc<T, M, N> acc;
  acc.zero();
  for (int i = 0; i < ns; ++i) {
    const int sl = (last + 1 + i) % ns, c0 = sl * SLICE, K = slice_width(D, sl);
    __syncthreads();
    if (ns > 1 || !a_resident) stage_rows(As, ld, A, a0, M, a_rows, D, c0, K);
    if (ns > 1 || a_resident) stage_rows(Bs, ld, B, b0, N, b_rows, D, c0, K);
    __syncthreads();
    acc.add(As, ld, Bs, ld, K);
  }
  acc.store(L, ldl);
}

// A block's (RES x D) f32 gradient slice, D <= 512: += P (RES x K) @ B (K x D),
// P row-major, or stored transposed as [K][RES] (TRANS); B row-major.
template <typename T>
struct Acc;

// bf16: warp w owns columns [w * D / 8, (w + 1) * D / 8), as D / 128
// fragments of 16 columns, over both 16-row groups
template <>
struct Acc<bf16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int fm = 0; fm < 2; ++fm)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(f[fm][j], 0.f);
  }

  template <bool TRANS>
  __device__ __forceinline__ void accumulate(const bf16* P, int ldp, const bf16* B, int ldb, int K,
                                             int D) {
    using Layout = typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
    const int nd = D / 128, c0 = (threadIdx.x >> 5) * (D / 8);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, Layout> a[2];
#pragma unroll
      for (int fm = 0; fm < 2; ++fm)
        wmma::load_matrix_sync(a[fm], TRANS ? P + k * ldp + fm * 16 : P + fm * 16 * ldp + k, ldp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nd) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, B + k * ldb + c0 + j * 16, ldb);
          wmma::mma_sync(f[0][j], a[0], b, f[0][j]);
          wmma::mma_sync(f[1][j], a[1], b, f[1][j]);
        }
      }
    }
  }

  // all RES rows of dst (row stride ld)
  __device__ __forceinline__ void store(float* dst, int ld, int D) const {
    const int nd = D / 128, c0 = (threadIdx.x >> 5) * (D / 8);
#pragma unroll
    for (int fm = 0; fm < 2; ++fm)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nd)
          wmma::store_matrix_sync(dst + fm * 16 * ld + c0 + j * 16, f[fm][j], ld,
                                  wmma::mem_row_major);
  }
};

// f32: thread t owns columns t % 128 + 128 j (j < D / 128) of rows
// t / 128 + 2 i (i < 16)
template <>
struct Acc<float> {
  float v[RES / 2][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RES / 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
  }

  template <bool TRANS>
  __device__ __forceinline__ void accumulate(const float* P, int ldp, const float* B, int ldb,
                                             int K, int D) {
    const int nd = D / 128, c = threadIdx.x & 127, m0 = threadIdx.x >> 7;
    for (int k = 0; k < K; ++k) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = j < nd ? B[k * ldb + c + 128 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < RES / 2; ++i) {
        const int m = m0 + 2 * i;
        const float p = TRANS ? P[k * ldp + m] : P[m * ldp + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = fmaf(p, b[j], v[i][j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld, int D) const {
    const int nd = D / 128, c = threadIdx.x & 127, m0 = threadIdx.x >> 7;
#pragma unroll
    for (int i = 0; i < RES / 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nd) dst[(size_t)(m0 + 2 * i) * ld + c + 128 * j] = v[i][j];
  }
};

struct CE {
  const void *h, *w;
  const float* bias;  // (V,) or null
  const int* labels;  // (R,)
  const float *lse, *g;  // (R,) each; backward only
  int R, D, V;
};

// row stride of a staged operand slice
template <typename T>
__host__ __device__ constexpr int ld_op(int D) { return staged_d(D) + pad<T>(); }

// shared-memory layout of the forward and dh kernels: Hs [RES][ld],
// Ws [STR][ld], Ls [RES][STR + 8] f32, Ps [RES][STR + 8] (dh only)
template <typename T>
__host__ __device__ constexpr size_t rows_smem(int D, bool with_p) {
  return round128((size_t)RES * ld_op<T>(D) * sizeof(T)) +
         round128((size_t)STR * ld_op<T>(D) * sizeof(T)) +
         round128((size_t)RES * (STR + 8) * sizeof(float)) +
         (with_p ? (size_t)RES * (STR + 8) * sizeof(T) : 0);
}

// shared-memory layout of the dW kernel: Ws [RES][ld], Hs [STR][ld],
// Ls [STR][LDR] f32, Ps [STR][LDR]
template <typename T>
__host__ __device__ constexpr size_t vocab_smem(int D) {
  return round128((size_t)RES * ld_op<T>(D) * sizeof(T)) +
         round128((size_t)STR * ld_op<T>(D) * sizeof(T)) +
         round128((size_t)STR * LDR * sizeof(float)) + (size_t)STR * LDR * sizeof(T);
}

// Each kernel is built twice: SLICED = false for D <= 512 (one slice, a
// compile-time constant, so the flagship's code is the one-operand-resident
// loop with nothing added), SLICED = true beyond.

// ---- forward: one block per (32 rows, vocab split) ----
template <typename T, bool SLICED>
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_kernel(CE a, int tiles_per_split, float* __restrict__ partials,
              float* __restrict__ label_logit) {
  constexpr int LDT = STR + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = ld_op<T>(a.D);
  T* Hs = reinterpret_cast<T*>(smem);
  T* Ws = reinterpret_cast<T*>(smem + round128((size_t)RES * ld * sizeof(T)));
  float* Ls = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Ws) +
                                       round128((size_t)STR * ld * sizeof(T)));

  const int r0 = blockIdx.x * RES, split = blockIdx.y, nsplit = gridDim.y;
  const int t0 = split * tiles_per_split, t1 = min(t0 + tiles_per_split, a.V / STR);
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const int ns = SLICED ? num_slices(a.D) : 1;
  if (!SLICED) stage_rows(Hs, ld, h, r0, RES, a.R, a.D, 0, a.D);

  // 8 threads a row; thread q of a row owns columns q + 8 c of each tile
  const int m = threadIdx.x >> 3, q = threadIdx.x & 7, row = r0 + m;
  const int y = row < a.R ? a.labels[row] : -1;
  float run_m = -INFINITY, run_se = 0.f;
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * STR;
    logits_tile<T, RES, STR>(Hs, h, r0, a.R, Ws, w, v0, a.V, true, ld, a.D, ns, ns - 1, Ls, LDT);
    __syncthreads();
    float x[STR / 8];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < STR / 8; ++c) {
      const int n = q + 8 * c;
      x[c] = Ls[m * LDT + n] + (a.bias ? a.bias[v0 + n] : 0.f);
      tmax = fmaxf(tmax, x[c]);
    }
    const float mn = fmaxf(run_m, tmax);
    float se = 0.f;
#pragma unroll
    for (int c = 0; c < STR / 8; ++c) se += expf(x[c] - mn);
    run_se = run_se * expf(run_m - mn) + se;
    run_m = mn;
    const int ly = y - v0;
    if (ly >= 0 && ly < STR && (ly & 7) == q)
      label_logit[row] = Ls[m * LDT + ly] + (a.bias ? a.bias[y] : 0.f);
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, run_m, off);
    const float ose = __shfl_xor_sync(0xffffffffu, run_se, off);
    merge_lse(run_m, run_se, om, ose);
  }
  if (q == 0 && row < a.R) {
    partials[((size_t)row * nsplit + split) * 2] = run_m;
    partials[((size_t)row * nsplit + split) * 2 + 1] = run_se;
  }
}

__global__ void __launch_bounds__(THREADS)
ce_merge_kernel(const float* __restrict__ partials, const float* __restrict__ label_logit,
                const int* __restrict__ labels, int R, int V, int nsplit,
                float* __restrict__ loss, float* __restrict__ lse) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= R) return;
  float m = -INFINITY, se = 0.f;
  for (int s = 0; s < nsplit; ++s)
    merge_lse(m, se, partials[((size_t)row * nsplit + s) * 2],
              partials[((size_t)row * nsplit + s) * 2 + 1]);
  const float l = m + logf(se);
  const int y = labels[row];
  lse[row] = l;
  loss[row] = l - ((y >= 0 && y < V) ? label_logit[row] : 0.f);
}

// ---- dh: one block per (32 rows, vocab split, d-slice); a partial dh per split ----
template <typename T, bool SLICED>
__global__ void __launch_bounds__(THREADS, 2)
ce_dh_kernel(CE a, int tiles_per_split, int rows_pad, float* __restrict__ dh_part) {
  constexpr int LDT = STR + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = ld_op<T>(a.D);
  T* Hs = reinterpret_cast<T*>(smem);
  T* Ws = reinterpret_cast<T*>(smem + round128((size_t)RES * ld * sizeof(T)));
  float* Ls = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Ws) +
                                       round128((size_t)STR * ld * sizeof(T)));
  T* Ps = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(Ls) +
                               round128((size_t)RES * LDT * sizeof(float)));

  // blockIdx.z: the d-slice of dh this block writes
  const int r0 = blockIdx.x * RES, split = blockIdx.y, out = SLICED ? blockIdx.z : 0;
  const int t0 = split * tiles_per_split, t1 = min(t0 + tiles_per_split, a.V / STR);
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const int ns = SLICED ? num_slices(a.D) : 1, K_out = SLICED ? slice_width(a.D, out) : a.D;
  if (!SLICED) stage_rows(Hs, ld, h, r0, RES, a.R, a.D, 0, a.D);

  const int m = threadIdx.x >> 3, q = threadIdx.x & 7, row = r0 + m;
  const bool valid = row < a.R;
  const int y = valid ? a.labels[row] : -1;
  const float lse = valid ? a.lse[row] : 0.f, g = valid ? a.g[row] : 0.f;
  Acc<T> acc;
  acc.zero();
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * STR;
    // ends on slice `out`: Ws holds W[v0 : v0 + STR, out slice] below
    logits_tile<T, RES, STR>(Hs, h, r0, a.R, Ws, w, v0, a.V, true, ld, a.D, ns, out, Ls, LDT);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < STR / 8; ++c) {
      const int n = q + 8 * c;
      float d = 0.f;
      if (valid) {
        const float x = Ls[m * LDT + n] + (a.bias ? a.bias[v0 + n] : 0.f);
        d = (expf(x - lse) - (v0 + n == y ? 1.f : 0.f)) * g;
      }
      Ps[m * LDT + n] = from_f32<T>(d);
    }
    __syncthreads();
    acc.template accumulate<false>(Ps, LDT, Ws, ld, STR, K_out);
  }
  acc.store(dh_part + ((size_t)split * rows_pad + r0) * a.D + out * SLICE, a.D, K_out);
}

// dh = the splits' partials added in split order
__global__ void __launch_bounds__(THREADS)
ce_sum_kernel(const float4* __restrict__ part, int nsplit, size_t split_stride4, size_t n4,
              float4* __restrict__ out) {
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n4;
       e += (size_t)gridDim.x * THREADS) {
    float4 s = part[e];
    for (int k = 1; k < nsplit; ++k) {
      const float4 p = part[k * split_stride4 + e];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    out[e] = s;
  }
}

// ---- dW and dbias: one block per (32 vocab ids, d-slice), a loop over the rows ----
template <typename T, bool SLICED>
__global__ void __launch_bounds__(THREADS, 2)
ce_dw_kernel(CE a, float* __restrict__ dw, float* __restrict__ db) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = ld_op<T>(a.D);
  T* Ws = reinterpret_cast<T*>(smem);
  T* Hs = reinterpret_cast<T*>(smem + round128((size_t)RES * ld * sizeof(T)));
  float* Ls = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Hs) +
                                       round128((size_t)STR * ld * sizeof(T)));
  T* Ps = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(Ls) +
                               round128((size_t)STR * LDR * sizeof(float)));

  // blockIdx.y: the d-slice of dW this block writes
  const int v0 = blockIdx.x * RES, out = SLICED ? blockIdx.y : 0;
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const int ns = SLICED ? num_slices(a.D) : 1, K_out = SLICED ? slice_width(a.D, out) : a.D;
  if (!SLICED) stage_rows(Ws, ld, w, v0, RES, a.V, a.D, 0, a.D);

  // thread t owns vocab id v0 + t % 32 of rows t / 32 + 8 i of each tile
  const int n = threadIdx.x & 31, m0 = threadIdx.x >> 5, v = v0 + n;
  const float bv = a.bias ? a.bias[v] : 0.f;
  float dbias = 0.f;
  Acc<T> acc;
  acc.zero();
  for (int r0 = 0; r0 < a.R; r0 += STR) {
    // ends on slice `out`: Hs holds h[r0 : r0 + STR, out slice] below
    logits_tile<T, STR, RES>(Hs, h, r0, a.R, Ws, w, v0, a.V, false, ld, a.D, ns, out, Ls, LDR);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < STR / 8; ++i) {
      const int mm = m0 + 8 * i, row = r0 + mm;
      float d = 0.f;
      if (row < a.R) {
        const float x = Ls[mm * LDR + n] + bv;
        d = (expf(x - a.lse[row]) - (a.labels[row] == v ? 1.f : 0.f)) * a.g[row];
      }
      dbias += d;
      Ps[mm * LDR + n] = from_f32<T>(d);
    }
    __syncthreads();
    acc.template accumulate<true>(Ps, LDR, Hs, ld, STR, K_out);
  }
  acc.store(dw + (size_t)v0 * a.D + out * SLICE, a.D, K_out);
  __syncthreads();  // Ls is free: fold dbias over the 8 warps in order
  Ls[m0 * RES + n] = dbias;
  __syncthreads();
  if (out == 0 && threadIdx.x < RES) {  // every d-slice block computes the same dbias
    float s = 0.f;
    for (int wp = 0; wp < THREADS / 32; ++wp) s += Ls[wp * RES + threadIdx.x];
    db[v0 + threadIdx.x] = s;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool shape_ok(int R, int D, int V, int dtype) {
  return R > 0 && D > 0 && D % 128 == 0 && V > 0 && V % STR == 0 && V % RES == 0 &&
         (dtype == kBF16 || dtype == kF32);
}

template <typename T, bool SLICED>
cudaError_t launch_fwd(const CE& a, int splits, float* partials, float* label_logit,
                       float* loss, float* lse, cudaStream_t s) {
  const int ntiles = a.V / STR;
  const int per = (ntiles + splits - 1) / splits;
  const size_t smem = rows_smem<T>(a.D, false);
  cudaError_t err = allow_smem(ce_fwd_kernel<T, SLICED>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.R + RES - 1) / RES, splits);
  ce_fwd_kernel<T, SLICED><<<grid, THREADS, smem, s>>>(a, per, partials, label_logit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_merge_kernel<<<(a.R + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      partials, label_logit, a.labels, a.R, a.V, splits, loss, lse);
  return cudaGetLastError();
}

template <typename T, bool SLICED>
cudaError_t launch_dh(const CE& a, int splits, float* partials, float* dh, cudaStream_t s) {
  const int ntiles = a.V / STR;
  const int per = (ntiles + splits - 1) / splits;
  const int rows_pad = (a.R + RES - 1) / RES * RES;
  const size_t smem = rows_smem<T>(a.D, true);
  cudaError_t err = allow_smem(ce_dh_kernel<T, SLICED>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows_pad / RES, splits, num_slices(a.D));
  ce_dh_kernel<T, SLICED><<<grid, THREADS, smem, s>>>(a, per, rows_pad, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)a.R * a.D / 4;
  const int blocks = (int)((n4 + THREADS - 1) / THREADS < 4096 ? (n4 + THREADS - 1) / THREADS : 4096);
  ce_sum_kernel<<<blocks, THREADS, 0, s>>>(reinterpret_cast<const float4*>(partials), splits,
                                           (size_t)rows_pad * a.D / 4, n4,
                                           reinterpret_cast<float4*>(dh));
  return cudaGetLastError();
}

template <typename T, bool SLICED>
cudaError_t launch_dw(const CE& a, float* dw, float* db, cudaStream_t s) {
  const size_t smem = vocab_smem<T>(a.D);
  cudaError_t err = allow_smem(ce_dw_kernel<T, SLICED>, smem);
  if (err != cudaSuccess) return err;
  ce_dw_kernel<T, SLICED><<<dim3(a.V / RES, num_slices(a.D)), THREADS, smem, s>>>(a, dw, db);
  return cudaGetLastError();
}

}  // namespace
}  // namespace phenaki

// h (R, D) and w (V, D) in one dtype; bias (V,) f32 or null; labels (R,)
// int32. Outputs loss and lse (R,) f32; label_logit (R,) and partials
// (R, splits, 2) are f32 scratch.
extern "C" int fused_ce_fwd(const void* h, const void* w, const void* bias, const void* labels,
                            void* loss, void* lse, void* label_logit, void* partials, int R,
                            int D, int V, int splits, int dtype, void* stream) {
  using namespace phenaki;
  if (!shape_ok(R, D, V, dtype) || splits < 1) return cudaErrorInvalidValue;
  const CE a{h, w, (const float*)bias, (const int*)labels, nullptr, nullptr, R, D, V};
  cudaStream_t s = (cudaStream_t)stream;
  float *p = (float*)partials, *ll = (float*)label_logit, *lo = (float*)loss, *ls = (float*)lse;
  const bool sliced = num_slices(D) > 1;
  if (dtype == kBF16)
    return sliced ? launch_fwd<bf16, true>(a, splits, p, ll, lo, ls, s)
                  : launch_fwd<bf16, false>(a, splits, p, ll, lo, ls, s);
  return sliced ? launch_fwd<float, true>(a, splits, p, ll, lo, ls, s)
                : launch_fwd<float, false>(a, splits, p, ll, lo, ls, s);
}

// lse and g (R,) f32; dh (R, D) f32; partials (splits, round_up(R, 32), D)
// f32 scratch
extern "C" int fused_ce_bwd_dh(const void* h, const void* w, const void* bias,
                               const void* labels, const void* lse, const void* g, void* dh,
                               void* partials, int R, int D, int V, int splits, int dtype,
                               void* stream) {
  using namespace phenaki;
  if (!shape_ok(R, D, V, dtype) || splits < 1) return cudaErrorInvalidValue;
  const CE a{h, w, (const float*)bias, (const int*)labels, (const float*)lse, (const float*)g,
             R, D, V};
  cudaStream_t s = (cudaStream_t)stream;
  const bool sliced = num_slices(D) > 1;
  if (dtype == kBF16)
    return sliced ? launch_dh<bf16, true>(a, splits, (float*)partials, (float*)dh, s)
                  : launch_dh<bf16, false>(a, splits, (float*)partials, (float*)dh, s);
  return sliced ? launch_dh<float, true>(a, splits, (float*)partials, (float*)dh, s)
                : launch_dh<float, false>(a, splits, (float*)partials, (float*)dh, s);
}

// dw (V, D) f32 and db (V,) f32
extern "C" int fused_ce_bwd_dw(const void* h, const void* w, const void* bias,
                               const void* labels, const void* lse, const void* g, void* dw,
                               void* db, int R, int D, int V, int dtype, void* stream) {
  using namespace phenaki;
  if (!shape_ok(R, D, V, dtype)) return cudaErrorInvalidValue;
  const CE a{h, w, (const float*)bias, (const int*)labels, (const float*)lse, (const float*)g,
             R, D, V};
  cudaStream_t s = (cudaStream_t)stream;
  const bool sliced = num_slices(D) > 1;
  if (dtype == kBF16)
    return sliced ? launch_dw<bf16, true>(a, (float*)dw, (float*)db, s)
                  : launch_dw<bf16, false>(a, (float*)dw, (float*)db, s);
  return sliced ? launch_dw<float, true>(a, (float*)dw, (float*)db, s)
                : launch_dw<float, false>(a, (float*)dw, (float*)db, s);
}
