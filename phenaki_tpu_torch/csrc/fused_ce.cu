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
// of FLOPs a byte, so the tensor cores bound it in principle. The TPU
// kernels carried their sums across a sequential grid axis; Hopper blocks
// run in no order, so each block keeps one operand resident and streams the
// other in tiles.
//
// Forward, bf16 (ce_fwd_wgmma_kernel): the projection sampler's main loop
// (vocab_gemm.cuh, shared with kernel 2). A block of two warpgroups holds
// 128 rows of h (in shared memory up to d = 512, streamed beside W past
// it) and walks one of S vocab splits in 128-id tiles of W, which stream
// through a five-stage ring of 64-column d slices in the 128-byte swizzle;
// the products are wgmma m64n128k16, two accumulators, so tile t - 1's
// epilogue runs under tile t's products. The epilogue stays in the
// accumulator registers: the tile's f32 bias from shared memory (it arrives
// with the ring), a sum-exp with one ex2.approx a logit against a reference
// that moves only when passed by 2^64 (no running max), and the label's
// logit, written by the one thread whose column holds it, on the one tile
// that holds it. The quad that shares a row merges its four sums; one
// (max, sum-exp) partial per (row, split); ce_merge_kernel folds the
// partials in split order into lse and loss. The wrapper picks S for whole
// waves of one block an SM (11 at the flagship: 36 row tiles x 11 = 3
// waves of 132 SMs) and zero-pads h to whole row tiles. What bounds it: L2
// serves W once a row tile, 36 x 67 MB = 2.4 GB at the flagship, about
// 0.55 ms at the 4.4 TB/s kernels 8 and 9 draw, against the products' 0.31
// ms at the tensor cores' peak.
// Forward, f32 (ce_fwd_kernel, the CUDA cores; the card checks, no main path
// runs it): a block holds 32 rows of h and walks one of S vocab splits in
// 64-id tiles of W, the logits through shared memory, the same partials.
//
// Backward, bf16 (ce_dh_wgmma_kernel, ce_dw_wgmma_kernel: one body, two
// roles). A block (two warpgroups) holds 64 rows A and walks 64-row tiles
// B: dh holds rows of h and walks one vocab split of W; dW holds 64 vocab
// rows of W and walks every row tile of h. Per tile:
//   1. S = A . B^T (64 x 64) on wgmma m64n32k16, each warpgroup 32 of the
//      columns, both operands K-major in the 128-byte swizzle (wgmma.cuh).
//   2. The epilogue in the accumulator registers: the bias, one ex2.approx
//      per logit against the saved lse, the onehot, g; dlog rounded to bf16
//      into a 64 x 64 shared tile, the A operand of step 3, since both
//      warpgroups need all 64 of its columns. The tile's per-column vectors
//      (dh: the bias; dW: lse, g, labels) arrive in shared memory with its
//      copies. dW sums dlog's f32 rows into dbias (S is dlog's transpose).
//   3. acc += dlog . B (m64nNk16, B read MN-major from the same tile): each
//      warpgroup owns 64 rows x N <= 256 output columns, 128 registers, so
//      a 64 x 512 output fits the two warpgroups with S computed once.
// d = 512 (kWhole, the flagship): A stays in shared memory and whole B
// tiles are double-buffered, 16-byte cp.async a tile ahead (203 KB, one
// block an SM, 240 registers). Tile t + 1's step 1 is issued right behind
// tile t's step 3, so the two products run back to back on the tensor
// cores, and tile t + 2's copies start as soon as both warpgroups are done
// with tile t. Every other d the gate admits (kStream; d % 128 == 0 up to
// 2432): A and B stream through a ring of 64-column d slices, five steps
// ahead; the block's output chunk (512 columns, or the narrower tail) is a
// grid index and recomputes S, and its walk ends on the chunk's slices,
// which stay in the ring for step 3.
// What bounds it: L2 traffic as much as the products. The dh grid runs row
// tiles fastest, so the blocks of one split read the same W tiles at about
// the same time and HBM serves W about once a split; but every 64-row
// block reads all of its W tiles from L2: 72 x 67 MB = 4.8 GB at the
// flagship shape (dW: 1024 vocab blocks x 4.7 MB of h, also 4.8 GB).
// kStream at d = 1024 reads A and B every tile for each of two chunks,
// 38.6 GB, and takes 8.6-9.1 ms on an H100 (4.2-4.5 TB/s from L2); at that
// rate the flagship's 4.8 GB alone take about 1.1 ms, against the products'
// 0.63 ms at the tensor cores' peak. dh writes one f32 partial per vocab split (sized to
// whole waves by the wrapper); ce_sum_kernel adds them in split order. No
// float atomics anywhere: two calls give bit-identical results.
//
// Backward, f32 (the card checks; no main path runs it): the CUDA-core
// version of the same walk, 32 resident rows, logits and dlog through
// shared memory; D beyond 512 in 512-column slices, each output slice a
// grid index that recomputes the logits and ends its slice walk on its own
// output slice.

#include "vocab_gemm.cuh"

namespace phenaki {
namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int RES = 32;       // resident rows of h (f32 forward, f32 dh) or of W (f32 dW)
constexpr int SLICE = 512;    // d columns staged at a time (all of D up to this)
constexpr int LDR = RES + 8;  // row stride of the dW kernel's (STR x RES) tiles

// the streamed tile of the f32 kernels: vocab ids (forward, dh) or rows of
// h (dW) per step; a block takes 206-218 KB, one an SM
constexpr int STR = 64;

// row padding of a staged (rows, D) f32 operand: the odd stride sends
// column reads to 32 banks
constexpr int PAD = 1;

__host__ __device__ constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ void merge_lse(float& m, float& se, float om, float ose) {
  const float mn = fmaxf(m, om);
  if (mn == -INFINITY) return;
  const float a = (m == -INFINITY) ? 0.f : se * expf(m - mn);
  const float b = (om == -INFINITY) ? 0.f : ose * expf(om - mn);
  se = a + b;
  m = mn;
}

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
__host__ __device__ constexpr int ld_op(int D) { return staged_d(D) + PAD; }

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

// Each f32 kernel is built twice: SLICED = false for D <= 512 (one slice, a
// compile-time constant: the one-operand-resident loop with nothing added),
// SLICED = true beyond.

// ---- f32 forward: one block per (32 rows, vocab split) ----
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

// ---- bf16 forward on wgmma (see the note at the top) ----

struct CEFwd {
  const bf16 *h, *w;  // h: round_up(R, 128) rows
  const float* bias;
  const int* labels;  // (R,)
  float *partials, *label_logit;
  int R, D, V, splits;
};

template <bool H_RESIDENT>
__global__ void __launch_bounds__(PB_THREADS, 1) ce_fwd_wgmma_kernel(const __grid_constant__ CEFwd p) {
  extern __shared__ unsigned char smem_raw[];
  const Walk k = make_walk<H_RESIDENT>(p, smem_raw);
  // this thread's two rows (row0 and row0 + 8): a row past R (h's zero
  // padding) has no label; a running (reference, sum-exp) each in log2
  // units, the reference raised only past PB_RESCALE
  int y[2];
  float m[2], se[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k.row0 + 8 * half;
    y[half] = row < p.R ? p.labels[row] : -1;
    m[half] = -INFINITY;
    se[half] = 0.f;
  }
  auto epilogue = [&](const float (&a)[64], int v0, const float* sbias) {
#pragma unroll
    for (int n = 0; n < PB_BLOCKS; ++n) {
      const float2 b = sbias ? *reinterpret_cast<const float2*>(sbias + 8 * n + 2 * k.c) : make_float2(0.f, 0.f);
      const float x[4] = {a[4 * n] + b.x, a[4 * n + 1] + b.y, a[4 * n + 2] + b.x, a[4 * n + 3] + b.y};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float mx = fmaxf(x[2 * half], x[2 * half + 1]) * LOG2E;
        if (mx - m[half] > PB_RESCALE) {  // rarely: the first values, or a large rise
          se[half] *= ex2(m[half] - mx);
          m[half] = mx;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) se[j >> 1] += ex2(fmaf(x[j], LOG2E, -m[j >> 1]));
    }
    // the label's logit, from the thread whose column holds it, on the one
    // tile of the vocab that holds a row's label
    if ((unsigned)(y[0] - v0) < (unsigned)PB_VT || (unsigned)(y[1] - v0) < (unsigned)PB_VT) {
#pragma unroll
      for (int n = 0; n < PB_BLOCKS; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 8 * n + 2 * k.c + (j & 1);
          if (v0 + col == y[j >> 1])
            p.label_logit[k.row0 + 8 * (j >> 1)] = a[4 * n + j] + (sbias ? sbias[col] : 0.f);
        }
      }
    }
  };
  vocab_walk<H_RESIDENT>(p, k, epilogue);

  // the quad that shares a row merges its four sums; one partial per (row,
  // split), the reference in natural units as ce_merge_kernel reads it
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[half], off);
      const float ose = __shfl_xor_sync(0xffffffffu, se[half], off);
      merge_lse2(m[half], se[half], om, ose);
    }
    const int row = k.row0 + 8 * half;
    if (k.c == 0 && row < p.R) {
      float* out = p.partials + ((size_t)row * p.splits + blockIdx.y) * 2;
      out[0] = m[half] * LN2;
      out[1] = se[half];
    }
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

// ---------------------------------------------------------------------------
// bf16 dh and dW/dbias on wgmma (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int CB_ROWS = 64;                  // resident rows a block; streamed rows a tile
constexpr int CB_THREADS = 2 * WG_THREADS;   // two consumer warpgroups
constexpr int CB_SLICE = CB_ROWS * 128;      // bytes of a 64 x 64 bf16 slice: one SW128 block
constexpr int CB_CHUNK = 512;                // output columns a block owns, at most
constexpr int CB_WHOLE_D = 512;              // kWhole's d
constexpr int CB_AHEAD = 5;                  // kStream: steps loaded ahead
enum Role : int { kDH = 0, kDW = 1 };
// kWhole: d = 512, A resident, whole B tiles double-buffered. kStream: every
// other d, A and B through a ring of 64-column d slices.
enum Mode : int { kWhole = 0, kStream = 1 };

struct CEBwd {
  const bf16 *h, *w;
  const float *bias, *lse, *g;  // bias (V,) or null; lse, g (R,)
  const int* labels;            // (R,)
  float* out;                   // dh: partials (splits, rows_pad, D); dW: (V, D)
  float* db;                    // dW: dbias (V,)
  int R, D, V, splits, rows_pad;
  int chunk0;                   // the output chunk of grid index 0 (chunks are CB_CHUNK wide)
};

// kStream's ring slots: the chunk's slices stay in the ring until step 3
// reads them, with CB_AHEAD more in flight
template <int NW>
__host__ __device__ constexpr int cb_slots() { return 2 * NW / 64 + CB_AHEAD; }

// slots of the tiles' column vectors: a tile's are loaded with its first
// step, CB_AHEAD steps early, and read by its epilogue; kWhole loads a
// tile ahead
__host__ __device__ constexpr int cb_col_slots(int D, int mode) {
  return mode == kWhole ? 2 : 1 + (CB_AHEAD + D / 64 - 1) / (D / 64);
}

// a tile's column vectors in shared memory: dh the bias of its vocab ids;
// dW the lse, g and label of its rows
constexpr int CB_COLS = 3 * CB_ROWS * 4;

// shared memory, from a 1 KB aligned base: kWhole's resident A and two
// whole B tiles, or kStream's ring (a slot holds an A and a B slice); the
// dlog tile; the tiles' column vectors (at the end, the dbias halves)
template <int NW, int MODE>
int cb_smem(int D) {
  const int tiles = MODE == kWhole ? 3 * (CB_WHOLE_D / 64) * CB_SLICE : cb_slots<NW>() * 2 * CB_SLICE;
  return 1024 + tiles + CB_SLICE + cb_col_slots(D, MODE) * CB_COLS;
}

// rows [r0, r0 + 64) x columns [c0, c0 + 64) of a row-major (nrows, D) bf16
// array into one SW128 block; rows past nrows are zeros
__device__ __forceinline__ void cb_load_slice(uint32_t dst, const bf16* src, int r0, int nrows,
                                              int c0, int D) {
#pragma unroll
  for (int it = 0; it < CB_ROWS * 8 / CB_THREADS; ++it) {
    const int e = threadIdx.x + it * CB_THREADS;
    const int r = e >> 3, ch = e & 7;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + r * 128 + ((ch ^ (r & 7)) << 4),
               src + (size_t)(ok ? r0 + r : 0) * D + c0 + ch * 8, ok ? 16 : 0);
  }
}

// Both roles: S = A_res . B_tile^T (64 x 64, each warpgroup 32 of its
// columns), dlog from S in registers into shared memory as bf16, then
// acc += dlog . B_tile[:, the warpgroup's NW output columns]. dh: A = h
// (rows), B = W (vocab ids of the block's split). dW: A = W (vocab ids), B =
// h (every row tile); S is dlog's transpose, and dbias its row sums.
template <int ROLE, int NW, int MODE>
__device__ __forceinline__ void ce_bwd_body(const CEBwd& p, unsigned char* smem_raw) {
  constexpr bool DH = ROLE == kDH;
  constexpr int CS = 2 * NW / 64;  // d slices of the chunk
  constexpr int NST = cb_slots<NW>();
  constexpr int SLOT = 2 * CB_SLICE;  // bytes of a ring slot: its A slice, then its B slice
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int wq = (tid >> 5) & 3, g8 = lane >> 2, c = lane & 3;
  const int NS = p.D / 64;
  const int chunk = p.chunk0 + (DH ? blockIdx.z : blockIdx.y);
  const int cs0 = chunk * (CB_CHUNK / 64);  // the chunk's first d slice
  const bf16* A = DH ? p.h : p.w;
  const bf16* B = DH ? p.w : p.h;
  const int a_rows = DH ? p.R : p.V, b_rows = DH ? p.V : p.R;
  const int a0 = blockIdx.x * CB_ROWS;
  int t_begin = 0, nt = (p.R + CB_ROWS - 1) / CB_ROWS;
  if constexpr (DH) {
    const int T = p.V / CB_ROWS;
    t_begin = blockIdx.y * T / p.splits;
    nt = (blockIdx.y + 1) * T / p.splits - t_begin;
  }

  const uint32_t ares = smem_base_1k(smem_raw);  // kWhole's resident A, and kStream's ring
  const uint32_t tiles = ares + (MODE == kWhole ? NS * CB_SLICE : 0);  // kWhole's two B tiles
  const uint32_t dlog = ares + (MODE == kWhole ? 3 * CS * CB_SLICE : NST * SLOT);
  const int ncols = cb_col_slots(p.D, MODE);
  const uint32_t cols = dlog + CB_SLICE;
  float* red = reinterpret_cast<float*>(smem_raw + (cols - smem_u32(smem_raw)));

  // tile t's column vectors into slot t & 1 (16-byte copies; zeros past R)
  auto load_cols = [&](int t) {
    const int b0 = (t_begin + t) * CB_ROWS, e = tid & 15, row = b0 + 4 * e;
    const uint32_t dst = cols + (t % ncols) * CB_COLS + (tid >> 4) * CB_ROWS * 4 + 16 * e;
    if constexpr (DH) {
      if (tid < 16) cp_async16(dst, p.bias ? p.bias + row : p.lse, p.bias ? 16 : 0);
    } else if (tid < 48) {
      const int bytes = 4 * max(0, min(4, p.R - row));
      const void* src = tid < 16 ? (const void*)p.lse : tid < 32 ? (const void*)p.g : (const void*)p.labels;
      cp_async16(dst, static_cast<const float*>(src) + (bytes ? row : 0), bytes);
    }
  };

  // kWhole: all of tile t's B slices (all of d) to its buffer
  auto load_tile = [&](int t) {
    load_cols(t);
    for (int s = 0; s < CS; ++s)
      cb_load_slice(tiles + (t & 1) * CS * CB_SLICE + s * CB_SLICE, B, (t_begin + t) * CB_ROWS,
                    b_rows, s * 64, p.D);
  };
  // kStream: step i is tile i / NS at d slice slice_of(i); a tile's walk
  // starts after the block's output chunk and ends on it, so that the
  // chunk's B slices are the tile's last CS steps, still in the ring when
  // step 3 reads them
  auto slice_of = [&](int i) { return (cs0 + CS + i % NS) % NS; };
  auto slot = [&](int i) { return ares + (i % NST) * SLOT; };
  auto load_step = [&](int i) {
    const int s = slice_of(i);
    if (i % NS == 0) load_cols(i / NS);
    cb_load_slice(slot(i), A, a0, a_rows, s * 64, p.D);
    cb_load_slice(slot(i) + CB_SLICE, B, (t_begin + i / NS) * CB_ROWS, b_rows, s * 64, p.D);
  };

  // the constants of this thread's two accumulator rows (16 wq + g8 + 8 half)
  // and, per tile, of its eight columns (32 wg + 8 n + 2 c + e)
  const int arow = a0 + 16 * wq + g8;
  float lse2_r[2], g_r[2], bias_r[2];
  int y_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = arow + 8 * half;
    if constexpr (DH) {  // a row past R: no probability, no label, no weight
      const bool ok = r < p.R;
      lse2_r[half] = ok ? p.lse[r] * LOG2E : INFINITY;
      g_r[half] = ok ? p.g[r] : 0.f;
      y_r[half] = ok ? p.labels[r] : -1;
      bias_r[half] = 0.f;
    } else {
      bias_r[half] = p.bias ? p.bias[r] : 0.f;
      lse2_r[half] = g_r[half] = 0.f;
      y_r[half] = -1;
    }
  }
  float dbias[2] = {0.f, 0.f};
  float acc[NW / 2];
#pragma unroll
  for (int x = 0; x < NW / 2; ++x) acc[x] = 0.f;
  float S[16];
#pragma unroll
  for (int x = 0; x < 16; ++x) S[x] = 0.f;

  // dlog = (exp(S + bias - lse) - onehot) g of tile t, rounded to bf16 into
  // the dlog tile (the A operand of step 3, SW128); dW also sums its rows in
  // f32. Ends with the tile visible to both warpgroups' wgmma.
  auto epilogue = [&](int t) {
    const int b0 = (t_begin + t) * CB_ROWS;
    const float* cv = reinterpret_cast<const float*>(red + (t % ncols) * (CB_COLS / 4));
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = 32 * wg + 8 * n + 2 * c;  // this thread's two columns of block n
      float2 cb, cl, cg;
      int2 cy;
      if constexpr (DH) {
        cb = *reinterpret_cast<const float2*>(cv + col);
      } else {
        cl = *reinterpret_cast<const float2*>(cv + col);
        cg = *reinterpret_cast<const float2*>(cv + CB_ROWS + col);
        cy = *reinterpret_cast<const int2*>(cv + 2 * CB_ROWS + col);
      }
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int half = j >> 1, e = j & 1;
        float x, l2, gg;
        bool hot;
        if constexpr (DH) {
          x = S[4 * n + j] + (e ? cb.y : cb.x);
          l2 = lse2_r[half];
          gg = g_r[half];
          hot = b0 + col + e == y_r[half];
        } else {  // a row past R: no probability, no label, no weight
          const bool ok = b0 + col + e < p.R;
          x = S[4 * n + j] + bias_r[half];
          l2 = ok ? (e ? cl.y : cl.x) * LOG2E : INFINITY;
          gg = e ? cg.y : cg.x;
          hot = ok && (e ? cy.y : cy.x) == arow + 8 * half;
        }
        d[j] = (ex2(fmaf(x, LOG2E, -l2)) - (hot ? 1.f : 0.f)) * gg;
        if constexpr (!DH) dbias[half] += d[j];
      }
      const int ch = 4 * wg + n;
      const uint32_t r0 = 16 * wq + g8;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dlog + r0 * 128 + ((ch ^ (r0 & 7)) << 4) + 4 * c),
                   "r"(pack_bf16(d[0], d[1])));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dlog + (r0 + 8) * 128 + ((ch ^ (r0 & 7)) << 4) + 4 * c),
                   "r"(pack_bf16(d[2], d[3])));
    }
    fence_proxy_async();
    __syncthreads();
  };
  // step 3 of tile t: acc += dlog . B_t[:, this warpgroup's NW columns],
  // read MN-major from kWhole's tile buffer, or 64 columns at a time from
  // the ring slots of the tile's last CS steps
  auto issue_p2 = [&](int t) {
    fence_regs(acc);
    wg_fence();
    if constexpr (MODE == kWhole) {
      const uint32_t kb = tiles + (t & 1) * CS * CB_SLICE + wg * (NW / 64) * SW_BLOCK;
#pragma unroll
      for (int kk = 0; kk < CB_ROWS / 16; ++kk)
        wgmma_ss<NW, 1>(acc, kmajor_desc(dlog, kk), mnmajor_desc(kb, kk), 1);
    } else {
      const int q0 = (t + 1) * NS - CS + wg * (NW / 64);  // the step of this warpgroup's first slice
#pragma unroll
      for (int kk = 0; kk < CB_ROWS / 16; ++kk) {
        const uint64_t da = kmajor_desc(dlog, kk);
        wgmma_ss<64, 1, 0>(acc, da, mnmajor_desc(slot(q0) + CB_SLICE, kk), 1);
        if constexpr (NW >= 128) wgmma_ss<64, 1, 32>(acc, da, mnmajor_desc(slot(q0 + 1) + CB_SLICE, kk), 1);
        if constexpr (NW >= 192) wgmma_ss<64, 1, 64>(acc, da, mnmajor_desc(slot(q0 + 2) + CB_SLICE, kk), 1);
        if constexpr (NW >= 256) wgmma_ss<64, 1, 96>(acc, da, mnmajor_desc(slot(q0 + 3) + CB_SLICE, kk), 1);
      }
    }
    wg_commit();
  };

  if constexpr (MODE == kWhole) {
    // Tile t + 1's products run right behind tile t's second product, and
    // tile t + 2's copies start once both warpgroups are done with tile t:
    //   epilogue(t) | P2(t), P1(t + 1) | copies of t + 2 | wait P1(t + 1)
    // The last pass's P1 reads a stale buffer and is discarded.
    auto issue_p1 = [&](int t) {
      // bases the compiler cannot hoist, so that it computes the 64
      // descriptors per call instead of holding them in registers
      uint32_t ab = ares, kb = tiles + (t & 1) * CS * CB_SLICE;
      asm volatile("" : "+r"(ab), "+r"(kb));
      fence_regs(S);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < CB_WHOLE_D / 16; ++kk)
        wgmma_ss<32, 0>(S, kmajor_desc(ab, kk), kmajor_desc(kb + wg * 32 * 128, kk), kk > 0);
      wg_commit();
    };
    for (int s = 0; s < NS; ++s) cb_load_slice(ares + s * CB_SLICE, A, a0, a_rows, s * 64, p.D);
    load_tile(0);
    cp_async_commit();
    if (nt > 1) load_tile(1);
    cp_async_commit();
    cp_async_wait<1>();  // A and tile 0
    fence_proxy_async();
    __syncthreads();
    issue_p1(0);
    wg_wait<0>();
    fence_regs(S);
    for (int t = 0; t < nt; ++t) {
      epilogue(t);
      issue_p2(t);
      cp_async_wait<0>();  // tile t + 1
      fence_proxy_async();
      __syncthreads();
      issue_p1(t + 1);
      wg_wait<1>();  // P2(t)
      fence_regs(acc);
      __syncthreads();  // both warpgroups are done with tile t's buffer and the dlog tile
      if (t + 2 < nt) load_tile(t + 2);
      cp_async_commit();
      wg_wait<0>();
      fence_regs(S);
    }
  } else {
    const int total = nt * NS;
#pragma unroll
    for (int i = 0; i < CB_AHEAD; ++i) {
      if (i < total) load_step(i);
      cp_async_commit();
    }
    for (int t = 0; t < nt; ++t) {
      for (int k = 0; k < NS; ++k) {
        const int i = t * NS + k;
        cp_async_wait<CB_AHEAD - 1>();  // step i has landed
        fence_proxy_async();
        // everyone's copies; step i - 2's products are done, and so is the
        // previous tile's step 3: the slot step i + CB_AHEAD takes is free
        __syncthreads();
        if (i + CB_AHEAD < total) load_step(i + CB_AHEAD);
        cp_async_commit();
        const uint32_t as = slot(i), bs = slot(i) + CB_SLICE + wg * 32 * 128;
        fence_regs(S);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<32, 0>(S, kmajor_desc(as, kk), kmajor_desc(bs, kk), k > 0 || kk > 0);
        wg_commit();
        wg_wait<1>();
      }
      wg_wait<0>();
      fence_regs(S);
      epilogue(t);
      issue_p2(t);
      wg_wait<0>();
      fence_regs(acc);
    }
  }
  cp_async_wait<0>();

  // the block's (64 x NW) f32 output columns of this warpgroup
  float* out = DH ? p.out + ((size_t)blockIdx.y * p.rows_pad + a0) * p.D : p.out + (size_t)a0 * p.D;
  out += cs0 * 64 + wg * NW;
#pragma unroll
  for (int n = 0; n < NW / 8; ++n) {
    const int col = 8 * n + 2 * c;
    *reinterpret_cast<float2*>(out + (size_t)(16 * wq + g8) * p.D + col) = make_float2(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(16 * wq + g8 + 8) * p.D + col) =
        make_float2(acc[4 * n + 2], acc[4 * n + 3]);
  }
  if constexpr (!DH) {
    // dbias: the quad's four sums, then the two warpgroups', in a fixed order
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      dbias[half] += __shfl_xor_sync(0xffffffffu, dbias[half], 1);
      dbias[half] += __shfl_xor_sync(0xffffffffu, dbias[half], 2);
      if (c == 0) red[wg * CB_ROWS + 16 * wq + g8 + 8 * half] = dbias[half];
    }
    __syncthreads();
    if (chunk == 0 && tid < CB_ROWS) p.db[a0 + tid] = red[tid] + red[CB_ROWS + tid];
  }
}

template <int NW, int MODE>
__global__ void __launch_bounds__(CB_THREADS, 1) ce_dh_wgmma_kernel(const __grid_constant__ CEBwd p) {
  extern __shared__ unsigned char smem_raw[];
  ce_bwd_body<kDH, NW, MODE>(p, smem_raw);
}

template <int NW, int MODE>
__global__ void __launch_bounds__(CB_THREADS, 1) ce_dw_wgmma_kernel(const __grid_constant__ CEBwd p) {
  extern __shared__ unsigned char smem_raw[];
  ce_bwd_body<kDW, NW, MODE>(p, smem_raw);
}

// one launch over `chunks` output chunks of width 2 NW from chunk0
template <int ROLE, int NW, int MODE>
cudaError_t launch_bwd_chunks(CEBwd p, int chunk0, int chunks, cudaStream_t s) {
  auto kern = ROLE == kDH ? ce_dh_wgmma_kernel<NW, MODE> : ce_dw_wgmma_kernel<NW, MODE>;
  const int smem = cb_smem<NW, MODE>(p.D);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.chunk0 = chunk0;
  const dim3 grid = ROLE == kDH ? dim3(p.rows_pad / CB_ROWS, p.splits, chunks) : dim3(p.V / CB_ROWS, chunks);
  kern<<<grid, CB_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// the output chunks of one mode: 512 columns each, then the narrower tail
template <int ROLE, int MODE>
cudaError_t launch_mode(const CEBwd& p, cudaStream_t s) {
  const int full = p.D / CB_CHUNK, tail = p.D % CB_CHUNK;
  cudaError_t err = cudaSuccess;
  if (full > 0) err = launch_bwd_chunks<ROLE, CB_CHUNK / 2, MODE>(p, 0, full, s);
  if (err != cudaSuccess || tail == 0) return err;
  switch (tail) {
    case 128: return launch_bwd_chunks<ROLE, 64, MODE>(p, full, 1, s);
    case 256: return launch_bwd_chunks<ROLE, 128, MODE>(p, full, 1, s);
    default: return launch_bwd_chunks<ROLE, 192, MODE>(p, full, 1, s);
  }
}

// d = 512: whole tiles; every other d through the ring
template <int ROLE>
cudaError_t launch_bwd_wgmma(const CEBwd& p, cudaStream_t s) {
  if (!aligned16(p.h) || !aligned16(p.w) || (p.bias && !aligned16(p.bias)) || !aligned16(p.lse) ||
      !aligned16(p.g) || !aligned16(p.labels))
    return cudaErrorMisalignedAddress;
  if (p.D == CB_WHOLE_D) return launch_bwd_chunks<ROLE, CB_CHUNK / 2, kWhole>(p, 0, 1, s);
  return launch_mode<ROLE, kStream>(p, s);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the shapes the wrapper's gate (can_fuse_ce) admits: d % 128 == 0 and a
// vocab of 512-wide blocks
bool shape_ok(int R, int D, int V, int dtype) {
  return R > 0 && D > 0 && D % 128 == 0 && V > 0 && V % 512 == 0 && (dtype == kBF16 || dtype == kF32);
}

template <bool SLICED>
cudaError_t launch_fwd_f32(const CE& a, int splits, float* partials, float* label_logit, cudaStream_t s) {
  const int ntiles = a.V / STR;
  const int per = (ntiles + splits - 1) / splits;
  const size_t smem = rows_smem<float>(a.D, false);
  cudaError_t err = allow_smem(ce_fwd_kernel<float, SLICED>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.R + RES - 1) / RES, splits);
  ce_fwd_kernel<float, SLICED><<<grid, THREADS, smem, s>>>(a, per, partials, label_logit);
  return cudaGetLastError();
}

// bf16: h resident in shared memory up to d = 512, streamed beside W past it
cudaError_t launch_fwd_wgmma(const CE& a, int splits, float* partials, float* label_logit,
                             cudaStream_t s) {
  const CEFwd p{(const bf16*)a.h, (const bf16*)a.w, a.bias, a.labels, partials, label_logit, a.R, a.D,
                a.V, splits};
  if (!aligned16(p.h) || !aligned16(p.w) || (p.bias && !aligned16(p.bias)))
    return cudaErrorMisalignedAddress;
  const int NS = a.D / PB_KS;
  const bool res = NS <= PB_RESIDENT_NS;
  const int smem = res ? pb_smem<true>(NS) : pb_smem<false>(NS);
  auto kern = res ? ce_fwd_wgmma_kernel<true> : ce_fwd_wgmma_kernel<false>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((a.R + PB_ROWS - 1) / PB_ROWS, splits), PB_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool SLICED>
cudaError_t launch_dh_f32(const CE& a, int splits, int rows_pad, float* partials, cudaStream_t s) {
  const int ntiles = a.V / STR;
  const int per = (ntiles + splits - 1) / splits;
  const size_t smem = rows_smem<float>(a.D, true);
  cudaError_t err = allow_smem(ce_dh_kernel<float, SLICED>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows_pad / RES, splits, num_slices(a.D));
  ce_dh_kernel<float, SLICED><<<grid, THREADS, smem, s>>>(a, per, rows_pad, partials);
  return cudaGetLastError();
}

// dh = the splits' partials (splits, rows_pad, D) added in split order
cudaError_t sum_partials(const CE& a, int splits, int rows_pad, const float* partials, float* dh,
                         cudaStream_t s) {
  const size_t n4 = (size_t)a.R * a.D / 4;
  const int blocks = (int)((n4 + THREADS - 1) / THREADS < 4096 ? (n4 + THREADS - 1) / THREADS : 4096);
  ce_sum_kernel<<<blocks, THREADS, 0, s>>>(reinterpret_cast<const float4*>(partials), splits,
                                           (size_t)rows_pad * a.D / 4, n4,
                                           reinterpret_cast<float4*>(dh));
  return cudaGetLastError();
}

template <bool SLICED>
cudaError_t launch_dw_f32(const CE& a, float* dw, float* db, cudaStream_t s) {
  const size_t smem = vocab_smem<float>(a.D);
  cudaError_t err = allow_smem(ce_dw_kernel<float, SLICED>, smem);
  if (err != cudaSuccess) return err;
  ce_dw_kernel<float, SLICED><<<dim3(a.V / RES, num_slices(a.D)), THREADS, smem, s>>>(a, dw, db);
  return cudaGetLastError();
}

}  // namespace
}  // namespace phenaki

// h (R, D) and w (V, D) in one dtype; bias (V,) f32 or null; labels (R,)
// int32; D % 128 == 0, V % 512 == 0. Outputs loss and lse (R,) f32;
// label_logit (R,) and partials (R, splits, 2) are f32 scratch. bf16: h
// holds round_up(R, 128) rows (zeros past R), h, w and the bias start on 16
// bytes (else cudaErrorMisalignedAddress), 1 <= splits <= V / 128.
extern "C" int fused_ce_fwd(const void* h, const void* w, const void* bias, const void* labels,
                            void* loss, void* lse, void* label_logit, void* partials, int R,
                            int D, int V, int splits, int dtype, void* stream) {
  using namespace phenaki;
  if (!shape_ok(R, D, V, dtype) || splits < 1 || (dtype == kBF16 && splits > V / PB_VT))
    return cudaErrorInvalidValue;
  const CE a{h, w, (const float*)bias, (const int*)labels, nullptr, nullptr, R, D, V};
  cudaStream_t s = (cudaStream_t)stream;
  float *p = (float*)partials, *ll = (float*)label_logit;
  cudaError_t err;
  if (dtype == kBF16)
    err = launch_fwd_wgmma(a, splits, p, ll, s);
  else
    err = num_slices(D) > 1 ? launch_fwd_f32<true>(a, splits, p, ll, s) : launch_fwd_f32<false>(a, splits, p, ll, s);
  if (err != cudaSuccess) return err;
  ce_merge_kernel<<<(R + THREADS - 1) / THREADS, THREADS, 0, s>>>(p, ll, a.labels, R, V, splits,
                                                                  (float*)loss, (float*)lse);
  return cudaGetLastError();
}

// lse and g (R,) f32; dh (R, D) f32; partials (splits, rows_pad, D) f32
// scratch, rows_pad = round_up(R, 64); 1 <= splits <= V / 64
extern "C" int fused_ce_bwd_dh(const void* h, const void* w, const void* bias,
                               const void* labels, const void* lse, const void* g, void* dh,
                               void* partials, int R, int D, int V, int splits, int rows_pad,
                               int dtype, void* stream) {
  using namespace phenaki;
  if (!shape_ok(R, D, V, dtype) || splits < 1 || splits > V / CB_ROWS ||
      rows_pad != (R + CB_ROWS - 1) / CB_ROWS * CB_ROWS)
    return cudaErrorInvalidValue;
  const CE a{h, w, (const float*)bias, (const int*)labels, (const float*)lse, (const float*)g,
             R, D, V};
  cudaStream_t s = (cudaStream_t)stream;
  float* part = (float*)partials;
  cudaError_t err;
  if (dtype == kBF16) {
    const CEBwd p{(const bf16*)h, (const bf16*)w, a.bias, a.lse, a.g, a.labels, part, nullptr,
                  R, D, V, splits, rows_pad, 0};
    err = launch_bwd_wgmma<kDH>(p, s);
  } else {
    err = num_slices(D) > 1 ? launch_dh_f32<true>(a, splits, rows_pad, part, s)
                            : launch_dh_f32<false>(a, splits, rows_pad, part, s);
  }
  if (err != cudaSuccess) return err;
  return sum_partials(a, splits, rows_pad, part, (float*)dh, s);
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
  if (dtype == kBF16) {
    const CEBwd p{(const bf16*)h, (const bf16*)w, a.bias, a.lse, a.g, a.labels, (float*)dw,
                  (float*)db, R, D, V, 1, 0, 0};
    return launch_bwd_wgmma<kDW>(p, s);
  }
  return num_slices(D) > 1 ? launch_dw_f32<true>(a, (float*)dw, (float*)db, s)
                           : launch_dw_f32<false>(a, (float*)dw, (float*)db, s);
}
