// Fused vocab projection + tempered gumbel sampling + re-mask score on
// Hopper (sm_90a).
//
// Replaces the TPU kernel phenaki_tpu/ops/pallas_sampling.py::_proj_kernel
// (reached from project_gumbel_sample_with_score -> pl.pallas_call). Per row
// r of h (rows, d) over the vocab V:
//   logits = h[r] @ W^T + bias                 (W is the (V, d) Linear weight)
//   u      = a uniform in [0, 1) from Philox, or the injected noise[r, v]
//   g      = -log(-log(u + 1e-10) + 1e-10)
//   y      = logits / max(T, 1e-10) + g
//   id     = argmax y   (ties -> lowest id, like jnp.argmax)
//   score  = 1 - exp(logits[id] - max logits) / sum exp(logits - max)
// The (rows, V) logits never reach device memory.
//
// What bounds it on the H100, at the flagship decode step (h (1152, 512)
// bf16, W (65536, 512) bf16): the products are 2 rows d V = 77.3 GFLOP,
// 0.078 ms at 989 TFLOP/s, against 68.6 MB of operands (0.020 ms at 3.35
// TB/s; the injected f32 noise of the testing hook adds 302 MB, 0.111 ms).
// Behind the products comes the epilogue, 75.5 M logits: per logit two logs
// and one exp on the multi-function unit (about 0.06 ms at 16 a clock an
// SM) and, with a Philox call for four logits, tens of instructions, so it
// is bound by instruction issue more than the products are by the tensor
// cores.
//
// The design (bf16: proj_wgmma_kernel). The TPU kernel carried its running
// statistics across a sequential vocab grid axis; Hopper blocks run in no
// order, so the vocab is cut into S splits and the work is two launches.
// Steps 1, 2 and 4 are the main loop of vocab_gemm.cuh, which the fused CE
// forward (kernel 7) shares; step 3 is this kernel's epilogue:
//  1. A block (two warpgroups, 256 threads) owns 128 rows of h (64 a
//     warpgroup) and one split, and walks the split's 128-id vocab tiles.
//     The grid is (row tiles, S), row tiles fastest, so the blocks of one
//     split read the same W tiles at about the same time and W comes from
//     HBM about once; the wrapper picks S so that the grid fills one wave
//     (9 x 14 = 126 blocks at 1152 rows on 132 SMs).
//  2. d streams through a ring of PB_STAGES shared-memory stages of 64-
//     column slices (16 KB of W a stage), filled with 16-byte cp.async in
//     the 128-byte swizzle a TMA copy would write; the products are wgmma
//     m64n128k16 with both operands in shared memory (W is a K-major B: its
//     rows are vocab ids, d contiguous). Up to d = 512 the block's rows of h
//     stay in shared memory (128 KB; 211 KB in all), so L2 serves W once a
//     row tile and h once a split: 9 x 67 MB + 14 x 1.2 MB = 0.62 GB a
//     flagship call (the WMMA kernel read 1.2 GB). Past that h streams
//     through the ring beside W (every d the gate admits, d % 128 == 0, runs
//     here; 2.4 GB from L2 at d = 1024).
//  3. The epilogue runs on the accumulator registers (wgmma.cuh layout: a
//     thread holds rows g, g + 8 at columns 8 n + 2 c, 8 n + 2 c + 1): the
//     bias, staged a tile at a time into shared memory with the ring; one
//     Philox call for the four values of an 8-column block; the gumbel
//     transform with lg2.approx; the sum-exp with one ex2.approx a value
//     against a reference that moves only when passed by 2^64. Each thread
//     keeps a running (best y, id, chosen logit, reference, sum-exp) for its
//     two rows across the whole split; the quad that shares a row merges
//     them once, at the end, and writes one partial per (row, split).
//  4. Overlap: two accumulators (2 x 64 f32 a thread, 255 registers, one
//     block an SM). A pass issues tile t's products slice by slice, then
//     runs tile t - 1's epilogue, which overlaps only the last slice in
//     flight. Spreading the epilogue over the slices in 2, 4, 8 or 16
//     shares, two groups of wgmma in flight, and four warpgroups of
//     m64n64 tiles (more warps, half the accumulators each) were all
//     measured slower: the epilogue wants its sixteen column blocks in one
//     stretch of code (instruction-level parallelism), and the products'
//     own loop (barrier, copies) leaves little to hide it under.
//  Then proj_merge_kernel: one warp per row folds the S partials in split
//  order with the same (y desc, id asc) order, so ties go to the lowest id,
//  and the online max/sum-exp rule. No float atomics.
//
// The noise: Philox-4x32-10 keyed by the seed, counter (v / 2, row & ~8),
// words (x, y) for row & ~8 and (z, w) for row | 8 at ids v & ~1 and v | 1,
// u = (word >> 9) * 2^-23: a function of (seed, row, vocab id) alone, so a
// seed's sample depends on neither the tiling nor S. The `noise` hook reads
// (rows, V) f32 uniforms in the accumulator layout instead.
//
// f32 (proj_partials_kernel, the CUDA cores, exact for the card checks; no
// main path runs it): a block owns a 64-id vocab chunk, stages the chunk's W
// in shared memory (d in 512-column slices beyond 768), walks every 64-row
// tile of h and writes one partial per (row, chunk).

#include "vocab_gemm.cuh"

namespace phenaki {
namespace {

constexpr int NPART = 5;  // best y, id bits, chosen logit, max, sum-exp

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

// a uniform in [0, 1) from the top 23 bits, (bits >> 9) * 2^-23, built as
// the mantissa of a float in [1, 2): two ALU operations, no conversion
__device__ __forceinline__ float uniform23(uint32_t bits) {
  return __uint_as_float(0x3f800000u | (bits >> 9)) - 1.0f;
}

// ---------------------------------------------------------------------------
// bf16: the vocab main loop of vocab_gemm.cuh, this kernel's epilogue in
// registers (see the note at the top)
// ---------------------------------------------------------------------------

struct Proj {
  const bf16 *h, *w;
  const float *bias, *noise;
  float* partials;
  int rows, D, V, splits;
  float y_scale;    // log2(e) / max(T, 1e-10): y in log2 units
  uint32_t rk[20];  // Philox's round keys (x, y of rounds 0..9), from the host
};

// Philox-4x32-10 as common.cuh has it, with its round keys read from the
// kernel's parameters (an operand of the XOR, no add a round) and each
// multiply one 32 x 32 -> 64 bit product
__device__ __forceinline__ uint4 philox_rk(uint4 ctr, const uint32_t (&rk)[20]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = (uint64_t)0xD2511F53u * ctr.x, p1 = (uint64_t)0xCD9E8D57u * ctr.z;
    ctr = make_uint4((uint32_t)(p1 >> 32) ^ ctr.y ^ rk[2 * r], (uint32_t)p1,
                     (uint32_t)(p0 >> 32) ^ ctr.w ^ rk[2 * r + 1], (uint32_t)p0);
  }
  return ctr;
}

// a thread's running statistics for its two rows: the best y (log2 units),
// its id and logit; the sum-exp as se = sum 2^(x - m) over x = logit
// log2(e), with m a reference that rises only when an x passes it by more
// than PB_RESCALE (vocab_gemm.cuh), so that a value costs one ex2 and no
// compare against a running max
struct Running {
  float best[2], ch[2], m[2], se[2];
  int id[2];
};

// column block n of the accumulator `a` (vocab ids v0 + 8 n + [0, 8)) into
// the running statistics: four values, rows row0 and row0 + 8 at ids v and
// v + 1, visited in id order for each row; the tile's bias from shared
// memory (sbias, or null)
template <bool NOISE>
__device__ __forceinline__ void fold_block(const Proj& p, Running& st, const float (&a)[64], int n,
                                           int v0, const float* sbias, int row0, int c) {
  const int v = v0 + 8 * n + 2 * c;
  const float2 b = sbias ? *reinterpret_cast<const float2*>(sbias + 8 * n + 2 * c) : make_float2(0.f, 0.f);
  const float lg[4] = {a[4 * n] + b.x, a[4 * n + 1] + b.y, a[4 * n + 2] + b.x, a[4 * n + 3] + b.y};
  float u[4];
  if (NOISE) {  // a row past `rows` (h's zero padding) reads none
    const float2 half_u = make_float2(0.5f, 0.5f);
    const float2 n0 = row0 < p.rows ? __ldg(reinterpret_cast<const float2*>(p.noise + (size_t)row0 * p.V + v)) : half_u;
    const float2 n1 = row0 + 8 < p.rows ? __ldg(reinterpret_cast<const float2*>(p.noise + (size_t)(row0 + 8) * p.V + v)) : half_u;
    u[0] = n0.x;
    u[1] = n0.y;
    u[2] = n1.x;
    u[3] = n1.y;
  } else {
    const uint4 bits = philox_rk(make_uint4((uint32_t)(v >> 1), (uint32_t)row0, 0u, 0u), p.rk);
    u[0] = uniform23(bits.x);
    u[1] = uniform23(bits.y);
    u[2] = uniform23(bits.z);
    u[3] = uniform23(bits.w);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // a new sum-exp reference, rarely: the first values, or one that passes
    // it by more than PB_RESCALE
    const float mx = fmaxf(lg[2 * half], lg[2 * half + 1]) * LOG2E;
    if (mx - st.m[half] > PB_RESCALE) {
      st.se[half] *= ex2(st.m[half] - mx);
      st.m[half] = mx;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int half = j >> 1;
    // -log(u + 1e-10) + 1e-10, then y = (logit / T + gumbel) log2(e)
    const float t = fmaf(lg2(u[j] + 1e-10f), -LN2, 1e-10f);
    const float y = fmaf(lg[j], p.y_scale, -lg2(t));
    const bool better = y > st.best[half];  // ids rise within a thread: ties keep the lowest
    st.best[half] = better ? y : st.best[half];
    st.id[half] = better ? v + (j & 1) : st.id[half];
    st.ch[half] = better ? lg[j] : st.ch[half];
    st.se[half] += ex2(fmaf(lg[j], LOG2E, -st.m[half]));
  }
}

template <bool RES, bool NOISE>
__global__ void __launch_bounds__(PB_THREADS, 1) proj_wgmma_kernel(const __grid_constant__ Proj p) {
  extern __shared__ unsigned char smem_raw[];
  const Walk k = make_walk<RES>(p, smem_raw);
  const int split = blockIdx.y;

  Running st;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    st.best[half] = -INFINITY;
    st.ch[half] = 0.f;
    st.m[half] = -INFINITY;
    st.se[half] = 0.f;
    st.id[half] = 0x7fffffff;
  }
  auto epilogue = [&](const float (&a)[64], int v0, const float* sbias) {
#pragma unroll
    for (int n = 0; n < PB_BLOCKS; ++n) fold_block<NOISE>(p, st, a, n, v0, sbias, k.row0, k.c);
  };
  vocab_walk<RES>(p, k, epilogue);

  // the quad that shares a row merges its four running states; one partial
  // per (row, split)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, st.best[half], off);
      const int oid = __shfl_xor_sync(0xffffffffu, st.id[half], off);
      const float och = __shfl_xor_sync(0xffffffffu, st.ch[half], off);
      const float om = __shfl_xor_sync(0xffffffffu, st.m[half], off);
      const float ose = __shfl_xor_sync(0xffffffffu, st.se[half], off);
      better_of(st.best[half], st.id[half], st.ch[half], ob, oid, och);
      merge_lse2(st.m[half], st.se[half], om, ose);
    }
    const int row = k.row0 + 8 * half;
    if (k.c == 0 && row < p.rows) {
      float* out = p.partials + ((size_t)row * p.splits + split) * NPART;
      out[0] = st.best[half];
      out[1] = __int_as_float(st.id[half]);
      out[2] = st.ch[half];
      out[3] = st.m[half] * LN2;  // natural units, as the merge reads them
      out[4] = st.se[half];
    }
  }
}

cudaError_t launch_wgmma(const Proj& p, cudaStream_t s) {
  if (!aligned16(p.h) || !aligned16(p.w) || (p.bias && !aligned16(p.bias)) ||
      (p.noise && (reinterpret_cast<uintptr_t>(p.noise) & 7)))
    return cudaErrorMisalignedAddress;
  const int NS = p.D / PB_KS;
  const bool res = NS <= PB_RESIDENT_NS;
  const int smem = res ? pb_smem<true>(NS) : pb_smem<false>(NS);
  auto kern = res ? (p.noise ? proj_wgmma_kernel<true, true> : proj_wgmma_kernel<true, false>)
                  : (p.noise ? proj_wgmma_kernel<false, true> : proj_wgmma_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.rows + PB_ROWS - 1) / PB_ROWS, p.splits);
  kern<<<grid, PB_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int RT = 64;        // rows per tile of h
constexpr int VC = 64;        // vocab columns per block: one partial each
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_RESIDENT_D = 768;  // all of d of a W chunk in shared memory (197 KB)
constexpr int SLICE = 512;            // d columns a staged slice holds beyond that

// d columns of the staged W chunk: all of D, or a slice
__host__ __device__ constexpr int staged_d(int D) { return D <= MAX_RESIDENT_D ? D : SLICE; }

// bytes of the W chunk (row stride DC + 1: the tile loads spread over the
// banks), rounded up to 128
__host__ __device__ constexpr size_t w_bytes(int DC) {
  return ((size_t)VC * (DC + 1) * sizeof(float) + 127) / 128 * 128;
}

// Ws[r][c] = w[v0 + r][c0 + c] for the chunk's VC rows, K columns of d
__device__ __forceinline__ void stage_w(float* Ws, int ldw, const float* __restrict__ w, int v0, int c0,
                                        int K, int D) {
  for (int e = threadIdx.x; e < VC * K; e += THREADS) {
    const int r = e / K, c = e % K;
    Ws[r * ldw + c] = w[(size_t)(v0 + r) * D + c0 + c];
  }
}

// thread t owns columns t % 16 + 16 c of rows t / 16 + 16 r of a tile
struct TileLogits {
  float acc[4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[rr][cc] = 0.f;
  }

  // += h[r0 : r0 + RT, col0 : col0 + K] @ Ws[:, :K]^T; h has row stride D
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

__global__ void __launch_bounds__(THREADS)
proj_partials_kernel(const float* __restrict__ h, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ noise,
                     float* __restrict__ partials, int rows, int rows_pad,
                     int D, int V, float inv_temp, uint2 key) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DC = staged_d(D);
  const int ldw = DC + 1;
  float* Ws = reinterpret_cast<float*>(smem_raw);                 // [VC][ldw]
  float* Ls = reinterpret_cast<float*>(smem_raw + w_bytes(DC));  // [RT][VC]

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
    TileLogits tile;
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
      } else {  // the bf16 kernel's stream: counter (v / 2, row & ~8)
        const uint4 bits = philox4x32_10(make_uint4((uint32_t)(gcol >> 1), (uint32_t)(row & ~8), 0u, 0u), key);
        const bool lo = (row & 8) == 0;
        u[0] = uniform23(lo ? bits.x : bits.z);
        u[1] = uniform23(lo ? bits.y : bits.w);
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

cudaError_t launch_partials(const void* h, const void* w, const void* bias, const void* noise,
                            void* partials, int rows, int D, int V, float inv_temp, uint2 key,
                            cudaStream_t s) {
  const size_t smem = w_bytes(staged_d(D)) + sizeof(float) * RT * VC;
  cudaError_t err = cudaFuncSetAttribute(
      proj_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_pad = (rows + RT - 1) / RT * RT;
  proj_partials_kernel<<<V / VC, THREADS, smem, s>>>(
      (const float*)h, (const float*)w, (const float*)bias, (const float*)noise,
      (float*)partials, rows, rows_pad, D, V, inv_temp, key);
  return cudaGetLastError();
}

// one warp a row: the row's partials, in split order, into its id and score
__global__ void __launch_bounds__(THREADS)
proj_merge_kernel(const float* __restrict__ partials, int rows, int nsplits,
                  int* __restrict__ ids, float* __restrict__ score) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + warp;
  if (row >= rows) return;
  float best = -INFINITY, ch = 0.f, m = -INFINITY, se = 0.f;
  int id = 0x7fffffff;
  for (int c = lane; c < nsplits; c += 32) {
    const float* p = partials + ((size_t)row * nsplits + c) * NPART;
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

}  // namespace
}  // namespace phenaki

// h must hold round_up(rows, 128) rows (the wrapper zero-pads it); partials
// holds rows * splits * 5 floats: bf16 takes any 1 <= splits <= V / 128 (one
// partial per row and vocab split), f32 exactly V / 64 (one per 64-id chunk).
extern "C" int proj_sample(const void* h, const void* w, const void* bias,
                           const void* noise, void* ids, void* score,
                           void* partials, int rows, int D, int V, int splits,
                           float temperature, unsigned long long seed,
                           int dtype, void* stream) {
  using namespace phenaki;
  if (rows <= 0 || D <= 0 || D % 128 != 0 || V <= 0 || V % PB_VT != 0)
    return cudaErrorInvalidValue;
  const float inv_temp = 1.f / fmaxf(temperature, 1e-10f);
  const uint2 key = make_uint2((uint32_t)(seed & 0xffffffffull),
                               (uint32_t)(seed >> 32));
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == kBF16) {
    if (splits < 1 || splits > V / PB_VT) return cudaErrorInvalidValue;
    Proj p{(const bf16*)h, (const bf16*)w, (const float*)bias, (const float*)noise,
           (float*)partials, rows, D, V, splits, inv_temp * LOG2E, {}};
    for (int r = 0; r < 10; ++r) {  // philox4x32_10's key schedule
      p.rk[2 * r] = key.x + (uint32_t)r * 0x9E3779B9u;
      p.rk[2 * r + 1] = key.y + (uint32_t)r * 0xBB67AE85u;
    }
    err = launch_wgmma(p, s);
  } else if (dtype == kF32) {
    if (splits != V / VC) return cudaErrorInvalidValue;
    err = launch_partials(h, w, bias, noise, partials, rows, D, V, inv_temp, key, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int warps = THREADS / 32;
  proj_merge_kernel<<<(rows + warps - 1) / warps, THREADS, 0, s>>>(
      (const float*)partials, rows, splits, (int*)ids, (float*)score);
  return cudaGetLastError();
}
