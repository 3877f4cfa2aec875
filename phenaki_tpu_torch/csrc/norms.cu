// The trunk's normalisations on Hopper (sm_90a): LayerNorm in one pass, and
// the attention's q/k l2norm with its per-dim scales fused into the head split.
//
// Replaces no TPU kernel: the TPU package leaves both to XLA, which fuses
// them (phenaki_tpu/ops/norms.py, phenaki_tpu/ops/attention.py). The port ran
// them as chains of eager PyTorch passes: LayerNorm as x.float(), var_mean,
// sub, a broadcast multiply by rsqrt, one by gamma, the beta add and the cast
// back, about 40 bytes moved an element against the 4 of one bf16 pass; the
// q/k l2norm on the transposed (b, h, n, d) views of the projection's output,
// f32 square, sum, rsqrt, multiply, cast and the scale's multiply, then
// flash attention's copy of q, k and the strided v, and the cross-attention's
// concatenation of its null key/values. At the MaskGit's guided forward
// (128 rows of 288 tokens, d = 512) that was about 5.6 GB a layer a step.
//
// What bounds both on the H100: bytes. Each reads every element once and
// writes it once; the arithmetic is a few f32 operations an element.
//
// layernorm_kernel: a row held in registers by one warp (rows up to 32 * 8
// 16-byte vectors, 4 KB: the trunk's 512 and 768) or by a block of eight warps
// (up to 256 * 8 vectors, 32 KB: the C-ViViT's patch norms, 3072 and 6144 wide
// at patch 32), NV 16-byte vectors a thread. The mean and the biased variance
// are taken in f32 in two passes over the registers (no cancellation), then
// out = (x - mean) * rsqrt(var + eps) * gamma (+ beta), rounded once to x's
// type: the plain version's operations in its order, only its sums in another.
//
// qk_norm_split_kernel: one head row (d values of one token and head) to L
// lanes (a power of two, d * sizeof(T) <= 32 * 16 bytes), one 16-byte vector
// a lane; a row's sum of squares is reduced across its lanes by shuffles. It
// reads q, k and v in the projection's (b, n, h * d) layout through their
// strides (column slices of the fused [q | k | v] output need no copy), and
// writes contiguous (b, h, seq, d) q, k and v, with the learned null
// key/values (h, num_null, d) as the first num_null rows of every batch row's
// keys. q and k become x * rsqrt(max(sum x^2, 1e-24)) * scale, the scale
// rounded to x's type as the plain version casts it, in f32 and rounded once;
// the plain version rounds twice (after the l2norm, and after the scale's
// multiply), so the two differ by at most one ulp of x's type. v is copied.
// A head row is one 128-byte line at d = 64 in bf16 on both sides, so every
// access is whole lines.

#include <cuda_fp16.h>

#include "common.cuh"

namespace phenaki {
namespace {

constexpr int kF16 = 2;         // the norms also take float16
constexpr int LN_THREADS = 256; // a block of layernorm_kernel: eight warps
constexpr int LN_MAX_VECS = 8;  // 16-byte vectors a thread holds of a row
constexpr int QK_THREADS = 256;

// 16 bytes as N values of T, unpacked to and packed from f32
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4 r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ static float round(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4 r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t bits(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
  __device__ static uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits(v[2 * i]) | (bits(v[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

template <>
struct Pack<__half> {
  static constexpr int N = 8;
  __device__ static float half_at(uint32_t bits16) {
    return __half2float(__ushort_as_half((unsigned short)bits16));
  }
  __device__ static void unpack(const uint4 r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = half_at(w[i] & 0xffffu);
      v[2 * i + 1] = half_at(w[i] >> 16);
    }
  }
  __device__ static uint32_t bits(float v) { return __half_as_ushort(__float2half_rn(v)); }
  __device__ static uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits(v[2 * i]) | (bits(v[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float round(float v) { return __half2float(__float2half_rn(v)); }
};

// a parameter (gamma, beta, a q/k scale) as f32, whatever its type
__device__ __forceinline__ float param_at(const void* p, int dtype, int i) {
  if (dtype == kF32) return static_cast<const float*>(p)[i];
  if (dtype == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ uint4 load16(const void* p) { return *static_cast<const uint4*>(p); }
__device__ __forceinline__ void store16(void* p, const uint4 v) { *static_cast<uint4*>(p) = v; }

struct LnArgs {
  const void* x;
  const void* gamma;
  const void* beta;  // null: none
  void* out;
  long long rows, x_stride, out_stride;  // row strides in elements
  int d, param_dtype;
  float eps;
};

// a sum over the W warps that hold a row: shuffles within each warp, then,
// for W > 1 (the whole block), the warps' partial sums through shared memory
template <int W>
__device__ __forceinline__ float row_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (W > 1) {
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
    __syncthreads();
    v = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) v += partial[w];
    __syncthreads();  // partial is written again by the next sum
  }
  return v;
}

// W warps a row (1: eight rows a block; 8: one row a block); thread t of a
// row's 32 * W holds the row's 16-byte vectors t, t + 32 * W, ...
template <typename T, int NV, int W>
__global__ void __launch_bounds__(LN_THREADS) layernorm_kernel(const LnArgs a) {
  using P = Pack<T>;
  constexpr int VEC = P::N;
  constexpr int GROUP = 32 * W;
  __shared__ float partial[W];
  const int tid = threadIdx.x % GROUP;
  const long long row = (long long)blockIdx.x * (LN_THREADS / GROUP) + threadIdx.x / GROUP;
  if (row >= a.rows) return;  // all 32 * W threads of the row: whole warps, or the whole block
  const int nvec = a.d / VEC;
  const T* x = static_cast<const T*>(a.x) + row * a.x_stride;
  uint4 raw[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = tid + GROUP * k;
    raw[k] = i < nvec ? load16(x + (long long)i * VEC) : make_uint4(0u, 0u, 0u, 0u);
  }
  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    P::unpack(raw[k], v[k]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum += v[k][j];
  }
  const float mean = row_sum<W>(sum, partial) / (float)a.d;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (tid + GROUP * k < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float c = v[k][j] - mean;
        sq += c * c;
      }
    }
  }
  const float r = rsqrtf(row_sum<W>(sq, partial) / (float)a.d + a.eps);
  T* out = static_cast<T*>(a.out) + row * a.out_stride;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = tid + GROUP * k;
    if (i < nvec) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c = i * VEC + j;
        o[j] = (v[k][j] - mean) * r * param_at(a.gamma, a.param_dtype, c);
        if (a.beta != nullptr) o[j] += param_at(a.beta, a.param_dtype, c);
      }
      store16(out + (long long)i * VEC, P::pack(o));
    }
  }
}

template <typename T, int NV, int W>
cudaError_t launch_ln(const LnArgs& a, cudaStream_t s) {
  constexpr int rows_a_block = LN_THREADS / (32 * W);
  const long long blocks = (a.rows + rows_a_block - 1) / rows_a_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  layernorm_kernel<T, NV, W><<<(unsigned)blocks, LN_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// a warp a row up to 32 * LN_MAX_VECS vectors, NV as the row needs; wider
// rows a block each, NV rounded up to 2, 4 or 8
template <typename T>
cudaError_t dispatch_ln(const LnArgs& a, cudaStream_t s) {
  const int nvec = a.d / Pack<T>::N;
  switch ((nvec + 31) / 32) {
    case 1: return launch_ln<T, 1, 1>(a, s);
    case 2: return launch_ln<T, 2, 1>(a, s);
    case 3: return launch_ln<T, 3, 1>(a, s);
    case 4: return launch_ln<T, 4, 1>(a, s);
    case 5: return launch_ln<T, 5, 1>(a, s);
    case 6: return launch_ln<T, 6, 1>(a, s);
    case 7: return launch_ln<T, 7, 1>(a, s);
    case 8: return launch_ln<T, 8, 1>(a, s);
    default: break;
  }
  const int nv = (nvec + LN_THREADS - 1) / LN_THREADS;
  if (nv <= 2) return launch_ln<T, 2, LN_THREADS / 32>(a, s);
  if (nv <= 4) return launch_ln<T, 4, LN_THREADS / 32>(a, s);
  if (nv <= LN_MAX_VECS) return launch_ln<T, LN_MAX_VECS, LN_THREADS / 32>(a, s);
  return cudaErrorInvalidValue;
}

struct QkArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* null_k;  // (h, num_null, d) rows ns1 apart, heads ns0 apart; null when num_null = 0
  const void* null_v;
  const void* q_scale;
  const void* k_scale;
  void* q_out;  // (b, h, n, d)
  void* k_out;  // (b, h, num_null + m, d)
  void* v_out;
  long long qs0, qs1, ks0, ks1, vs0, vs1, ns0, ns1;  // strides of (b, token) and of the nulls (head, row)
  long long q_rows, kv_rows;  // head rows: b * n * h, b * (num_null + m) * h
  int n, m, num_null, h, d, scale_dtype;
};

// one head row to L lanes: q and k rows l2-normalised and scaled, v rows copied
template <typename T, int L>
__global__ void __launch_bounds__(QK_THREADS) qk_norm_split_kernel(const QkArgs a) {
  using P = Pack<T>;
  constexpr int VEC = P::N;
  const long long g = ((long long)blockIdx.x * QK_THREADS + threadIdx.x) / L;
  const int lane = threadIdx.x % L;
  const int role = g < a.q_rows ? 0 : (g < a.q_rows + a.kv_rows ? 1 : 2);  // q, k, v
  const long long item = role == 0 ? g : (role == 1 ? g - a.q_rows : g - a.q_rows - a.kv_rows);
  const bool on = (role < 2 || item < a.kv_rows) && lane * VEC < a.d;
  const int seq = role == 0 ? a.n : a.num_null + a.m;
  const int hh = (int)(item % a.h);
  const long long bt = item / a.h;
  const int t = (int)(bt % seq);
  const long long bi = bt / seq;
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (on) {
    const T* src;
    if (role == 0) {
      src = static_cast<const T*>(a.q) + bi * a.qs0 + t * a.qs1 + (long long)hh * a.d;
    } else if (t < a.num_null) {
      src = static_cast<const T*>(role == 1 ? a.null_k : a.null_v) + hh * a.ns0 + t * a.ns1;
    } else if (role == 1) {
      src = static_cast<const T*>(a.k) + bi * a.ks0 + (long long)(t - a.num_null) * a.ks1 + (long long)hh * a.d;
    } else {
      src = static_cast<const T*>(a.v) + bi * a.vs0 + (long long)(t - a.num_null) * a.vs1 + (long long)hh * a.d;
    }
    raw = load16(src + lane * VEC);
  }
  float v[VEC];
  P::unpack(raw, v);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) ss += v[j] * v[j];
  // every lane of the warp takes part; L-lane groups start on multiples of L
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (!on) return;
  void* out = role == 0 ? a.q_out : (role == 1 ? a.k_out : a.v_out);
  T* dst = static_cast<T*>(out) + ((bi * a.h + hh) * seq + t) * (long long)a.d + lane * VEC;
  if (role == 2) {
    store16(dst, raw);
    return;
  }
  const float r = rsqrtf(fmaxf(ss, 1e-24f));
  const void* scale = role == 0 ? a.q_scale : a.k_scale;
  float o[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) o[j] = v[j] * r * P::round(param_at(scale, a.scale_dtype, lane * VEC + j));
  store16(dst, P::pack(o));
}

template <typename T, int L>
cudaError_t launch_qk(const QkArgs& a, cudaStream_t s) {
  const long long threads = (a.q_rows + 2 * a.kv_rows) * L;
  const long long blocks = (threads + QK_THREADS - 1) / QK_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  qk_norm_split_kernel<T, L><<<(unsigned)blocks, QK_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_qk(const QkArgs& a, cudaStream_t s) {
  const int lanes = a.d / Pack<T>::N;
  if (lanes <= 1) return launch_qk<T, 1>(a, s);
  if (lanes <= 2) return launch_qk<T, 2>(a, s);
  if (lanes <= 4) return launch_qk<T, 4>(a, s);
  if (lanes <= 8) return launch_qk<T, 8>(a, s);
  if (lanes <= 16) return launch_qk<T, 16>(a, s);
  if (lanes <= 32) return launch_qk<T, 32>(a, s);
  return cudaErrorInvalidValue;
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool known(int dtype) { return dtype == kF32 || dtype == kBF16 || dtype == kF16; }

int vec_of(int dtype) { return dtype == kF32 ? 4 : 8; }

}  // namespace
}  // namespace phenaki

// x and out rows of d values of one dtype (0 = f32, 1 = bf16, 2 = f16), unit
// column stride, rows x_stride and out_stride elements apart; gamma and beta
// (d,) of param_dtype, beta null for none. Writes
// out = (x - mean) * rsqrt(var + eps) * gamma (+ beta) row by row. x, out, d
// and the row strides on 16 bytes; d at most 256 * 8 16-byte vectors (32 KB).
extern "C" int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* out,
                              long long rows, int d, long long x_stride, long long out_stride, float eps,
                              int dtype, int param_dtype, void* stream) {
  using namespace phenaki;
  if (rows <= 0 || d <= 0 || !known(dtype) || !known(param_dtype)) return cudaErrorInvalidValue;
  const int vec = vec_of(dtype);
  if (d % vec || x_stride % vec || out_stride % vec || !aligned(x) || !aligned(out))
    return cudaErrorMisalignedAddress;
  if (d / vec > LN_THREADS * LN_MAX_VECS) return cudaErrorInvalidValue;
  const LnArgs a{x, gamma, beta, out, rows, x_stride, out_stride, d, param_dtype, eps};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16) return dispatch_ln<__nv_bfloat16>(a, s);
  if (dtype == kF16) return dispatch_ln<__half>(a, s);
  return dispatch_ln<float>(a, s);
}

// q (b, n, h * d), k and v (b, m, h * d), each with a unit column stride and
// its (b, token) strides; null_k and null_v (h, num_null, d) with strides
// (ns0, ns1), null when num_null = 0; q_scale and k_scale (d,) of
// scale_dtype. Writes q_out (b, h, n, d), k_out and v_out
// (b, h, num_null + m, d), contiguous: q and k l2-normalised over d and
// scaled, the nulls first along the keys. Every pointer and stride on 16
// bytes; d at most 32 16-byte vectors.
extern "C" int qk_norm_split(const void* q, const void* k, const void* v, const void* null_k,
                             const void* null_v, const void* q_scale, const void* k_scale, void* q_out,
                             void* k_out, void* v_out, int b, int n, int m, int num_null, int h, int d,
                             long long qs0, long long qs1, long long ks0, long long ks1, long long vs0,
                             long long vs1, long long ns0, long long ns1, int dtype, int scale_dtype,
                             void* stream) {
  using namespace phenaki;
  if (b <= 0 || n <= 0 || m < 0 || num_null < 0 || num_null + m <= 0 || h <= 0 || d <= 0 ||
      !known(dtype) || !known(scale_dtype))
    return cudaErrorInvalidValue;
  const int vec = vec_of(dtype);
  if (d / vec > 32) return cudaErrorInvalidValue;
  bool ok = d % vec == 0 && qs0 % vec == 0 && qs1 % vec == 0 && ks0 % vec == 0 && ks1 % vec == 0 &&
            vs0 % vec == 0 && vs1 % vec == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(q_out) &&
            aligned(k_out) && aligned(v_out);
  if (num_null > 0) ok = ok && ns0 % vec == 0 && ns1 % vec == 0 && aligned(null_k) && aligned(null_v);
  if (!ok) return cudaErrorMisalignedAddress;
  const QkArgs a{q, k, v, null_k, null_v, q_scale, k_scale, q_out, k_out, v_out,
                 qs0, qs1, ks0, ks1, vs0, vs1, ns0, ns1,
                 (long long)b * n * h, (long long)b * (num_null + m) * h,
                 n, m, num_null, h, d, scale_dtype};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16) return dispatch_qk<__nv_bfloat16>(a, s);
  if (dtype == kF16) return dispatch_qk<__half>(a, s);
  return dispatch_qk<float>(a, s);
}
