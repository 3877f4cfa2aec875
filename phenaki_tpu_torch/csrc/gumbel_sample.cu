// Tempered gumbel sampling + re-mask score over materialised logits, with
// the classifier-free-guidance combine fused in, on Hopper (sm_90a).
//
// Replaces the TPU kernel phenaki_tpu/ops/pallas_sampling.py::_kernel
// (reached from gumbel_sample_with_score -> pl.pallas_call). Per row r of
// the (rows, V) logits:
//   l     = null + (cond - null) * s   with CFG: cond is row r, null is row
//           r + rows of the same stacked (2 rows, V) buffer; else l = cond
//   u     = (philox_bits >> 8) * 2^-24  or the injected noise[r, v]
//   g     = -log(-log(u + 1e-10) + 1e-10)
//   id    = argmax(l * inv_temp + g)    (ties -> lowest id, like jnp.argmax)
//   score = 1 - exp(l[id] - max l) / sum exp(l - max l)   (untempered l)
// The combined logits are never written back.
//
// What bounds it on the H100: one read of the logits, 302 MB of bf16 cond
// and null rows at the flagship decode step (b = 1, 1152 x 65,536), against
// about 25 operations per logit (two logs and an exp, half a Philox call),
// so device-memory bandwidth first. Design: one block per row and one pass
// over V with 16-byte loads; each thread keeps a running (best y, its id,
// the logit there, max, sum-exp), rescaling its sum-exp once per vector;
// warps merge by shuffles, then the block in warp order, in proj_sample.cu's
// (y desc, id asc) order. The noise is Philox-4x32-10 keyed by the seed with
// counter (v / 4, row), the same stream as proj_sample.cu, so a sample does
// not depend on the tiling. The combine and y are written with __f*_rn
// intrinsics so that no FMA contraction rounds them otherwise than the
// plain version's separate PyTorch ops: with the same uniforms the ids are
// the plain version's.

#include "common.cuh"

namespace phenaki {
namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps

struct Running {
  float y;   // best tempered gumbel value
  int id;    // its vocab id
  float ch;  // the untempered logit there
  float m;   // max logit
  float se;  // sum exp(l - m)
};

__device__ __forceinline__ void better_of(Running& a, float y, int id, float ch) {
  if (y > a.y || (y == a.y && id < a.id)) {
    a.y = y;
    a.id = id;
    a.ch = ch;
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

__device__ __forceinline__ void merge(Running& a, const Running& o) {
  better_of(a, o.y, o.id, o.ch);
  merge_lse(a.m, a.se, o.m, o.se);
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// VEC consecutive values as f32: one 16-byte load, or one scalar (VEC = 1)
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "one 16-byte load");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
  }
}

// VEC f32 noise values from the injected (rows, V) uniforms
template <int VEC>
__device__ __forceinline__ void load_noise(const float* __restrict__ p, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = f.x;
      out[4 * q + 1] = f.y;
      out[4 * q + 2] = f.z;
      out[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = p[i];
  }
}

// the Philox uniforms of vocab ids v0 .. v0 + VEC - 1 of `row`: word v % 4
// of the call with counter (v / 4, row), as proj_sample.cu draws them
template <int VEC>
__device__ __forceinline__ void philox_uniforms(uint2 key, int row, int v0, float (&u)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const uint4 b =
          philox4x32_10(make_uint4((uint32_t)((v0 >> 2) + q), (uint32_t)row, 0u, 0u), key);
      u[4 * q] = uniform24(b.x);
      u[4 * q + 1] = uniform24(b.y);
      u[4 * q + 2] = uniform24(b.z);
      u[4 * q + 3] = uniform24(b.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int v = v0 + i;
      const uint4 b = philox4x32_10(make_uint4((uint32_t)(v >> 2), (uint32_t)row, 0u, 0u), key);
      const int k = v & 3;
      u[i] = uniform24(k == 0 ? b.x : k == 1 ? b.y : k == 2 ? b.z : b.w);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
gumbel_sample_kernel(const T* __restrict__ logits, const float* __restrict__ noise, int rows,
                     int V, float inv_temp, int has_cfg, float scale, uint2 key,
                     int* __restrict__ ids, float* __restrict__ score) {
  const int row = blockIdx.x;
  const T* cond = logits + (size_t)row * V;
  const T* null_row = logits + (size_t)(row + (has_cfg ? rows : 0)) * V;
  const float* nz = noise ? noise + (size_t)row * V : nullptr;

  Running run{-INFINITY, 0x7fffffff, 0.f, -INFINITY, 0.f};
  for (int v0 = threadIdx.x * VEC; v0 < V; v0 += THREADS * VEC) {
    float l[VEC], u[VEC];
    load_f32<T, VEC>(cond + v0, l);
    if (has_cfg) {
      float nl[VEC];
      load_f32<T, VEC>(null_row + v0, nl);
#pragma unroll
      for (int i = 0; i < VEC; ++i) l[i] = __fadd_rn(nl[i], __fmul_rn(__fsub_rn(l[i], nl[i]), scale));
    }
    if (nz)
      load_noise<VEC>(nz + v0, u);
    else
      philox_uniforms<VEC>(key, row, v0, u);

    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float g = -logf(-logf(u[i] + 1e-10f) + 1e-10f);
      better_of(run, __fadd_rn(__fmul_rn(l[i], inv_temp), g), v0 + i, l[i]);
      tmax = fmaxf(tmax, l[i]);
    }
    const float mn = fmaxf(run.m, tmax);
    if (mn > -INFINITY) {
      float se = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) se += expf(l[i] - mn);
      run.se = (run.m == -INFINITY ? 0.f : run.se * expf(run.m - mn)) + se;
      run.m = mn;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Running o;
    o.y = __shfl_xor_sync(0xffffffffu, run.y, off);
    o.id = __shfl_xor_sync(0xffffffffu, run.id, off);
    o.ch = __shfl_xor_sync(0xffffffffu, run.ch, off);
    o.m = __shfl_xor_sync(0xffffffffu, run.m, off);
    o.se = __shfl_xor_sync(0xffffffffu, run.se, off);
    merge(run, o);
  }
  __shared__ Running part[THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    Running a = part[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) merge(a, part[w]);
    ids[row] = a.id;
    score[row] = 1.f - expf(a.ch - a.m) / a.se;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* logits, const void* noise, void* ids, void* score, int rows, int V,
                   float inv_temp, int has_cfg, float scale, uint2 key, cudaStream_t s) {
  gumbel_sample_kernel<T, VEC><<<rows, THREADS, 0, s>>>(
      (const T*)logits, (const float*)noise, rows, V, inv_temp, has_cfg, scale, key, (int*)ids,
      (float*)score);
  return cudaGetLastError();
}

}  // namespace
}  // namespace phenaki

// logits (rows, V), or with has_cfg the stacked (2 * rows, V) cond rows then
// null rows, in one dtype; noise (rows, V) f32 or null. Outputs ids (rows,)
// int32 and score (rows,) f32. 16-byte loads where V and the base pointers
// allow them, one value a load otherwise.
extern "C" int gumbel_sample(const void* logits, const void* noise, void* ids, void* score,
                             int rows, int V, float inv_temp, int has_cfg, float cond_scale,
                             unsigned long long seed, int dtype, void* stream) {
  using namespace phenaki;
  if (rows <= 0 || V <= 0) return cudaErrorInvalidValue;
  const uint2 key = make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
  const bool aligned = (uintptr_t)logits % 16 == 0 && (uintptr_t)noise % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16) {
    if (aligned && V % 8 == 0)
      return launch<bf16, 8>(logits, noise, ids, score, rows, V, inv_temp, has_cfg, cond_scale,
                             key, s);
    return launch<bf16, 1>(logits, noise, ids, score, rows, V, inv_temp, has_cfg, cond_scale,
                           key, s);
  }
  if (dtype == kF32) {
    if (aligned && V % 4 == 0)
      return launch<float, 4>(logits, noise, ids, score, rows, V, inv_temp, has_cfg, cond_scale,
                              key, s);
    return launch<float, 1>(logits, noise, ids, score, rows, V, inv_temp, has_cfg, cond_scale,
                            key, s);
  }
  return cudaErrorInvalidValue;
}
