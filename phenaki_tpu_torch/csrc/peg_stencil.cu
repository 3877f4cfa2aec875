// PEG's depthwise 3x3x3 stencil with its bias and the layer's residual in
// one pass, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the TPU package computes PEG in XLA, a loop over
// the 27 taps (phenaki_tpu/ops/positional.py:24 `depthwise3x3x3`). The port
// computed it as a windowed multiply-and-sum over an overlapping strided view
// of the padded grid, which writes the 27-fold product to device memory and
// reads it back: at the MaskGit's guided forward (128 rows, a 9 x 8 x 4 grid,
// d = 512) 1.02 GB a call, about 3.2 ms of a generic multiply and a sum
// against the 22.5 us that reading x and writing the output take, in each of
// the 6 layers, at each of the 18 steps (and the TokenCritic's 6 x 17): 35-39%
// of a flagship sample's device time on the H100.
//
// What it computes, for every (b, t, h, w) of the grid and channel c:
//   out = x + bias[c] + sum_{kt, kh, kw} k[c, kt, kh, kw] * x[b, t + kt - LO, h + kh - 1, w + kw - 1, c]
// with zeros outside the grid; LO = 1 pads the frames (1, 1), LO = 2 (causal)
// pads them (2, 0). The taps and the bias are rounded to x's type first, as
// the plain version casts them; the sum is f32, rounded to x's type once.
//
// What bounds it on the H100: bytes. It has to read x once and write the
// output once (75.5 MB at the MaskGit's shape, 22.5 us at 3.35 TB/s), against
// 27 f32 FMAs a value (0.51 G at that shape, 15 us on the CUDA cores): close
// to balanced, so the design keeps both the extra bytes and the instructions
// around each FMA few.
//
// Design. A block owns a slice of channels (32 lanes of 2 bf16 or 1 f32
// channels: 128 bytes a position) and a tile of the (h, w) plane (up to 32
// positions: the flagship's whole 8 x 4 plane), and walks it over the frames
// of several batch rows (as many blocks as fit on the card at once, one
// wave). Each frame's tile is copied into shared memory with 16-byte
// cp.async, two frames ahead of the one computed, in a ring of four buffers
// (a buffer is refilled two steps after it was read: one barrier a frame).
// The halo outside the grid is zero in every frame: it is written once and
// never copied (zero-fill copies from one address throttled the copies). A
// thread holds its channels' 27 taps in registers (staged through shared
// memory from the slice's contiguous weights) and owns a strip of 4
// positions of a row; for each frame it reads the 3 x 6 neighbours of its
// strip from shared memory (a warp reads 128 contiguous bytes: no bank
// conflict) and adds each one's three temporal taps into three rolling f32
// sums, the outputs of frames s + LO - 2, s + LO - 1 and s + LO; the first is
// then complete and is written. The sums start from the bias, and the
// residual rides on the centre tap (plus one), so an output costs its 27
// FMAs and little else. x is read from device memory once, apart from the
// halo rows of planes taller than one tile. The strides of (b, t, h, w) are
// arguments, so the C-ViViT's temporal layout ((b h w) t d, seen as
// (b, t, h, w, d)) needs no copy. d and the strides are multiples of 16
// bytes (every model's d is a multiple of 8); the wrapper raises otherwise.
//
// On the H100 at the MaskGit's shape: 45.0-46.5 us against the 22.5 us
// bound, each call reading x from device memory (the copies and stores
// alone, with no FMA, take 33 us; the FMAs and the copies overlap only in
// part), against 3.18 ms for the windowed multiply-and-sum.

#include <type_traits>

#include "wgmma.cuh"

namespace phenaki {
namespace {

constexpr int PEG_LANES = 32;   // channel lanes a block: one warp across the channels
constexpr int PEG_STRIP = 4;    // consecutive positions of a row a thread owns
constexpr int PEG_STRIPS = 8;   // strips a block (at most): 8 warps
constexpr int PEG_TILE_W = 16;  // columns a tile (at most): four buffers of a tile and its halo
                                // (at most 72 positions of 128 bytes) and the taps fit in 48 KB
constexpr int PEG_AHEAD = 2;    // frames in flight ahead of the one computed
constexpr int PEG_BUFS = PEG_AHEAD + 2;  // a buffer is refilled two steps after it was read
constexpr int PEG_COPIES = 5;   // 16-byte copies a thread and frame (at most): the tile and its
                                // halo, (th + 2)(tw + 2) positions, over th * tw / 4 strips

struct PegArgs {
  const void* x;
  void* out;
  const void* weight;  // (d, 1, 3, 3, 3), f32 or bf16
  const void* bias;    // (d,), the weight's type
  long long xs[4];     // x's strides of (b, t, h, w) in elements; channels contiguous
  long long os[4];     // out's
  int b, t, h, w, d;
  int th, tw, tiles_w;  // the tile's rows and columns (a multiple of 4), tiles across w
  int weight_bf16;
};

template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_f32(from_f32<T>(v));
}

// CPT consecutive channels as f32 (CPT = 2: one bf16 pair, 4-byte aligned)
template <typename T, int CPT>
__device__ __forceinline__ void read_vals(const unsigned char* p, float (&v)[CPT]) {
  if constexpr (CPT == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = to_f32(*reinterpret_cast<const T*>(p));
  }
}

template <typename T, int CPT>
__device__ __forceinline__ void store_vals(T* p, const float (&v)[CPT]) {
  if constexpr (CPT == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = from_f32<T>(v[0]);
  }
}

// out = x + bias + the stencil for a (channel slice, plane tile) and the rows
// blockIdx.z, blockIdx.z + gridDim.z, ...; LO = 1 pads the frames (1, 1),
// LO = 2 (causal) (2, 0). CPT channels a lane.
template <typename T, int CPT, int LO>
__global__ void __launch_bounds__(PEG_LANES * PEG_STRIPS, 2) peg_stencil_kernel(const PegArgs a) {
  constexpr int CW = PEG_LANES * CPT;        // channels a block
  constexpr int POS_BYTES = CW * sizeof(T);  // a position's slice in shared memory
  extern __shared__ __align__(16) unsigned char peg_smem[];
  const int lane = threadIdx.x, tid = threadIdx.y * PEG_LANES + lane, nthreads = PEG_LANES * blockDim.y;
  const int c0 = blockIdx.x * CW, c = c0 + lane * CPT;
  const int h0 = (blockIdx.y / a.tiles_w) * a.th, w0 = (blockIdx.y % a.tiles_w) * a.tw;
  const int pw = a.tw + 2, n_pos = (a.th + 2) * pw;
  const int row_bytes = pw * POS_BYTES, plane_bytes = n_pos * POS_BYTES;
  float* taps = reinterpret_cast<float*>(peg_smem + PEG_BUFS * plane_bytes);  // (27 + 1, CW)
  // the block's rows, walked frame after frame as one stream, so that the
  // copies run ahead across rows
  const int rows = (a.b - (int)blockIdx.z + (int)gridDim.z - 1) / (int)gridDim.z;
  const int steps = rows * a.t;
  const T* x = static_cast<const T*>(a.x);

  // this thread's 16-byte copies of a frame's tile and halo, the same for
  // every frame: the offset in the frame and in the buffer. What lies outside
  // the grid (or past d) is zero in every frame: it is written once, here,
  // into every buffer, and never copied.
  const uint32_t smem0 = smem_u32(peg_smem);
  long long src[PEG_COPIES];
  uint32_t dst[PEG_COPIES];
  bool copy[PEG_COPIES];
  constexpr int VEC = 16 / sizeof(T), PIECES = POS_BYTES / 16;
#pragma unroll
  for (int i = 0; i < PEG_COPIES; ++i) {
    const int idx = tid + i * nthreads, pos = idx / PIECES, k = idx % PIECES;
    const int hh = h0 - 1 + pos / pw, ww = w0 - 1 + pos % pw, cc = c0 + k * VEC;
    const bool in_tile = idx < n_pos * PIECES;
    copy[i] = in_tile && hh >= 0 && hh < a.h && ww >= 0 && ww < a.w && cc < a.d;
    src[i] = copy[i] ? hh * a.xs[2] + ww * a.xs[3] + cc : 0;
    dst[i] = pos * POS_BYTES + k * 16;
    if (in_tile && !copy[i])
#pragma unroll
      for (int buf = 0; buf < PEG_BUFS; ++buf)
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(smem0 + buf * plane_bytes + dst[i]), "r"(0)
                     : "memory");
  }
  const T* load_ptr = x + blockIdx.z * a.xs[0];  // the next frame to copy
  int load_row = 0, load_f = 0;
  auto load_next = [&](int step) {
    if (load_row < rows) {
      const uint32_t buf = smem0 + (step % PEG_BUFS) * plane_bytes;
#pragma unroll
      for (int i = 0; i < PEG_COPIES; ++i)
        if (copy[i]) cp_async16(buf + dst[i], load_ptr + src[i], 16);
    }
    cp_async_commit();
    load_ptr += a.xs[1];
    if (++load_f == a.t) {
      load_f = 0;
      ++load_row;
      load_ptr = x + (blockIdx.z + load_row * gridDim.z) * a.xs[0];
    }
  };
  // the copies of the first frames go out before the taps are read
#pragma unroll
  for (int i = 0; i < PEG_AHEAD; ++i) load_next(i);

  // the block's taps and bias, read in order (the slice's 27 x CW taps are
  // contiguous), rounded to T as the plain version casts them, staged as
  // (tap, channel) in f32
  for (int i = tid; i < 28 * CW; i += nthreads) {
    const bool is_bias = i >= 27 * CW;
    const int ch = is_bias ? i - 27 * CW : i / 27, tap = is_bias ? 27 : i - ch * 27;
    const void* from = is_bias ? a.bias : a.weight;
    const long long at = is_bias ? c0 + ch : (long long)c0 * 27 + i;
    float v = 0.f;
    if (c0 + ch < a.d)
      v = a.weight_bf16 ? __bfloat162float(static_cast<const bf16*>(from)[at]) : static_cast<const float*>(from)[at];
    taps[tap * CW + ch] = rounded<T>(v);
  }
  __syncthreads();
  float k[27][CPT], bias[CPT];
#pragma unroll
  for (int i = 0; i < 27; ++i)
#pragma unroll
    for (int e = 0; e < CPT; ++e) k[i][e] = taps[i * CW + lane * CPT + e];
#pragma unroll
  for (int e = 0; e < CPT; ++e) bias[e] = taps[27 * CW + lane * CPT + e];
  // the residual: x of frame s goes into output frame s through the centre
  // tap of kt = LO, plus one (exact for bf16 taps: 8 significant bits)
#pragma unroll
  for (int e = 0; e < CPT; ++e) k[LO * 9 + 4][e] += 1.f;

  // this thread's strip: row r of the tile, columns q0 .. q0 + 3, of which
  // n_valid lie in the grid
  const int strips_w = a.tw / PEG_STRIP;
  const int r = threadIdx.y / strips_w, q0 = (threadIdx.y % strips_w) * PEG_STRIP;
  const bool strip_ok = h0 + r < a.h && c < a.d;
  const int n_valid = min(PEG_STRIP, a.w - (w0 + q0));
  const long long o_strip = (h0 + r) * a.os[2] + (w0 + q0) * a.os[3] + c, os3 = a.os[3];
  T* const out = static_cast<T*>(a.out);
  T* out_row = out + blockIdx.z * a.os[0] + o_strip;  // frame 0 of the row computed
  const uint32_t strip_off = (r * pw + q0) * POS_BYTES + lane * CPT * sizeof(T);

  // acc[p][(j + R) % 3]: position q0 + p's output of frame s + LO - 2 + j,
  // which frame s adds with tap kt = 2 - j, at a step of rotation R (R = step
  // mod 3 within each unrolled triple: the roles rotate, the sums stay in
  // their registers); each starts from the bias
  float acc[PEG_STRIP][3][CPT];
  auto reset = [&](int first, int last) {  // roles first .. last (compile-time after unrolling)
#pragma unroll
    for (int p = 0; p < PEG_STRIP; ++p)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < CPT; ++e)
          if (j >= first && j <= last) acc[p][j][e] = bias[e];
  };
  reset(0, 2);

  auto store = [&](int t_out, auto slot) {
    T* o = out_row + t_out * a.os[1];
#pragma unroll
    for (int p = 0; p < PEG_STRIP; ++p)
      if (p < n_valid) store_vals<T, CPT>(o + p * os3, acc[p][decltype(slot)::value]);
  };

  int row = 0, s = 0;  // the frame computed
  auto frame = [&](int step, auto rotation) {
    constexpr int R = decltype(rotation)::value;
    load_next(step + PEG_AHEAD);
    cp_async_wait<PEG_AHEAD>();  // this thread's copies of this step's frame have landed
    __syncthreads();             // and every thread's
    if (strip_ok) {
      const unsigned char* pl = peg_smem + (step % PEG_BUFS) * plane_bytes + strip_off;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        float v[PEG_STRIP + 2][CPT];  // row r + kh - 1 of the grid, columns q0 - 1 .. q0 + 4
#pragma unroll
        for (int j = 0; j < PEG_STRIP + 2; ++j) read_vals<T, CPT>(pl + kh * row_bytes + j * POS_BYTES, v[j]);
#pragma unroll
        for (int p = 0; p < PEG_STRIP; ++p)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int kt = 0; kt < 3; ++kt)
#pragma unroll
              for (int e = 0; e < CPT; ++e)
                acc[p][(2 - kt + R) % 3][e] =
                    fmaf(k[kt * 9 + kh * 3 + kw][e], v[p + kw][e], acc[p][(2 - kt + R) % 3][e]);
      }
      if (s + LO - 2 >= 0) store(s + LO - 2, std::integral_constant<int, R>{});
      reset(R, R);  // the written role becomes the next step's third
      if (s == a.t - 1) {  // the row's end: its last output (LO = 1: the next frame is padding)
        if (LO == 1) store(a.t - 1, std::integral_constant<int, (R + 1) % 3>{});
        reset(0, 2);
      }
    }
    if (++s == a.t) {
      s = 0;
      ++row;
      out_row = out + (blockIdx.z + row * gridDim.z) * a.os[0] + o_strip;
    }
  };
  int step = 0;
  for (; step + 3 <= steps; step += 3) {
    frame(step, std::integral_constant<int, 0>{});
    frame(step + 1, std::integral_constant<int, 1>{});
    frame(step + 2, std::integral_constant<int, 2>{});
  }
  if (step < steps) frame(step++, std::integral_constant<int, 0>{});
  if (step < steps) frame(step, std::integral_constant<int, 1>{});
}

// the card's SMs, read once (as flash_attention.cu does)
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

template <typename T, int LO>
cudaError_t launch_kernel(const PegArgs& a, dim3 xy, dim3 block, size_t smem, cudaStream_t s) {
  // one wave: as many blocks as fit on the card at once, each walking an
  // equal share of the rows. The blocks an SM holds are asked of the runtime
  // once for each instantiation and tile (a model's PEGs share one tile)
  auto kernel = peg_stencil_kernel<T, sizeof(T) == 2 ? 2 : 1, LO>;
  static int fit_threads = 0, fit = 0;
  static size_t fit_smem = 0;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess && (fit_threads != (int)(block.x * block.y) || fit_smem != smem)) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, block.x * block.y, smem);
    fit_threads = err == cudaSuccess ? (int)(block.x * block.y) : 0;
    fit_smem = smem;
  }
  if (err != cudaSuccess) return err;
  const long long slots = (long long)(fit > 0 ? fit : 1) * sms, per_row = (long long)xy.x * xy.y;
  const long long rows_per_block = (a.b * per_row + slots - 1) / slots;
  const long long z = (a.b + rows_per_block - 1) / rows_per_block;
  if (z > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<dim3(xy.x, xy.y, (unsigned)z), block, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const PegArgs& a, int causal, cudaStream_t s) {
  constexpr int CPT = sizeof(T) == 2 ? 2 : 1;
  constexpr int CW = PEG_LANES * CPT;
  const dim3 xy((a.d + CW - 1) / CW, ((a.h + a.th - 1) / a.th) * a.tiles_w);
  const dim3 block(PEG_LANES, a.th * a.tw / PEG_STRIP);
  const size_t smem = (size_t)PEG_BUFS * (a.th + 2) * (a.tw + 2) * CW * sizeof(T) + 28 * CW * sizeof(float);
  return causal ? launch_kernel<T, 2>(a, xy, block, smem, s) : launch_kernel<T, 1>(a, xy, block, smem, s);
}

}  // namespace
}  // namespace phenaki

// x and out (b, t, h, w, d) of one dtype (0 = f32, 1 = bf16), channels
// contiguous, the strides of (b, t, h, w) in elements (xs, os); weight
// (d, 1, 3, 3, 3) contiguous and bias (d,), both of weight_dtype; x, out, d
// and the strides on 16 bytes. Writes out = x + bias + the stencil (frames
// padded (2, 0) if causal, else (1, 1)).
extern "C" int peg_stencil(const void* x, const void* weight, const void* bias, void* out, int b,
                           int t, int h, int w, int d, long long xs0, long long xs1, long long xs2,
                           long long xs3, long long os0, long long os1, long long os2,
                           long long os3, int causal, int dtype, int weight_dtype, void* stream) {
  using namespace phenaki;
  if (b <= 0 || t <= 0 || h <= 0 || w <= 0 || d <= 0) return cudaErrorInvalidValue;
  if (weight_dtype != kF32 && weight_dtype != kBF16) return cudaErrorInvalidValue;
  PegArgs a{x, out, weight, bias, {xs0, xs1, xs2, xs3}, {os0, os1, os2, os3}, b, t, h, w, d,
            0, 0, 0, weight_dtype == kBF16};
  // a tile: whole strips of 4 columns (ragged ones masked), at most 8 strips
  const int w4 = (w + PEG_STRIP - 1) / PEG_STRIP * PEG_STRIP;
  a.tw = w4 < PEG_TILE_W ? w4 : PEG_TILE_W;
  a.th = PEG_STRIPS * PEG_STRIP / a.tw < h ? PEG_STRIPS * PEG_STRIP / a.tw : h;
  a.tiles_w = (w + a.tw - 1) / a.tw;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  // 16-byte copies: every position's channels start on 16 bytes
  const int vec = dtype == kBF16 ? 8 : 4;
  bool ok = d % vec == 0 && aligned16(x) && aligned16(out);
  for (int i = 0; i < 4; ++i) ok = ok && a.xs[i] % vec == 0 && a.os[i] % vec == 0;
  if (!ok) return cudaErrorMisalignedAddress;
  return dtype == kBF16 ? launch<bf16>(a, causal, s) : launch<float>(a, causal, s);
}
