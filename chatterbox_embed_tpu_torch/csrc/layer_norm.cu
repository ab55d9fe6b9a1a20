// LayerNorm over the last axis (K8), written for Hopper (sm_90a). It
// replaces no TPU kernel: on the TPU, XLA fuses the norm's chain of
// elementwise ops and reductions into the ops around it. In eager PyTorch
// the same chain is ~10 launches (mean, sub, pow, mean, sub, add, rsqrt,
// mul, mul, add, casts), each one more pass over the activations. K8 was
// added for S3Gen: the CFM estimator runs 141 norms a call, ten calls a
// vocode flush, and its conformer encoder 23 a dispatch.
//
// What it computes, for each row of width W (256, 512 or 1,024):
//   mean = sum(x) / W,  var = sum((x - mean)^2) / W     (fp32; two passes
//                                                          over registers)
//   y = ((x - mean) * rsqrt(var + eps)) * scale + bias   (fp32 scale, bias)
// stored once, in the output type the caller names (fp32 or bf16). The
// input is fp32 or bf16. This is the port's plain arithmetic
// (kernels/layer_norm.py:layer_norm_reference) step by step, each product
// and sum rounded on its own as the plain version's separate launches do;
// only the order of the two row sums differs.
//
// Two layouts of the same (rows, W) data:
//   rows    x row-major (rows, W), contiguous: the conformer's activations.
//   columns x stored (B, W, T) contiguous and normalised over W for each
//           (b, t): the estimator's activations, which its k=3 convs leave
//           channel-first and the rest of the U-Net keeps so. The output
//           keeps the input's layout, so nothing around the norm copies.
//
// What bounds it on an H100: its bytes. It does ~10 flops an element
// against 6-8 bytes (an fp32 or bf16 element in, a bf16 or fp32 one out),
// so its floor is rows x W x (in + out bytes) / 3.35 TB/s: 5.6 us for the
// estimator's 12,288 x 256 rows, fp32 in and bf16 out. The design reads
// each element once and writes it once, keeps a row in registers between
// its two sums, and keeps enough loads in flight to cover the memory's
// latency:
//   - rows: a warp owns RPW rows (2 at W = 256, else 1); a lane owns 8
//     adjacent values of each 256-wide chunk of a row, loaded as 16 bytes
//     (bf16) or two 16-byte loads (fp32), every row's loads issued before
//     the first sum; the sums are warp shuffles, so a row needs no shared
//     memory and no barrier. Stores are 16 bytes (bf16) or 2 x 16 bytes.
//   - columns: a block owns 32 consecutive t of one b, a lane one t, and
//     each of its W / 32 warps 32 channels: a warp's load of one channel
//     reads 32 adjacent t (64 or 128 contiguous bytes), 32 loads in flight
//     a thread. The warps' partial sums meet in shared memory, added in
//     warp order, twice (mean, then variance): no atomics, the same bits in
//     every run.
// It allocates nothing and synchronises with nothing, so a CUDA graph
// captures it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;                 // warps of a rows block
constexpr int kLaneVals = 8;                 // a lane's values in a 256-wide chunk
constexpr int kChunk = 32 * kLaneVals;       // 256

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
struct Out;
template <>
struct Out<float> {
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16_rn(v); }
};

// the plain version's rounding: (x - mean) * rstd, then * scale, then + bias
__device__ __forceinline__ float affine(float x, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), g), b);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kLaneVals]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kLaneVals]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kLaneVals]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kLaneVals]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename Tin, typename Tout, int W, int RPW>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_rows(const Tin* __restrict__ x, const float* __restrict__ scale,
        const float* __restrict__ bias, Tout* __restrict__ y, long rows, float eps) {
  constexpr int kChunks = W / kChunk;
  const int lane = threadIdx.x & 31;
  const long row0 = ((long)blockIdx.x * kRowWarps + (threadIdx.x >> 5)) * RPW;
  float v[RPW][kChunks][kLaneVals];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (row0 + r < rows) {
        load8(x + (row0 + r) * W + c * kChunk + lane * kLaneVals, v[r][c]);
      } else {
#pragma unroll
        for (int i = 0; i < kLaneVals; ++i) v[r][c][i] = 0.f;
      }
    }
  }
  float mean[RPW], rstd[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < kLaneVals; ++i) s += v[r][c][i];
    mean[r] = warp_sum(s) * (1.0f / W);
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < kLaneVals; ++i) {
        const float d = __fsub_rn(v[r][c][i], mean[r]);
        s += d * d;
      }
    rstd[r] = rsqrtf(warp_sum(s) * (1.0f / W) + eps);
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = c * kChunk + lane * kLaneVals;
    float g[kLaneVals], b[kLaneVals];
    load8(scale + col, g);
    load8(bias + col, b);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (row0 + r >= rows) continue;
      float o[kLaneVals];
#pragma unroll
      for (int i = 0; i < kLaneVals; ++i) o[i] = affine(v[r][c][i], mean[r], rstd[r], g[i], b[i]);
      store8(y + (row0 + r) * W + col, o);
    }
  }
}

template <typename Tin, typename Tout, int W>
__global__ void __launch_bounds__(W)
ln_cols(const Tin* __restrict__ x, const float* __restrict__ scale,
        const float* __restrict__ bias, Tout* __restrict__ y, int t_len, float eps) {
  constexpr int kWarps = W / 32;             // a warp owns 32 channels
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * 32 + lane;
  const bool live = t < t_len;
  const size_t at = (size_t)blockIdx.y * W * t_len + (size_t)(warp * 32) * t_len + t;
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = live ? to_float(x[at + (size_t)i * t_len]) : 0.f;

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += v[i];
  part[warp][lane] = s;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) tot += part[j][lane];
  const float mean = tot * (1.0f / W);
  __syncthreads();                           // every warp has read the sums

  s = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float d = __fsub_rn(v[i], mean);
    s += d * d;
  }
  part[warp][lane] = s;
  __syncthreads();
  tot = 0.f;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) tot += part[j][lane];
  const float rstd = rsqrtf(tot * (1.0f / W) + eps);

  if (!live) return;
  const float* g = scale + warp * 32;
  const float* b = bias + warp * 32;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    y[at + (size_t)i * t_len] = Out<Tout>::from(affine(v[i], mean, rstd, __ldg(g + i),
                                                       __ldg(b + i)));
}

template <typename Tin, typename Tout, int W>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y, long rows,
                   int t_len, int cols, float eps, cudaStream_t s) {
  const Tin* xi = static_cast<const Tin*>(x);
  const float* g = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  Tout* yo = static_cast<Tout*>(y);
  if (cols) {
    const dim3 grid((t_len + 31) / 32, (unsigned)(rows / t_len));
    ln_cols<Tin, Tout, W><<<grid, W, 0, s>>>(xi, g, b, yo, t_len, eps);
  } else {
    constexpr int kRpw = W == 256 ? 2 : 1;
    const long per_block = (long)kRowWarps * kRpw;
    const unsigned blocks = (unsigned)((rows + per_block - 1) / per_block);
    ln_rows<Tin, Tout, W, kRpw><<<blocks, kRowWarps * 32, 0, s>>>(xi, g, b, yo, rows, eps);
  }
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t by_width(int width, const void* x, const void* scale, const void* bias, void* y,
                     long rows, int t_len, int cols, float eps, cudaStream_t s) {
  switch (width) {
    case 256: return launch<Tin, Tout, 256>(x, scale, bias, y, rows, t_len, cols, eps, s);
    case 512: return launch<Tin, Tout, 512>(x, scale, bias, y, rows, t_len, cols, eps, s);
    case 1024: return launch<Tin, Tout, 1024>(x, scale, bias, y, rows, t_len, cols, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (rows, width) row-major (cols = 0), or stored (rows / t_len, width,
// t_len) contiguous and normalised over width (cols = 1); y in the same
// layout. Types: fp32 (0) or bf16 (1) for x and y; scale and bias fp32.
extern "C" int cbx_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                              long rows, int t_len, int width, int in_bf16, int out_bf16,
                              int cols, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (cols && (t_len <= 0 || rows % t_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16 ? by_width<bf16, bf16>(width, x, scale, bias, y, rows, t_len, cols, eps, s)
                   : by_width<bf16, float>(width, x, scale, bias, y, rows, t_len, cols, eps, s);
  } else {
    err = out_bf16 ? by_width<float, bf16>(width, x, scale, bias, y, rows, t_len, cols, eps, s)
                   : by_width<float, float>(width, x, scale, bias, y, rows, t_len, cols, eps, s);
  }
  return (int)err;
}
