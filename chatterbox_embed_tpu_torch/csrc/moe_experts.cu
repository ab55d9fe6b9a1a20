// Grouped SwiGLU of a mixture's routed experts (K7), written for Hopper
// (sm_90a). It replaces no TPU kernel: the JAX package runs no mixture of
// experts. It was added for T3's DeepSeek-V2 backbone
// (models/deepseek_v2.py), whose 26 MoE layers route each row to 6 of 64
// experts.
//
// What it computes: rows x (N, D) bf16 sorted by expert, expert e owning
// rows [offsets[e], offsets[e + 1]); for each row of expert e
//   h = silu(x . Wg[e]) * (x . Wu[e])      (F wide, stored bf16)
//   y = h . Wd[e]                          (D wide, fp32)
// Wg, Wu (E, D, F) and Wd (E, F, D) bf16, products accumulated in fp32.
// The offsets are read on the device and the grid is fixed (every expert's
// blocks are launched; an expert with no rows returns at once), so a CUDA
// graph replays the launch whatever the routing is, with no host read.
//
// What bounds it on an H100: at a decode step (32 rows, 192 assignments)
// the touched experts' weights, 61 of 64 on average at 17.3 MB each,
// against ~3 rows an expert: memory-bound by far. At a prefill (~3,500
// assignments, ~55 rows an expert) the fp32 multiply-adds come near the
// bytes' time. So the design keeps many weight bytes in flight and reads
// each weight once a pass of rows:
//   - Two launches, the gated product (grid E x F/128) then the down
//     product (grid E x D/128); a block owns 128 output columns of one
//     expert. Its 8 warps split the reduction depth K in 8 contiguous
//     parts; a lane owns 4 adjacent columns and loads each weight row's 4
//     values as one 8-byte load (a warp reads 256 contiguous bytes of a
//     row), 8 rows unrolled ahead of their use.
//   - Rows come in passes of at most 16: the pass's x rows are copied to
//     shared memory (16 bytes a thread), and every lane reads them as
//     broadcasts, two depths at a time. A pass of 1-2, 3-4, 5-8 or 9-16 rows
//     runs a loop compiled for 2, 4, 8 or 16 rows (the last with 4 weight
//     rows ahead, to hold its 128 accumulators in registers), so a decode
//     expert of 3 rows does not pay for 16, and one of 16 reads its weights
//     once.
//   - The 8 warps' partial sums meet in shared memory (over the x rows,
//     whose pass is done), 8 rows at a time, and are added in warp order by
//     the block's threads: no atomics, the same bits in every run, graphed
//     or not.
// Every bound it has: K a multiple of 64, the output width a multiple of
// 128 (D = 2048, F = 1408 for DeepSeek-V2-Lite); the wrapper checks them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;          // output columns of a block
constexpr int kLaneCols = 4;        // a lane's columns
constexpr int kMaxRows = 16;        // rows of a pass
constexpr int kPartRows = 8;        // rows whose partial sums meet at once
constexpr int kUnroll = 8;          // weight rows loaded ahead

struct Cols4 {
  float v[4];
};

__device__ __forceinline__ Cols4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return Cols4{{fa.x, fa.y, fb.x, fb.y}};
}

// The pass's products over this warp's depth range [k0, k1) for R rows,
// U weight rows loaded ahead: acc[m][r][j] += x[r][k] * W_m[k][col + j].
template <int R, int U, int NMAT>
__device__ __forceinline__ void dot_pass(const __nv_bfloat16* xs, int K,
                                         const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                                         int ldw, int k0, int k1,
                                         float (&acc)[NMAT][kMaxRows][kLaneCols]) {
  for (int k = k0; k < k1; k += U) {
    Cols4 wv[NMAT][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wv[0][u] = load4(w0 + (size_t)(k + u) * ldw);
      if (NMAT == 2) wv[NMAT - 1][u] = load4(w1 + (size_t)(k + u) * ldw);
    }
#pragma unroll
    for (int u = 0; u < U; u += 2) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const __nv_bfloat162 xp =
            *reinterpret_cast<const __nv_bfloat162*>(xs + (size_t)r * K + k + u);
        const float2 xf = __bfloat1622float2(xp);
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
#pragma unroll
          for (int j = 0; j < kLaneCols; ++j) {
            acc[m][r][j] = fmaf(xf.x, wv[m][u].v[j], acc[m][r][j]);
            acc[m][r][j] = fmaf(xf.y, wv[m][u + 1].v[j], acc[m][r][j]);
          }
        }
      }
    }
  }
}

// GATED: out (N, M) bf16 = silu(x . W0[e]) * (x . W1[e]); else out (N, M)
// fp32 = x . W0[e]. x (N, K) bf16; W0, W1 (E, K, M) bf16.
template <bool GATED>
__global__ void __launch_bounds__(kThreads)
moe_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ offsets,
           const __nv_bfloat16* __restrict__ w0, const __nv_bfloat16* __restrict__ w1,
           void* __restrict__ out, int K, int M) {
  constexpr int NMAT = GATED ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* part = reinterpret_cast<float*>(smem);

  const int e = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int r0 = offsets[e], r1 = offsets[e + 1];
  if (r0 >= r1) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kper = K / kWarps;
  const int k0 = warp * kper, k1 = k0 + kper;
  const int col = c0 + lane * kLaneCols;
  const size_t wexp = (size_t)e * K * M;
  const __nv_bfloat16* wa = w0 + wexp + col;
  const __nv_bfloat16* wb = GATED ? w1 + wexp + col : wa;

  for (int p0 = r0; p0 < r1; p0 += kMaxRows) {
    const int n = min(kMaxRows, r1 - p0);
    // the pass's rows into shared memory, 16 bytes a thread
    const int vec_per_row = K / 8;
    for (int i = threadIdx.x; i < n * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row, v = i % vec_per_row;
      reinterpret_cast<uint4*>(xs + (size_t)r * K)[v] =
          __ldg(reinterpret_cast<const uint4*>(x + (size_t)(p0 + r) * K) + v);
    }
    __syncthreads();
    float acc[NMAT][kMaxRows][kLaneCols];
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) acc[m][r][j] = 0.f;
    if (n <= 2) {
      dot_pass<2, kUnroll, NMAT>(xs, K, wa, wb, M, k0, k1, acc);
    } else if (n <= 4) {
      dot_pass<4, kUnroll, NMAT>(xs, K, wa, wb, M, k0, k1, acc);
    } else if (n <= 8) {
      dot_pass<8, kUnroll, NMAT>(xs, K, wa, wb, M, k0, k1, acc);
    } else {
      dot_pass<16, kUnroll / 2, NMAT>(xs, K, wa, wb, M, k0, k1, acc);
    }
    __syncthreads();                     // every warp is done with xs
#pragma unroll
    for (int h = 0; h < kMaxRows / kPartRows; ++h) {
      const int hn = min(kPartRows, n - h * kPartRows);
      if (hn <= 0) break;
      // part[m][warp][r][lane * 4 + j] of rows h * 8 + r
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int r = 0; r < kPartRows; ++r)
          if (r < hn)
#pragma unroll
            for (int j = 0; j < kLaneCols; ++j)
              part[((m * kWarps + warp) * kPartRows + r) * kCols + lane * kLaneCols + j] =
                  acc[m][h * kPartRows + r][j];
      __syncthreads();
      for (int i = threadIdx.x; i < hn * kCols; i += kThreads) {
        const int r = i / kCols, c = i % kCols;
        float s[NMAT];
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          s[m] = 0.f;
          for (int w = 0; w < kWarps; ++w)
            s[m] += part[((m * kWarps + w) * kPartRows + r) * kCols + c];
        }
        const size_t o = (size_t)(p0 + h * kPartRows + r) * M + c0 + c;
        if (GATED) {
          const float g = s[0], u = s[NMAT - 1];
          reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(g / (1.f + __expf(-g)) * u);
        } else {
          reinterpret_cast<float*>(out)[o] = s[0];
        }
      }
      __syncthreads();                   // part is read before it is written again
    }
  }
}

template <bool GATED>
size_t smem_bytes(int K) {
  const size_t xs = (size_t)kMaxRows * K * sizeof(__nv_bfloat16);
  const size_t part = (size_t)(GATED ? 2 : 1) * kWarps * kPartRows * kCols * sizeof(float);
  return xs > part ? xs : part;
}

template <bool GATED>
cudaError_t launch(const void* x, const void* offsets, const void* w0, const void* w1, void* out,
                   int n_experts, int K, int M, cudaStream_t stream) {
  const size_t smem = smem_bytes<GATED>(K);
  cudaError_t err = cudaFuncSetAttribute(moe_kernel<GATED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_experts, M / kCols);
  moe_kernel<GATED><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(offsets),
      static_cast<const __nv_bfloat16*>(w0), static_cast<const __nv_bfloat16*>(w1), out, K, M);
  return cudaGetLastError();
}

}  // namespace

// h (N, F) bf16 scratch and y (N, D) fp32 output, both from the caller.
extern "C" int cbx_moe_experts(const void* x, const void* offsets, const void* w_gate,
                               const void* w_up, const void* w_down, void* h, void* y,
                               int n_experts, int d, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch<true>(x, offsets, w_gate, w_up, h, n_experts, d, f, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<false>(h, offsets, w_down, nullptr, y, n_experts, f, d, s);
}
