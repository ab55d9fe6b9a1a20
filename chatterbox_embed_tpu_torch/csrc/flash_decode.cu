// Split-KV flash-decode attention for the T3 decode step, written for Hopper
// (sm_90a). It replaces the Pallas TPU kernel
// chatterbox_embed_tpu/kernels/flash_decode.py:_kernel (entry decode_attention).
//
// What it computes (the same as the TPU kernel): one query token per
// (row, head) attends to the live cache slots j with start <= j <= cache_pos,
// minus an optional per-row dead range [hole_lo, hole_hi). The softmax is an
// fp32 online softmax with scale 1/sqrt(D); q.k and p.v accumulate in fp32
// whatever the input dtype; the output has q's dtype.
//
//   q    (B, H, D)       contiguous
//   k, v (Lc, B, H, D)   contiguous, sequence-major (one layer of the cache)
//   hole (B, 2) int32    or null
//   out  (B, H, D)
//
// What bounds it on an H100: the live K/V bytes, 2 * (pos - start + 1) * B *
// H * D * sizeof(T) per layer, against ~1 FLOP per byte -- it is memory-bound
// (and, at the decode shapes, latency-bound: a few MB per call). The design
// reads only live slots and splits the cache over many blocks so that the
// whole card streams it:
//   pass 1  grid (B*H, n_splits), 128 threads. A block owns the keys
//           [s * split_len, (s+1) * split_len) of one (row, head) (the
//           wrapper passes split_len = 32: each warp's chain of dependent
//           loads stays 8 keys long) and skips
//           every slot outside the live range, so a split wholly before
//           `start`, after `cache_pos` or inside the hole reads nothing and
//           writes m = -inf, l = 0, acc = 0. Each warp walks every 4th key;
//           lane i holds q[2i], q[2i+1] (D = 64), so one key row is one
//           coalesced 128-byte (bf16) or 256-byte (fp32) warp load and the
//           dot product is a 5-step shuffle reduction. The 4 warps' online
//           softmax states merge in shared memory into one (m, l, acc[D])
//           partial per block.
//   pass 2  grid (B*H), D threads: merges the n_splits partials of one
//           (row, head) with the usual max-rescale; splits with l = 0 add
//           nothing, so no NaN arises from an empty split.
// The grid covers the whole cache capacity whatever cache_pos is, so the
// launch shape is static across decode steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ hole,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int bh_total, int heads,
             int cache_pos, int start, int split_len, int n_splits,
             float scale) {
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = bh / heads;

  int lo = split * split_len;
  int hi = lo + split_len - 1;                // inclusive
  if (lo < start) lo = start;
  if (hi > cache_pos) hi = cache_pos;
  int hole_lo = 0, hole_hi = 0;
  if (hole != nullptr) {
    hole_lo = hole[2 * row];
    hole_hi = hole[2 * row + 1];
  }

  // q has the cache dtype (the wrapper checks), so q.k multiplies values of
  // that dtype exactly in fp32, as the TPU kernel's cache-dtype product does
  const float2 qv = load2(q + (size_t)bh * kHeadDim + 2 * lane);

  float m = -INFINITY, l = 0.f;
  float2 acc = make_float2(0.f, 0.f);
  const size_t row_stride = (size_t)bh_total * kHeadDim;
  for (int j = lo + warp; j <= hi; j += kWarps) {
    if (j >= hole_lo && j < hole_hi) continue;          // warp-uniform
    const size_t off = (size_t)j * row_stride + (size_t)bh * kHeadDim + 2 * lane;
    const float2 kv = load2(k + off);
    float s = qv.x * kv.x + qv.y * kv.y;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    s *= scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);                // 0 on the first key
    const float p = expf(s - m_new);
    const float2 vv = load2(v + off);
    l = l * alpha + p;
    acc.x = acc.x * alpha + p * vv.x;
    acc.y = acc.y * alpha + p * vv.y;
    m = m_new;
  }

  // merge the warps' states
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kHeadDim];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  sm_acc[warp][2 * lane] = acc.x;
  sm_acc[warp][2 * lane + 1] = acc.y;
  __syncthreads();
  if (threadIdx.x < kHeadDim) {
    const int d = threadIdx.x;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sm_m[w]);
    float lb = 0.f, ab = 0.f;
    if (mb > -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (sm_l[w] > 0.f) {
          const float f = expf(sm_m[w] - mb);
          lb += sm_l[w] * f;
          ab += sm_acc[w][d] * f;
        }
      }
    }
    const size_t p = (size_t)bh * n_splits + split;
    part_acc[p * kHeadDim + d] = ab;
    if (d == 0) {
      part_m[p] = mb;
      part_l[p] = lb;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kHeadDim)
combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out,
               int n_splits) {
  const int bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* m = part_m + (size_t)bh * n_splits;
  const float* l = part_l + (size_t)bh * n_splits;
  float mb = -INFINITY;
  for (int s = 0; s < n_splits; ++s) mb = fmaxf(mb, m[s]);
  float lb = 0.f, ab = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    if (l[s] > 0.f) {
      const float f = expf(m[s] - mb);
      lb += l[s] * f;
      ab += part_acc[((size_t)bh * n_splits + s) * kHeadDim + d] * f;
    }
  }
  store1(out + (size_t)bh * kHeadDim + d, lb > 0.f ? ab / lb : 0.f);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* hole,
           void* out, float* part_m, float* part_l, float* part_acc,
           int batch, int heads, int cache_pos, int start, int split_len,
           int n_splits, cudaStream_t stream) {
  const int bh = batch * heads;
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  split_kernel<T><<<dim3(bh, n_splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), hole, part_m, part_l, part_acc, bh, heads,
      cache_pos, start, split_len, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<bh, kHeadDim, 0, stream>>>(part_m, part_l, part_acc,
                                                static_cast<T*>(out), n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launches (0 on success); it never synchronises and
// allocates nothing.
extern "C" int cbx_flash_decode(const void* q, const void* k, const void* v,
                                const int* hole, void* out, float* part_m,
                                float* part_l, float* part_acc, int batch,
                                int heads, int head_dim, int cache_pos,
                                int start, int split_len, int n_splits,
                                int dtype, void* stream) {
  if (head_dim != kHeadDim) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, hole, out, part_m, part_l, part_acc, batch,
                         heads, cache_pos, start, split_len, n_splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, hole, out, part_m, part_l, part_acc,
                                 batch, heads, cache_pos, start, split_len,
                                 n_splits, s);
  return (int)cudaErrorInvalidValue;
}
