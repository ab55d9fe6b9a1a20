// Decode-anatomy probe (K6), written for Hopper (sm_90a). It replaces the
// Pallas TPU kernel scripts/microbench_decode_anatomy.py:_variant_kernel
// (entry attn): the flash-decode walk (K1) in three variants, to split its
// time into what the loads cost and what the attention math costs.
//
//   q     (G, 64)        one query row per (row, head) group, G = B * H
//   k, v  (Lc, G, 64)    sequence-major cache, one layer
//   out   (G, 64)        in q's dtype
//   sink  (G, n_splits)  fp32 scratch, written by load_only (see below)
// With CHUNK = 64 and n_chunks = pos / 64 + 1 (the TPU kernel's chunk walk):
//   full          attention of each group's query over the slots <= pos: fp32
//                 online softmax, scale 1/8. The same function as K1 with
//                 start 0 and no hole, and the same code: decode_walk.cuh's
//                 walk_keys and merge_warps, and K1's two passes.
//   load_only     (the TPU kernel's dma_only) every slot of the n_chunks
//                 walked chunks is loaded exactly as the walk loads it (the
//                 same addresses, four slots in flight a warp), and nothing
//                 of the attention math runs. out = the sum over the chunks
//                 of row 0 of the k chunk plus row 0 of the v chunk (fp32,
//                 then cast), as the TPU variant consumes one row of each
//                 chunk. A compiler for this card drops a load whose value
//                 is unused, so every loaded value is also added into one
//                 fp32 sum per (group, split) that is stored to `sink`: the
//                 loads cannot be elided, and the consumer is two adds a
//                 value instead of a softmax.
//   compute_only  the attention math with no walk through the cache: slot j
//                 reads cache row j % 64, so every block works on chunk 0,
//                 4 MB in all at the probe's shape, which stays in L2. The
//                 TPU variant reads a scratch buffer that nothing filled, so
//                 its output is not defined; this port defines it: attention
//                 over chunk 0 repeated n_chunks times, slots > pos masked.
//
// What bounds it on an H100: as K1, the live K/V bytes (a few MB to tens of
// MB) at about one operation a byte: memory- and, at these sizes,
// latency-bound. The design is K1's: pass 1 on a grid (G, n_splits) of 128
// threads, each block owning split_len slots of one group and skipping what
// is not live; pass 2 merges the splits of a group in order (no atomics, so
// the same bits every run). Triton would hide the two things the probe
// varies, the loads in flight and their overlap with the math.

#include "decode_walk.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;
enum Mode { kFull = 0, kLoadOnly = 1, kComputeOnly = 2 };

// The walk's loads without its math: the same slots, addresses and unroll
// as walk_keys. `row0` collects the rows that start a chunk, `all` every
// loaded value.
template <typename T>
__device__ __forceinline__ void walk_loads(const T* __restrict__ k, const T* __restrict__ v,
                                           size_t row_stride, size_t head_off, int first,
                                           int last, int step, int lane, float2& row0,
                                           float& all) {
  constexpr int kUnroll = 4;
  for (int j0 = first; j0 <= last; j0 += kUnroll * step) {
    float2 kk[kUnroll], vv[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * step;
      live[u] = j <= last;
      if (live[u]) {
        const size_t off = (size_t)j * row_stride + head_off + 2 * lane;
        kk[u] = load2(k + off);
        vv[u] = load2(v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      const float sx = kk[u].x + vv[u].x, sy = kk[u].y + vv[u].y;
      all += sx + sy;
      if ((j0 + u * step) % kChunk == 0) {
        row0.x += sx;
        row0.y += sy;
      }
    }
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, float* __restrict__ sink, int groups, int pos,
             int split_len, int n_splits, float scale) {
  const int g = blockIdx.x;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_chunks = pos / kChunk + 1;
  const int walk_end = kMode == kLoadOnly ? n_chunks * kChunk - 1 : pos;
  const int lo = split * split_len;
  int hi = lo + split_len - 1;
  if (hi > walk_end) hi = walk_end;
  const size_t row_stride = (size_t)groups * kHeadDim;
  const size_t head_off = (size_t)g * kHeadDim;
  const size_t p = (size_t)g * n_splits + split;

  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps * kHeadDim];

  if (kMode == kLoadOnly) {
    float2 row0 = make_float2(0.f, 0.f);
    float all = 0.f;
    walk_loads(k, v, row_stride, head_off, lo + warp, hi, kWarps, lane, row0, all);
    all = warp_sum(all);
    if (lane == 0) sm_l[warp] = all;
    sm_acc[warp * kHeadDim + 2 * lane] = row0.x;
    sm_acc[warp * kHeadDim + 2 * lane + 1] = row0.y;
    __syncthreads();
    if (threadIdx.x < kHeadDim) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sm_acc[w * kHeadDim + threadIdx.x];
      part_acc[p * kHeadDim + threadIdx.x] = s;
      if (threadIdx.x == 0) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) t += sm_l[w];
        sink[p] = t;
      }
    }
    return;
  }

  const float2 qv = load2(q + head_off + 2 * lane);
  float m = -INFINITY, l = 0.f;
  float2 acc = make_float2(0.f, 0.f);
  walk_keys<T, kMode == kComputeOnly ? kChunk : 0>(
      k, v, qv, row_stride, head_off, lo + warp, hi, kWarps, 0, 0, scale, lane, m, l, acc);
  float mb, lb, ab;
  merge_warps<kWarps>(m, l, acc, sm_m, sm_l, sm_acc, mb, lb, ab);
  if (threadIdx.x < kHeadDim) {
    part_acc[p * kHeadDim + threadIdx.x] = ab;
    if (threadIdx.x == 0) {
      part_m[p] = mb;
      part_l[p] = lb;
    }
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kHeadDim)
combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out, int n_splits) {
  const int g = blockIdx.x;
  const int d = threadIdx.x;
  const float* acc = part_acc + (size_t)g * n_splits * kHeadDim + d;
  if (kMode == kLoadOnly) {
    float s = 0.f;
    for (int i = 0; i < n_splits; ++i) s += acc[(size_t)i * kHeadDim];
    store1(out + (size_t)g * kHeadDim + d, s);
    return;
  }
  const float* m = part_m + (size_t)g * n_splits;
  const float* l = part_l + (size_t)g * n_splits;
  float mb = -INFINITY;
  for (int i = 0; i < n_splits; ++i) mb = fmaxf(mb, m[i]);
  float lb = 0.f, ab = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    if (l[i] > 0.f) {
      const float f = expf(m[i] - mb);
      lb += l[i] * f;
      ab += acc[(size_t)i * kHeadDim] * f;
    }
  }
  store1(out + (size_t)g * kHeadDim + d, lb > 0.f ? ab / lb : 0.f);
}

template <typename T, int kMode>
int launch(const void* q, const void* k, const void* v, void* out, float* part_m,
           float* part_l, float* part_acc, float* sink, int groups, int pos, int split_len,
           int n_splits, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  split_kernel<T, kMode><<<dim3(groups, n_splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part_m,
      part_l, part_acc, sink, groups, pos, split_len, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T, kMode><<<groups, kHeadDim, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n_splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int mode, const void* q, const void* k, const void* v, void* out, float* part_m,
             float* part_l, float* part_acc, float* sink, int groups, int pos, int split_len,
             int n_splits, cudaStream_t s) {
  switch (mode) {
    case kFull:
      return launch<T, kFull>(q, k, v, out, part_m, part_l, part_acc, sink, groups, pos,
                              split_len, n_splits, s);
    case kLoadOnly:
      return launch<T, kLoadOnly>(q, k, v, out, part_m, part_l, part_acc, sink, groups, pos,
                                  split_len, n_splits, s);
    case kComputeOnly:
      return launch<T, kComputeOnly>(q, k, v, out, part_m, part_l, part_acc, sink, groups,
                                     pos, split_len, n_splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. mode: 0 full, 1 load_only, 2 compute_only;
// dtype: 0 = float32, 1 = bfloat16. The grid covers n_splits * split_len >=
// lcache slots; load_only walks whole 64-slot chunks, so lcache must hold
// (pos / 64 + 1) * 64 slots. Returns the cudaError_t of the launches (0 on
// success); it never synchronises and allocates nothing.
extern "C" int cbx_decode_anatomy(const void* q, const void* k, const void* v, void* out,
                                  float* part_m, float* part_l, float* part_acc, float* sink,
                                  int groups, int head_dim, int lcache, int pos, int split_len,
                                  int n_splits, int mode, int dtype, void* stream) {
  if (head_dim != kHeadDim || pos < 0 || pos >= lcache || split_len <= 0 ||
      (long long)n_splits * split_len < lcache || (pos / kChunk + 1) * kChunk > lcache)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(mode, q, k, v, out, part_m, part_l, part_acc, sink, groups, pos,
                           split_len, n_splits, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(mode, q, k, v, out, part_m, part_l, part_acc, sink, groups,
                                   pos, split_len, n_splits, s);
  return (int)cudaErrorInvalidValue;
}
