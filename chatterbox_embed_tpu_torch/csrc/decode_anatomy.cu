// Decode-anatomy probe (K6), written for Hopper (sm_90a). It replaces the
// Pallas TPU kernel scripts/microbench_decode_anatomy.py:_variant_kernel
// (entry attn): the flash-decode walk (K1) in three variants, to split its
// time into what the loads cost and what the attention math costs.
//
//   q     (G, 64)        one query row per (row, head) group, G = B * H
//   k, v  (Lc, G, 64)    sequence-major cache, one layer
//   out   (G, 64)        in q's dtype
//   part, counters       K1's workspace for (G, Lc) (flash_decode.cu)
// With CHUNK = 64 and n_chunks = pos / 64 + 1 (the TPU kernel's chunk walk):
//   full          attention of each group's query over the slots <= pos: fp32
//                 online softmax, scale 1/8. The same function as K1 with
//                 start 0 and no hole, and the same code: K1's grid, split
//                 count and live-range splits, decode_walk.cuh's walk_keys,
//                 and the merge by the last block of a group.
//   load_only     (the TPU kernel's dma_only) every slot of the n_chunks
//                 walked chunks is loaded exactly as the walk loads it (the
//                 same splits, addresses and tiles, 32 slots in flight a
//                 warp), and nothing of the attention math runs. out = the
//                 sum over the chunks of row 0 of the k chunk plus row 0 of
//                 the v chunk (fp32, then cast), as the TPU variant consumes
//                 one row of each chunk. A compiler for this card drops a
//                 load whose value is unused, so every loaded value is also
//                 added into one fp32 sum per (group, split) that is stored
//                 in the partial's l slot: the loads cannot be elided, and
//                 the consumer is two adds a value instead of a softmax.
//   compute_only  the attention math with no walk through the cache: slot j
//                 reads cache row j % 64, so every block works on chunk 0,
//                 4 MB in all at the probe's shape, which stays in L2. The
//                 TPU variant reads a scratch buffer that nothing filled, so
//                 its output is not defined; this port defines it: attention
//                 over chunk 0 repeated n_chunks times, slots > pos masked.
//
// What bounds it on an H100: as K1, the live K/V bytes (a few MB to tens of
// MB) at about one operation a byte: memory- and, at these sizes,
// latency-bound. The design is K1's, one launch a call. The merge of the
// partials adds them in split order in one block (no float atomics), so the
// same bits come out every run. Triton would hide the two things the probe
// varies, the loads in flight and their overlap with the math.

#include "decode_walk.cuh"

namespace {

constexpr int kWarps = kSplitWarps;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;
enum Mode { kFull = 0, kLoadOnly = 1, kComputeOnly = 2 };

// walk_keys' loads without its math: the same slots, addresses and tiles.
// `row0` collects this lane's elements of the rows that start a chunk,
// `all` every loaded value.
template <typename T>
__device__ __forceinline__ void walk_loads(const T* __restrict__ k, const T* __restrict__ v,
                                           size_t row_stride, size_t head_off, int lo, int hi,
                                           float (&row0)[kElems], float& all) {
  using R = Row<T>;
  constexpr int U = R::kLoads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / kGroupLanes;
  const size_t lane_off = head_off + (lane % kGroupLanes) * kElems;
  for (int base = lo; base <= hi; base += tile_keys<kWarps, U>()) {
    typename R::Raw kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + (u * kWarps + warp) * kGroups + g;
      if (j <= hi) {
        const size_t off = (size_t)j * row_stride + lane_off;
        kr[u] = R::load(k + off);
        vr[u] = R::load(v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + (u * kWarps + warp) * kGroups + g;
      if (j > hi) continue;
      float kk[kElems], vv[kElems];
      R::unpack(kr[u], kk);
      R::unpack(vr[u], vv);
      const bool first = j % kChunk == 0;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const float x = kk[e] + vv[e];
        all += x;
        if (first) row0[e] += x;
      }
    }
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
anatomy_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
               int groups, int pos, int n_splits) {
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps * kHeadDim];
  __shared__ int sm_last;
  const int g = blockIdx.x;
  const int split = blockIdx.y;
  const int n_chunks = pos / kChunk + 1;
  const int walk_end = kMode == kLoadOnly ? n_chunks * kChunk - 1 : pos;
  const int per = (walk_end + n_splits) / n_splits;          // ceil((walk_end + 1) / S)
  const int lo = split * per;
  const int hi = min(walk_end, lo + per - 1);
  const size_t row_stride = (size_t)groups * kHeadDim;
  const size_t head_off = (size_t)g * kHeadDim;
  const size_t base = (size_t)g * n_splits;
  float* part_m = part;
  float* part_l = part + (size_t)groups * n_splits;
  float* part_acc = part + 2 * (size_t)groups * n_splits;
  const int d = threadIdx.x;

  float mb, lb, ab;
  if (kMode == kLoadOnly) {
    float row0[kElems] = {};
    float all = 0.f;
    walk_loads(k, v, row_stride, head_off, lo, hi, row0, all);
    reduce_groups(all, row0);
    all = warp_sum(all);          // lane 0: the warp's values summed 8 times (a sink)
    const int warp = d / 32, lane = d % 32;
    if (lane == 0) sm_l[warp] = all;
    if (lane < kGroupLanes) {
#pragma unroll
      for (int e = 0; e < kElems; ++e) sm_acc[warp * kHeadDim + lane * kElems + e] = row0[e];
    }
    __syncthreads();
    lb = 0.f;
    ab = 0.f;
    if (d < kHeadDim) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        lb += sm_l[w];
        ab += sm_acc[w * kHeadDim + d];
      }
    }
    if (!arrive_last(0.f, lb, ab, part_m + base + split, part_l + base + split,
                     part_acc + (base + split) * kHeadDim, counters + g, n_splits, &sm_last))
      return;
    if (d < kHeadDim) {
      float s = 0.f;
      for (int i = 0; i < n_splits; ++i) s += __ldcg(part_acc + (base + i) * kHeadDim + d);
      store1(out + head_off + d, s);
    }
    return;
  }

  float qv[kElems];
  load_lane(q + head_off, qv);
  float m = -INFINITY, l = 0.f;
  float acc[kElems] = {};
  walk_keys<T, kWarps, kMode == kComputeOnly ? kChunk : 0>(k, v, qv, row_stride, head_off, lo,
                                                           hi, 0, 0, m, l, acc);
  reduce_groups(l, acc);
  merge_warps<kWarps>(m, l, acc, sm_m, sm_l, sm_acc, mb, lb, ab);
  if (!arrive_last(mb, lb, ab, part_m + base + split, part_l + base + split,
                   part_acc + (base + split) * kHeadDim, counters + g, n_splits, &sm_last))
    return;
  if (d < kHeadDim) {
    merge_parts(part_m + base, part_l + base, part_acc + base * kHeadDim, n_splits, d, mb, lb,
                ab);
    store1(out + head_off + d, lb > 0.f ? ab / lb : 0.f);
  }
}

template <typename T, int kMode>
int launch(const void* q, const void* k, const void* v, void* out, float* part, int* counters,
           int groups, int pos, int n_splits, cudaStream_t stream) {
  anatomy_kernel<T, kMode><<<dim3(groups, n_splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), part, counters, groups, pos, n_splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int mode, const void* q, const void* k, const void* v, void* out, float* part,
             int* counters, int groups, int pos, int n_splits, cudaStream_t s) {
  switch (mode) {
    case kFull:
      return launch<T, kFull>(q, k, v, out, part, counters, groups, pos, n_splits, s);
    case kLoadOnly:
      return launch<T, kLoadOnly>(q, k, v, out, part, counters, groups, pos, n_splits, s);
    case kComputeOnly:
      return launch<T, kComputeOnly>(q, k, v, out, part, counters, groups, pos, n_splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. mode: 0 full, 1 load_only, 2 compute_only;
// dtype: 0 = float32, 1 = bfloat16. n_splits must be splits_for(groups,
// lcache), and part / counters K1's workspace for that shape; load_only
// walks whole 64-slot chunks, so lcache must hold (pos / 64 + 1) * 64
// slots. Returns the cudaError_t of the launch (0 on success); it never
// synchronises and allocates nothing.
extern "C" int cbx_decode_anatomy(const void* q, const void* k, const void* v, void* out,
                                  float* part, int* counters, int groups, int head_dim,
                                  int lcache, int pos, int n_splits, int mode, int dtype,
                                  void* stream) {
  if (head_dim != kHeadDim || pos < 0 || pos >= lcache ||
      n_splits != splits_for(groups, lcache) || (pos / kChunk + 1) * kChunk > lcache)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(mode, q, k, v, out, part, counters, groups, pos, n_splits, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(mode, q, k, v, out, part, counters, groups, pos, n_splits,
                                   s);
  return (int)cudaErrorInvalidValue;
}
