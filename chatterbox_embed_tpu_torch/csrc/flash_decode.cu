// Split-KV flash-decode attention for the T3 decode step, written for Hopper
// (sm_90a). It replaces the Pallas TPU kernel
// chatterbox_embed_tpu/kernels/flash_decode.py:_kernel (entry decode_attention),
// both of its entries:
//   K1   one layer's cache (Lc, B, H, D); the walk covers [start, cache_pos];
//   K1s  the stacked cache (nL, Lc, B, H, D) with a layer index, and the
//        current token's k_cur / v_cur (B, H, D) folded in as one more key
//        after the walk, which then covers [start, cache_pos - 1]: the
//        current row is never read from the cache, so the caller can write
//        every layer's row in one stacked insert after the layer loop.
//
// What it computes (the same as the TPU kernel): one query token per
// (row, head) attends to the live cache slots j of the walk, minus an
// optional per-row dead range [hole_lo, hole_hi), plus the current row with
// K1s. The softmax is an fp32 online softmax with scale 1/sqrt(D); q.k and
// p.v accumulate in fp32 whatever the input dtype; the output has q's dtype.
//
//   q            (B, H, D)              contiguous
//   k, v         (nL, Lc, B, H, D)      contiguous, sequence-major (nL = 1
//                                       for K1); layer `layer` is read, as a
//                                       pointer offset (no copy)
//   hole         (B, 2) int32           or null
//   k_cur, v_cur (B, H, D)              or null (K1)
//   out          (B, H, D)
//
// What bounds it on an H100: the live K/V bytes, 2 * (pos - start + 1) * B *
// H * D * sizeof(T) per layer, against ~1 FLOP per byte -- it is memory-bound
// (and, at the decode shapes, latency-bound: a few MB per call). The design
// reads only live slots and splits the cache over many blocks so that the
// whole card streams it:
//   pass 1  grid (B*H, n_splits), 128 threads. A block owns the keys
//           [s * split_len, (s+1) * split_len) of one (row, head) (the
//           wrapper passes split_len = 32: each warp walks 8 keys, loading
//           4 before it uses any) and skips every slot outside the live
//           range, so a split wholly before `start`, after the walk's end or
//           inside the hole reads nothing and writes m = -inf, l = 0,
//           acc = 0. The walk and the merge of the 4 warps' online-softmax
//           states are decode_walk.cuh's, shared with the fused step (K4).
//   pass 2  grid (B*H), D threads: merges the n_splits partials of one
//           (row, head) with the usual max-rescale (splits with l = 0 add
//           nothing, so an empty split makes no NaN), then folds k_cur/v_cur
//           in as one more key with K1s.
// The grid covers the whole cache capacity whatever cache_pos is, so the
// launch shape is static across decode steps.

#include "decode_walk.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ hole,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int bh_total, int heads,
             int walk_end, int start, int split_len, int n_splits,
             float scale) {
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = bh / heads;

  int lo = split * split_len;
  int hi = lo + split_len - 1;                // inclusive
  if (lo < start) lo = start;
  if (hi > walk_end) hi = walk_end;
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
  walk_keys(k, v, qv, (size_t)bh_total * kHeadDim, (size_t)bh * kHeadDim,
            lo + warp, hi, kWarps, hole_lo, hole_hi, scale, lane, m, l, acc);

  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps * kHeadDim];
  float mb, lb, ab;
  merge_warps<kWarps>(m, l, acc, sm_m, sm_l, sm_acc, mb, lb, ab);
  if (threadIdx.x < kHeadDim) {
    const int d = threadIdx.x;
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
               const float* __restrict__ part_acc, const T* __restrict__ q,
               const T* __restrict__ k_cur, const T* __restrict__ v_cur,
               T* __restrict__ out, int n_splits, float scale) {
  __shared__ float sm_dot[kHeadDim / 32];
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
  if (k_cur != nullptr) {
    // K1s: the current token's row is the last key
    const size_t e = (size_t)bh * kHeadDim + d;
    const float part = warp_sum(load1(q + e) * load1(k_cur + e));
    if (d % 32 == 0) sm_dot[d / 32] = part;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kHeadDim / 32; ++w) s += sm_dot[w];
    fold_key(s * scale, load1(v_cur + e), mb, lb, ab);
  }
  store1(out + (size_t)bh * kHeadDim + d, lb > 0.f ? ab / lb : 0.f);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* hole,
           const void* k_cur, const void* v_cur, void* out, float* part_m,
           float* part_l, float* part_acc, int batch, int heads, int lcache,
           int layer, int cache_pos, int start, int split_len, int n_splits,
           cudaStream_t stream) {
  const int bh = batch * heads;
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  const size_t layer_off = (size_t)layer * lcache * bh * kHeadDim;
  const int walk_end = k_cur != nullptr ? cache_pos - 1 : cache_pos;
  split_kernel<T><<<dim3(bh, n_splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k) + layer_off,
      static_cast<const T*>(v) + layer_off, hole, part_m, part_l, part_acc, bh,
      heads, walk_end, start, split_len, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<bh, kHeadDim, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<const T*>(q),
      static_cast<const T*>(k_cur), static_cast<const T*>(v_cur),
      static_cast<T*>(out), n_splits, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. k_cur and
// v_cur are both null (K1) or both given (K1s). Returns the cudaError_t of
// the launches (0 on success); it never synchronises and allocates nothing.
extern "C" int cbx_flash_decode(const void* q, const void* k, const void* v,
                                const int* hole, const void* k_cur,
                                const void* v_cur, void* out, float* part_m,
                                float* part_l, float* part_acc, int batch,
                                int heads, int head_dim, int lcache, int layer,
                                int cache_pos, int start, int split_len,
                                int n_splits, int dtype, void* stream) {
  if (head_dim != kHeadDim) return (int)cudaErrorInvalidValue;
  if ((k_cur == nullptr) != (v_cur == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, hole, k_cur, v_cur, out, part_m, part_l,
                         part_acc, batch, heads, lcache, layer, cache_pos,
                         start, split_len, n_splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, hole, k_cur, v_cur, out, part_m,
                                 part_l, part_acc, batch, heads, lcache, layer,
                                 cache_pos, start, split_len, n_splits, s);
  return (int)cudaErrorInvalidValue;
}
