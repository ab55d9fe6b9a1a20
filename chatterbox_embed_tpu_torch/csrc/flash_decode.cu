// Split-KV flash-decode attention for the T3 decode step, written for Hopper
// (sm_90a), one launch a call. It replaces the Pallas TPU kernel
// chatterbox_embed_tpu/kernels/flash_decode.py:_kernel (entry decode_attention),
// both of its entries:
//   K1   one layer's cache (Lc, B, H, D); the walk covers [start, cache_pos];
//   K1s  the stacked cache (nL, Lc, B, H, D) with a layer index, and the
//        current token's k_cur / v_cur (B, H, D) folded in as one more key
//        after the walk, which then covers [start, cache_pos - 1]: the
//        current row is never read from the cache, so the caller can write
//        every layer's row in one stacked insert after the layer loop.
// and the int8 entry of both, which the TPU kernel does not have: the JAX
// package reads its int8 KV cache (CHATTERBOX_INT8_KV=1) through XLA only
// (chatterbox_embed_tpu/models/llama.py:418-440, "mode 1"), with the scales
// factored out of both dots. The port decodes through K1 at every row count,
// so K1 and K1s walk the int8 slabs themselves: a plain read of the int8
// cache would write a dequantised copy of every layer's live cache each step
// (read 1 byte, write 2, read 2 an element: 2.5x the bf16 cache's bytes).
//
// What it computes (the same as the TPU kernel): one query token per
// (row, head) attends to the live cache slots j of the walk, minus an
// optional per-row dead range [hole_lo, hole_hi), plus the current row with
// K1s. The softmax is an fp32 online softmax with scale 1/sqrt(D); q.k and
// p.v accumulate in fp32 whatever the input dtype; the output has q's dtype.
//
// K1 may take a per-row span in place of the shared [start, cache_pos]: row
// b then walks [span[b, 0], span[b, 1]] (clamped to [0, Lc - 1]) minus its
// hole. The continuous engine gives each slot's two CFG rows the keys
// [pad, p_len) of its own context plus the ring columns it wrote, a range
// that may wrap; with one hole a row this is (models/t3_engine.py:
// engine_spans):
//   no wrap: span [pad, p_len + c],  hole [p_len, p_len + a)
//   wrap:    span [pad, Lc - 1],     hole [p_len + c + 1, p_len + a)
// (c: this step's ring column, a: the slot's first). An empty span (lo > hi)
// writes 0, as a row with no live key does. The split count stays
// splits_for(B*H, Lc); each block cuts its own row's range.
//
//   q            (B, H, D)              contiguous
//   k, v         (nL, Lc, B, H, D)      contiguous, sequence-major (nL = 1
//                                       for K1); layer `layer` is read, as a
//                                       pointer offset (no copy); q's dtype,
//                                       or int8 with the scale planes
//   k_scale,     (nL, Lc, B, H) fp32    or null: the int8 cache's scales,
//   v_scale                             one a (slot, row, head)
//   hole         (B, 2) int32           or null
//   span         (B, 2) int32           or null (K1 only)
//   k_cur, v_cur (B, H, D)              or null (K1); q's dtype, unquantised
//   out          (B, H, D)              q's dtype
//   part         (D + 2) * B*H*S fp32   workspace: the splits' partials
//                                       (m, then l, then acc)
//   counters     (B*H) int32            workspace, zero between launches
//
// What bounds it on an H100: the live K/V bytes, 2 * (pos - start + 1) * B *
// H * D * sizeof(T) per layer, against ~1 FLOP per byte -- it is memory-bound
// and, at the decode shapes (0.8-24 MB a call), latency-bound: one launch,
// one round of loads, one merge. The design:
//   grid (B*H, S) of 128 threads, S = splits_for(B*H, Lc): kSplitBlocks /
//   (B*H) rounded up, at most Lc / kMinSplitKeys, at least 1. 512 blocks is
//   ~4 a SM of the 132, and 4 warps a block keep 16 warps an SM walking:
//     B=2  (B*H = 32):  S = 16, 512 blocks (Lc 512: at most 32 slots a split)
//     B=16 (B*H = 256): S = 2,  512 blocks
//   S depends on (B, H, Lc) only, so the launch shape is static across
//   decode steps (a CUDA graph can capture it). Each block splits the LIVE
//   range [start, walk_end] itself: split s takes ceil(live / S) slots from
//   start + s * ceil(live / S), so no block walks dead capacity; a split past
//   the walk's end reads nothing and leaves m = -inf, l = 0.
//   A block walks its slots with decode_walk.cuh (4 keys a warp-wide load,
//   32 slots a warp in flight, 64 of an int8 cache with their two scales,
//   the softmax once a tile), merges its 4 warps,
//   writes its partial and counts itself in (arrive_last). The last block of
//   a (row, head) merges the S partials with the max-rescale (an empty split
//   adds nothing, so no NaN), folds k_cur / v_cur in as one more key with
//   K1s, writes out, and puts the counter back to 0: no memset launch, no
//   second kernel.
// The int8 entry's bytes: 1 a slab element plus 8 a (slot, row, head) for
// the two scales, 136 a live key against bf16's 256 (0.53x); at the batch's
// B=16, Lc 512, pos 385 with holes about 12.9 MB against 24.3 MB. It rides
// the same walk, split plan and merge, so at these sizes it is bounded by
// the same latency first, not by its bytes.

#include "decode_walk.cuh"

namespace {

constexpr int kWarps = kSplitWarps;
constexpr int kThreads = kWarps * 32;

// T: q, k_cur, v_cur and out; C: the cache's slabs (T, or int8 with scales)
template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const C* __restrict__ k, const C* __restrict__ v,
              const float* __restrict__ k_scale, const float* __restrict__ v_scale,
              const int* __restrict__ hole, const int* __restrict__ span,
              const T* __restrict__ k_cur, const T* __restrict__ v_cur, T* __restrict__ out,
              float* __restrict__ part, int* __restrict__ counters, int bh_total, int heads,
              int lcache, int walk_end, int start, int n_splits) {
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps * kHeadDim];
  __shared__ float sm_dot[kHeadDim / 32];
  __shared__ int sm_last;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int row = bh / heads;
  if (span != nullptr) {
    start = max(span[2 * row], 0);
    walk_end = min(span[2 * row + 1], lcache - 1);
  }

  const int live = walk_end - start + 1;             // <= 0: nothing to walk
  const int per = live > 0 ? (live + n_splits - 1) / n_splits : 0;
  const int lo = start + split * per;
  const int hi = min(walk_end, lo + per - 1);
  int hole_lo = 0, hole_hi = 0;
  if (hole != nullptr) {
    hole_lo = hole[2 * row];
    hole_hi = hole[2 * row + 1];
  }

  // q has the cache dtype (the wrapper checks), or the cache is int8, so q.k
  // multiplies values of q's dtype and the cache's exactly in fp32, as the
  // TPU kernel's cache-dtype product (and XLA's fp32-accumulated dot of the
  // int8 cache) does
  float qv[kElems];
  load_lane(q + (size_t)bh * kHeadDim, qv);
  float m = -INFINITY, l = 0.f;
  float acc[kElems] = {};
  walk_keys<C, kWarps>(k, v, qv, (size_t)bh_total * kHeadDim, (size_t)bh * kHeadDim, lo, hi,
                       hole_lo, hole_hi, m, l, acc, k_scale, v_scale, (size_t)bh_total,
                       (size_t)bh);
  reduce_groups(l, acc);
  float mb, lb, ab;
  merge_warps<kWarps>(m, l, acc, sm_m, sm_l, sm_acc, mb, lb, ab);

  const size_t base = (size_t)bh * n_splits;
  float* part_m = part;
  float* part_l = part + (size_t)bh_total * n_splits;
  float* part_acc = part + 2 * (size_t)bh_total * n_splits;
  if (!arrive_last(mb, lb, ab, part_m + base + split, part_l + base + split,
                   part_acc + (base + split) * kHeadDim, counters + bh, n_splits, &sm_last))
    return;
  const int d = threadIdx.x;
  if (d < kHeadDim)
    merge_parts(part_m + base, part_l + base, part_acc + base * kHeadDim, n_splits, d, mb,
                lb, ab);
  if (k_cur != nullptr) {
    // K1s: the current token's row is the last key
    const size_t e = (size_t)bh * kHeadDim + d;
    if (d < kHeadDim) {
      const float dot = warp_sum(load1(q + e) * load1(k_cur + e));
      if (d % 32 == 0) sm_dot[d / 32] = dot;
    }
    __syncthreads();
    if (d < kHeadDim) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kHeadDim / 32; ++w) s += sm_dot[w];
      fold_key(s, load1(v_cur + e), mb, lb, ab);
    }
  }
  if (d < kHeadDim) store1(out + (size_t)bh * kHeadDim + d, lb > 0.f ? ab / lb : 0.f);
}

template <typename T, typename C>
int launch(const void* q, const void* k, const void* v, const float* k_scale,
           const float* v_scale, const int* hole, const int* span, const void* k_cur,
           const void* v_cur, void* out, float* part, int* counters, int batch, int heads,
           int lcache, int layer, int cache_pos, int start, int n_splits,
           cudaStream_t stream) {
  const int bh = batch * heads;
  const size_t scale_off = (size_t)layer * lcache * bh;
  const size_t layer_off = scale_off * kHeadDim;
  const int walk_end = k_cur != nullptr ? cache_pos - 1 : cache_pos;
  decode_kernel<T, C><<<dim3(bh, n_splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k) + layer_off,
      static_cast<const C*>(v) + layer_off, k_scale ? k_scale + scale_off : nullptr,
      v_scale ? v_scale + scale_off : nullptr, hole, span, static_cast<const T*>(k_cur),
      static_cast<const T*>(v_cur), static_cast<T*>(out), part, counters, bh, heads, lcache,
      walk_end, start, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. dtype: q's, 0 = float32, 1 = bfloat16.
// k_scale and v_scale are both null (k and v have q's dtype) or both given
// (k and v are int8, the int8 entry): one entry with two more optional
// pointers, as K1 and K1s share one with k_cur / v_cur, so that the wrapper
// declares and checks one signature. k_cur and
// v_cur are both null (K1) or both given (K1s); span (K1 only) replaces
// start and cache_pos for every row when it is not null. n_splits must be
// splits_for(batch * heads, lcache) (the wrapper's mirror sizes `part`
// with it); `counters` must hold batch * heads zeros before the first
// launch, and the kernel leaves them so. Returns the cudaError_t of the
// launch (0 on success); it never synchronises and allocates nothing.
extern "C" int cbx_flash_decode(const void* q, const void* k, const void* v,
                                const float* k_scale, const float* v_scale,
                                const int* hole, const int* span, const void* k_cur,
                                const void* v_cur, void* out, float* part,
                                int* counters, int batch, int heads, int head_dim,
                                int lcache, int layer, int cache_pos, int start,
                                int n_splits, int dtype, void* stream) {
  if (head_dim != kHeadDim || n_splits != splits_for(batch * heads, lcache))
    return (int)cudaErrorInvalidValue;
  if ((k_cur == nullptr) != (v_cur == nullptr)) return (int)cudaErrorInvalidValue;
  if (span != nullptr && k_cur != nullptr) return (int)cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool int8 = k_scale != nullptr;
  if (dtype == 0 && !int8)
    return launch<float, float>(q, k, v, nullptr, nullptr, hole, span, k_cur, v_cur, out,
                                part, counters, batch, heads, lcache, layer, cache_pos, start,
                                n_splits, s);
  if (dtype == 1 && !int8)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, hole, span, k_cur,
                                                v_cur, out, part, counters, batch, heads,
                                                lcache, layer, cache_pos, start, n_splits, s);
  if (dtype == 0)
    return launch<float, int8_t>(q, k, v, k_scale, v_scale, hole, span, k_cur, v_cur, out,
                                 part, counters, batch, heads, lcache, layer, cache_pos, start,
                                 n_splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale, hole, span, k_cur, v_cur,
                                         out, part, counters, batch, heads, lcache, layer,
                                         cache_pos, start, n_splits, s);
  return (int)cudaErrorInvalidValue;
}
