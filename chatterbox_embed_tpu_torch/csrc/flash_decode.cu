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
// An int8 row holds round(x / s) with one fp32 scale s a (slot, row, head):
// a score is ks * (q . kq) and a value adds (p * vs) * vq, l sums the
// unscaled p, so the walk dequantises nothing but the two scalars a key.
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
// H * D * sizeof(T) per layer (int8: 1 a slab element plus 8 a key for the
// two scales), against ~1 FLOP per byte -- it is memory-bound and, at the
// decode shapes (0.4-24 MB a call), latency-bound: one launch, one round of
// loads, one merge. Tensor cores do not apply: T3 has as many key/value heads
// as query heads (16), so each key row meets exactly one query row and every
// product is a GEMV; a wgmma would idle 63 of its 64 rows. The design:
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
//   A block walks its slots (a float or bf16 cache: decode_walk.cuh, 32
//   slots a warp in flight in registers, the softmax once a tile), merges its
//   4 warps, writes its partial and counts itself in (arrive_last). The last
//   block of a (row, head) merges the S partials with the max-rescale (an
//   empty split adds nothing, so no NaN), folds k_cur / v_cur in as one more
//   key with K1s, writes out, and puts the counter back to 0: no memset
//   launch, no second kernel.
//
// The int8 walk (walk_int8 below) has the same split plan, group layout,
// softmax a tile and merges, and differs where an int8 row differs. Each
// choice was timed against scratch variants on an H100
// (scripts/torch_decode_check.py --builds; PERF.md §6):
//   - one wave: 512 blocks need 4 resident an SM (528 slots); a walk that
//     held 16 rows of k and v a lane in registers took 160 and ran in 1.29
//     waves of 396 slots. This one is compiled for kInt8Blocks = 4 blocks
//     an SM (<= 128 registers; it takes 78, and ~18 KB of shared memory);
//   - slabs through cp.async, not registers: a tile's k and v rows (64
//     contiguous bytes a key) are copied 16 bytes a thread into a ring of
//     kInt8Stages shared-memory stages of kInt8Tile keys, the next tile in
//     flight while this one is scored, one barrier a tile; each lane reads
//     its 8 bytes of a key from shared memory (4 keys a warp-wide read, no
//     bank conflict). Two stages of 64 keys timed faster than 128-key
//     stages and than deeper rings of 32, 64 or 96;
//   - scales staged once a tile: one thread a key copies its two fp32
//     scales (the (L, Lc, B, H) planes put a (row, head)'s successive
//     scales B*H*4 bytes apart), in place of 8 lanes each loading them
//     while the tile is scored;
//   - int8 -> fp32 by byte permute: __byte_perm puts x ^ 0x80 into the low
//     byte of 2^23's bits, and one FADD of -(2^23 + 128) gives x exactly
//     (one PRMT and one FADD an element, where a sign-extending shift pair
//     and an I2F ran at a quarter of the FMA rate; the walk is bound by
//     latency, so the two timed alike). The offset is never folded into
//     the dot, where q . (2^23 + 128 + x) would lose x's low bits;
//   - a tile's slots are scored without a branch, so that their chains
//     interleave (a branch a slot cost 10-30 %).

#include "decode_walk.cuh"

#include <stdint.h>

namespace {

constexpr int kWarps = kSplitWarps;
constexpr int kThreads = kWarps * 32;

// The int8 walk's ring: kInt8Tile keys a stage, kInt8Stages stages; each
// warp's group scores kInt8Slots keys of a tile (kernels/flash_decode.py
// mirrors the tile as INT8_TILE and LOADS[torch.int8]).
constexpr int kInt8Tile = 64;
constexpr int kInt8Stages = 2;
constexpr int kInt8Blocks = 4;                      // resident blocks an SM, compiled for
constexpr int kInt8Slots = kInt8Tile / (kWarps * kGroups);
constexpr int kRowCopies = kHeadDim / 16;           // 16-byte copies a 64-byte int8 row
static_assert(kInt8Tile * kRowCopies % kThreads == 0, "whole copies a thread");
static_assert(kInt8Tile <= kThreads, "one thread a key's scales");
// int8 -> fp32: the bits 0x4B0000xx are 2^23 + xx, and xx = x + 128
constexpr unsigned kI8Magic = 0x4B000000u;
constexpr float kI8Offset = 8388736.0f;             // 2^23 + 128

struct Int8Stage {
  int8_t k[kInt8Tile][kHeadDim];
  int8_t v[kInt8Tile][kHeadDim];
  float ks[kInt8Tile];
  float vs[kInt8Tile];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ bool live_key(int j, int hi, int hole_lo, int hole_hi) {
  return j <= hi && (j < hole_lo || j >= hole_hi);
}

// A lane's 8 int8 elements (two words, element 0 in the low byte) as fp32
__device__ __forceinline__ void unpack_int8(uint2 r, float (&o)[kElems]) {
  const unsigned a = r.x ^ 0x80808080u, b = r.y ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = __uint_as_float(__byte_perm(a, kI8Magic, 0x7540 | i)) - kI8Offset;
    o[4 + i] = __uint_as_float(__byte_perm(b, kI8Magic, 0x7540 | i)) - kI8Offset;
  }
}

// Copy the live keys of the tile at `base` (k and v rows, then the two
// scales) into `st` as one commit group; a dead key is not copied. Past the
// range the group is empty, so the count stays one group a tile.
__device__ __forceinline__ void stage_tile(Int8Stage& st, const int8_t* __restrict__ k,
                                           const int8_t* __restrict__ v,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs, size_t row_stride,
                                           size_t head_off, size_t scale_stride,
                                           size_t scale_off, int base, int hi, int hole_lo,
                                           int hole_hi) {
  if (base <= hi) {
#pragma unroll
    for (int c = 0; c < kInt8Tile * kRowCopies / kThreads; ++c) {
      const int i = c * kThreads + threadIdx.x;
      const int key = i / kRowCopies, at = (i % kRowCopies) * 16;
      if (live_key(base + key, hi, hole_lo, hole_hi)) {
        const size_t off = (size_t)(base + key) * row_stride + head_off + at;
        copy16(&st.k[key][at], k + off);
        copy16(&st.v[key][at], v + off);
      }
    }
    const int key = threadIdx.x;
    if (key < kInt8Tile && live_key(base + key, hi, hole_lo, hole_hi)) {
      const size_t so = (size_t)(base + key) * scale_stride + scale_off;
      copy4(&st.ks[key], ks + so);
      copy4(&st.vs[key], vs + so);
    }
  }
  copy_commit();
}

// Fold the tile at `base` (staged in `st`) into this warp's state as
// walk_keys folds a tile: slot u of warp w's group g is the key
// base + (u * kWarps + w) * kGroups + g; one max a tile, one rescale. Every
// slot is scored, without a branch, so that the compiler interleaves the
// slots' independent chains (a branch a slot serialised them); a dead key's
// staged bytes are stale, and the selects drop its score and its value.
__device__ __forceinline__ void fold_tile(const Int8Stage& st, const float (&q)[kElems],
                                          int base, int hi, int hole_lo, int hole_hi,
                                          float& m, float& l, float (&acc)[kElems]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / kGroupLanes, at = (lane % kGroupLanes) * kElems;
  float s[kInt8Slots];
  float tmax = -INFINITY;
#pragma unroll
  for (int u = 0; u < kInt8Slots; ++u) {
    const int key = (u * kWarps + warp) * kGroups + g;
    float kk[kElems];
    unpack_int8(*reinterpret_cast<const uint2*>(&st.k[key][at]), kk);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < kElems; ++e) d = fmaf(q[e], kk[e], d);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    s[u] = live_key(base + key, hi, hole_lo, hole_hi) ? d * st.ks[key] : -INFINITY;
    tmax = fmaxf(tmax, s[u]);
  }
  tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 8));
  tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 16));
  const float m_new = fmaxf(m, tmax);
  if (m_new == -INFINITY) return;                  // warp-uniform: nothing live yet
  const float alpha = exp2f((m - m_new) * kScaleLog2);   // 0 while m = -inf
  const float mc = m_new * kScaleLog2;
  l *= alpha;
#pragma unroll
  for (int e = 0; e < kElems; ++e) acc[e] *= alpha;
#pragma unroll
  for (int u = 0; u < kInt8Slots; ++u) {
    const int key = (u * kWarps + warp) * kGroups + g;
    const float p = exp2f(fmaf(s[u], kScaleLog2, -mc));   // 0 for a dead key
    const float pv = live_key(base + key, hi, hole_lo, hole_hi) ? p * st.vs[key] : 0.f;
    float vv[kElems];
    unpack_int8(*reinterpret_cast<const uint2*>(&st.v[key][at]), vv);
    l += p;
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[e] = fmaf(pv, vv[e], acc[e]);
  }
  m = m_new;
}

// walk_keys for an int8 cache: the block's tiles of [lo, hi] minus the hole
// through the ring, kInt8Stages - 1 tiles in flight while one is scored.
// One barrier a tile: past it, tile t has landed for every thread and every
// warp is done with tile t - 1, whose stage then takes tile t + kInt8Stages
// - 1. Every thread of the block calls it with the same range.
__device__ __forceinline__ void walk_int8(Int8Stage* ring, const int8_t* __restrict__ k,
                                          const int8_t* __restrict__ v,
                                          const float* __restrict__ ks,
                                          const float* __restrict__ vs,
                                          const float (&q)[kElems], size_t row_stride,
                                          size_t head_off, size_t scale_stride,
                                          size_t scale_off, int lo, int hi, int hole_lo,
                                          int hole_hi, float& m, float& l,
                                          float (&acc)[kElems]) {
  static_assert(kInt8Stages >= 2, "a tile in flight while one is scored");
  const int n_tiles = hi >= lo ? (hi - lo) / kInt8Tile + 1 : 0;
#pragma unroll
  for (int t = 0; t < kInt8Stages - 1; ++t)
    stage_tile(ring[t], k, v, ks, vs, row_stride, head_off, scale_stride, scale_off,
               lo + t * kInt8Tile, hi, hole_lo, hole_hi);
  for (int t = 0; t < n_tiles; ++t) {
    copy_wait<kInt8Stages - 2>();                  // one group a tile: tile t has landed
    __syncthreads();
    const int ahead = t + kInt8Stages - 1;
    stage_tile(ring[ahead % kInt8Stages], k, v, ks, vs, row_stride, head_off, scale_stride,
               scale_off, lo + ahead * kInt8Tile, hi, hole_lo, hole_hi);
    fold_tile(ring[t % kInt8Stages], q, lo + t * kInt8Tile, hi, hole_lo, hole_hi, m, l, acc);
  }
}

// The block's range of the walk: row's span or [start, walk_end], cut into
// n_splits; and its hole. start_dev, when given, holds `start` on the device
// (a CUDA graph replays one launch for every text length of a bucket).
struct Range {
  int lo, hi, hole_lo, hole_hi;
};

__device__ __forceinline__ Range block_range(const int* __restrict__ hole,
                                             const int* __restrict__ span,
                                             const int* __restrict__ start_dev, int row,
                                             int lcache, int walk_end, int start, int split,
                                             int n_splits) {
  if (start_dev != nullptr) start = max(*start_dev, 0);
  if (span != nullptr) {
    start = max(span[2 * row], 0);
    walk_end = min(span[2 * row + 1], lcache - 1);
  }
  const int live = walk_end - start + 1;             // <= 0: nothing to walk
  const int per = live > 0 ? (live + n_splits - 1) / n_splits : 0;
  const int lo = start + split * per;
  Range r{lo, min(walk_end, lo + per - 1), 0, 0};
  if (hole != nullptr) {
    r.hole_lo = hole[2 * row];
    r.hole_hi = hole[2 * row + 1];
  }
  return r;
}

// After merge_warps: write the block's partial and count it in; the last
// block of the (row, head) merges the splits, folds K1s's current row in
// and writes out.
template <typename T>
__device__ __forceinline__ void finish(float mb, float lb, float ab, const T* __restrict__ q,
                                       const T* __restrict__ k_cur,
                                       const T* __restrict__ v_cur, T* __restrict__ out,
                                       float* __restrict__ part, int* __restrict__ counters,
                                       int bh, int split, int bh_total, int n_splits,
                                       float* sm_dot, int* sm_last) {
  const size_t base = (size_t)bh * n_splits;
  float* part_m = part;
  float* part_l = part + (size_t)bh_total * n_splits;
  float* part_acc = part + 2 * (size_t)bh_total * n_splits;
  if (!arrive_last(mb, lb, ab, part_m + base + split, part_l + base + split,
                   part_acc + (base + split) * kHeadDim, counters + bh, n_splits, sm_last))
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

// T: q, k_cur, v_cur, out and the cache (a float or bf16 cache)
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ hole, const int* __restrict__ span,
              const T* __restrict__ k_cur, const T* __restrict__ v_cur, T* __restrict__ out,
              float* __restrict__ part, int* __restrict__ counters, int bh_total, int heads,
              int lcache, int walk_end, int start, const int* __restrict__ start_dev,
              int n_splits) {
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps * kHeadDim];
  __shared__ float sm_dot[kHeadDim / 32];
  __shared__ int sm_last;
  const int bh = blockIdx.x;
  const Range r = block_range(hole, span, start_dev, bh / heads, lcache, walk_end, start,
                              blockIdx.y, n_splits);
  // q has the cache dtype (the wrapper checks), so q.k multiplies values of
  // one dtype exactly in fp32, as the TPU kernel's cache-dtype product does
  float qv[kElems];
  load_lane(q + (size_t)bh * kHeadDim, qv);
  float m = -INFINITY, l = 0.f;
  float acc[kElems] = {};
  walk_keys<T, kWarps>(k, v, qv, (size_t)bh_total * kHeadDim, (size_t)bh * kHeadDim, r.lo,
                       r.hi, r.hole_lo, r.hole_hi, m, l, acc);
  reduce_groups(l, acc);
  float mb, lb, ab;
  merge_warps<kWarps>(m, l, acc, sm_m, sm_l, sm_acc, mb, lb, ab);
  finish(mb, lb, ab, q, k_cur, v_cur, out, part, counters, bh, blockIdx.y, bh_total,
         n_splits, sm_dot, &sm_last);
}

// T: q, k_cur, v_cur and out; the cache is int8 with its scale planes
template <typename T>
__global__ void __launch_bounds__(kThreads, kInt8Blocks)
decode_kernel_int8(const T* __restrict__ q, const int8_t* __restrict__ k,
                   const int8_t* __restrict__ v, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const int* __restrict__ hole,
                   const int* __restrict__ span, const T* __restrict__ k_cur,
                   const T* __restrict__ v_cur, T* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ counters, int bh_total, int heads, int lcache,
                   int walk_end, int start, const int* __restrict__ start_dev,
                   int n_splits) {
  __shared__ __align__(16) Int8Stage ring[kInt8Stages];
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps * kHeadDim];
  __shared__ float sm_dot[kHeadDim / 32];
  __shared__ int sm_last;
  const int bh = blockIdx.x;
  const Range r = block_range(hole, span, start_dev, bh / heads, lcache, walk_end, start,
                              blockIdx.y, n_splits);
  // q.k multiplies q's values by the int8 ones exactly in fp32, as XLA's
  // fp32-accumulated dot of the int8 cache does
  float qv[kElems];
  load_lane(q + (size_t)bh * kHeadDim, qv);
  float m = -INFINITY, l = 0.f;
  float acc[kElems] = {};
  walk_int8(ring, k, v, k_scale, v_scale, qv, (size_t)bh_total * kHeadDim,
            (size_t)bh * kHeadDim, (size_t)bh_total, (size_t)bh, r.lo, r.hi, r.hole_lo,
            r.hole_hi, m, l, acc);
  reduce_groups(l, acc);
  float mb, lb, ab;
  merge_warps<kWarps>(m, l, acc, sm_m, sm_l, sm_acc, mb, lb, ab);
  finish(mb, lb, ab, q, k_cur, v_cur, out, part, counters, bh, blockIdx.y, bh_total,
         n_splits, sm_dot, &sm_last);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* k_scale,
           const float* v_scale, const int* hole, const int* span, const void* k_cur,
           const void* v_cur, void* out, float* part, int* counters, int batch, int heads,
           int lcache, int layer, int cache_pos, int start, const int* start_dev, int n_splits,
           cudaStream_t stream) {
  const int bh = batch * heads;
  const size_t scale_off = (size_t)layer * lcache * bh;
  const size_t layer_off = scale_off * kHeadDim;
  const int walk_end = k_cur != nullptr ? cache_pos - 1 : cache_pos;
  const dim3 grid(bh, n_splits);
  if (k_scale != nullptr)
    decode_kernel_int8<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const int8_t*>(k) + layer_off,
        static_cast<const int8_t*>(v) + layer_off, k_scale + scale_off, v_scale + scale_off,
        hole, span, static_cast<const T*>(k_cur), static_cast<const T*>(v_cur),
        static_cast<T*>(out), part, counters, bh, heads, lcache, walk_end, start, start_dev,
        n_splits);
  else
    decode_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k) + layer_off,
        static_cast<const T*>(v) + layer_off, hole, span, static_cast<const T*>(k_cur),
        static_cast<const T*>(v_cur), static_cast<T*>(out), part, counters, bh, heads,
        lcache, walk_end, start, start_dev, n_splits);
  return (int)cudaGetLastError();
}

template <typename T>
const void* kernel_of(bool int8) {
  return int8 ? reinterpret_cast<const void*>(&decode_kernel_int8<T>)
              : reinterpret_cast<const void*>(&decode_kernel<T>);
}

}  // namespace

// Plain C entry for ctypes. dtype: q's, 0 = float32, 1 = bfloat16.
// k_scale and v_scale are both null (k and v have q's dtype) or both given
// (k and v are int8, the int8 entry): one entry with two more optional
// pointers, as K1 and K1s share one with k_cur / v_cur, so that the wrapper
// declares and checks one signature. k_cur and
// v_cur are both null (K1) or both given (K1s); span (K1 only) replaces
// start and cache_pos for every row when it is not null. start_dev is null
// or a device int that replaces `start`, read by every block: a CUDA graph
// then captures one launch for every text length of a bucket (a negative
// one is taken as 0, as a span's start; a start past walk_end walks
// nothing). n_splits must be
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
                                int n_splits, int dtype, void* stream,
                                const int* start_dev) {
  if (head_dim != kHeadDim || n_splits != splits_for(batch * heads, lcache))
    return (int)cudaErrorInvalidValue;
  if ((k_cur == nullptr) != (v_cur == nullptr)) return (int)cudaErrorInvalidValue;
  if (span != nullptr && k_cur != nullptr) return (int)cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, k_scale, v_scale, hole, span, k_cur, v_cur, out, part,
                         counters, batch, heads, lcache, layer, cache_pos, start, start_dev,
                         n_splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, hole, span, k_cur, v_cur, out,
                                 part, counters, batch, heads, lcache, layer, cache_pos, start,
                                 start_dev, n_splits, s);
  return (int)cudaErrorInvalidValue;
}

// What the CUDA runtime reports of the kernel instance for q's dtype (0 =
// float32, 1 = bfloat16) on a float / bf16 cache (int8 = 0) or an int8 one:
// info[0] registers a thread, info[1] local (spill) bytes a thread, info[2]
// resident blocks an SM at 128 threads, info[3] static shared bytes a block.
// Returns the cudaError_t of the queries.
extern "C" int cbx_flash_decode_info(int dtype, int int8, int* info) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const void* fn = dtype == 0 ? kernel_of<float>(int8 != 0) : kernel_of<__nv_bfloat16>(int8 != 0);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = blocks;
  info[3] = (int)a.sharedSizeBytes;
  return (int)e;
}
