// The single-token decode attention walk shared by the flash-decode kernel
// (flash_decode.cu, K1 and its deferred-insert entry K1s), the fused T3
// decode step (fused_decode.cu, K4) and the decode-anatomy probe
// (decode_anatomy.cu, K6): one query row of one (row, head) against a
// sequence-major cache, fp32 online softmax, scale 1/sqrt(64).
//
// Layout: the key/value row of slot j for (row, head) bh starts at
// j * row_stride + bh * 64 (row_stride = B * H * 64, one layer's cache).
//
// Who holds what. A lane owns keys, not elements of every key: the 8 lanes
// of a group (lane / 8) share one key row, lane % 8 holding its elements
// 8 (lane % 8) ... + 7 (bf16: one 16-byte load; fp32: two). So one
// warp-wide load brings 4 keys, and q.k is a partial dot over 8 elements
// plus a 3-step shuffle inside the group. A block's warps walk a key range
// in tiles: slot u of warp w's group g holds key
//   base + (u * kWarps + w) * 4 + g,     u < kLoads (8 bf16, 4 fp32),
// all kLoads rows of k and of v loaded before any is used (32 keys, 8 KB in
// flight a warp). The softmax runs once a tile: one max over the tile's
// scores (warp-wide, so m stays warp-uniform), one exp2 a key with the
// scale folded into the exponent (scores and m stay unscaled), one rescale
// of the accumulator. P.V accumulates per lane over its own group's keys;
// the groups' sums are added once per range (reduce_groups).
//
// Exactness: a dead key (past the range's end, inside the hole) is never
// loaded and scores -inf, so its p is exactly 0 and its value row is never
// read; a tile with nothing live yet changes nothing. An empty range leaves
// m = -inf, l = 0, acc = 0.
//
// An int8 cache (K1's int8 entry) has a walk of its own, in flash_decode.cu:
// its slabs pass through shared memory, not registers, and it takes the
// group layout, the softmax a tile and the merges below.
//
// Everything here has internal linkage (an anonymous namespace): each .cu
// builds its own shared library, and a symbol with external linkage defined
// in two of them would be unified by the dynamic linker.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kGroupLanes = 8;                      // lanes that share a key row
constexpr int kGroups = 32 / kGroupLanes;           // keys a warp-wide load
constexpr int kElems = kHeadDim / kGroupLanes;      // elements a lane holds
// (1 / sqrt(64)) * log2(e): p = exp2((s - m) * kScaleLog2) = exp((s - m) / 8)
constexpr float kScaleLog2 = 0.125f * 1.4426950408889634f;

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One lane's 8 elements of a key or value row: the raw 16-byte loads, and
// their fp32 values. kLoads key rows are in flight a warp at once.
template <typename T>
struct Row;

template <>
struct Row<__nv_bfloat16> {
  static constexpr int kLoads = 8;
  struct Raw { uint4 a; };
  __device__ static Raw load(const __nv_bfloat16* p) {
    return {*reinterpret_cast<const uint4*>(p)};
  }
  __device__ static void unpack(const Raw& r, float (&o)[kElems]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Row<float> {
  static constexpr int kLoads = 4;
  struct Raw { float4 a, b; };
  __device__ static Raw load(const float* p) {
    return {reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1]};
  }
  __device__ static void unpack(const Raw& r, float (&o)[kElems]) {
    o[0] = r.a.x; o[1] = r.a.y; o[2] = r.a.z; o[3] = r.a.w;
    o[4] = r.b.x; o[5] = r.b.y; o[6] = r.b.z; o[7] = r.b.w;
  }
};

// This lane's 8 elements of a row that starts at p (q, k_cur, ...).
template <typename T>
__device__ __forceinline__ void load_lane(const T* p, float (&o)[kElems]) {
  Row<T>::unpack(Row<T>::load(p + (threadIdx.x % kGroupLanes) * kElems), o);
}

// The split-KV launches (K1, K1s, K6): a grid (B*H, S) of kSplitWarps-warp
// blocks, S = splits_for(B*H, Lc) -- kSplitBlocks / (B*H) rounded up, at
// most Lc / kMinSplitKeys, at least 1 (flash_decode.cu has the arithmetic;
// kernels/flash_decode.py:splits_for mirrors it).
constexpr int kSplitWarps = 4;
constexpr int kSplitBlocks = 512;    // B*H*S the split count aims at
constexpr int kMinSplitKeys = 32;    // slots a split covers at least, at full capacity

__host__ __device__ constexpr int splits_for(int bh, int lcache) {
  const int want = (kSplitBlocks + bh - 1) / bh;
  const int cap = (lcache + kMinSplitKeys - 1) / kMinSplitKeys;
  const int s = want < cap ? want : cap;
  return s > 1 ? s : 1;
}

// Keys per tile of a block of kWarps warps, each with kLoads rows in flight.
template <int kWarps, int kLoads>
__host__ __device__ constexpr int tile_keys() { return kWarps * kLoads * kGroups; }

// The block's warps walk the keys [lo, hi] minus [hole_lo, hole_hi) of the
// (row, head) at head_off, folding them into this warp's state (m, l, acc):
// m warp-uniform and unscaled, l and acc this lane's group's partial sums
// (acc: elements 8 (lane % 8) ...). q: this lane's 8 elements, fp32.
// kWrap > 0 reads slot j's row from cache row j % kWrap (the decode-anatomy
// probe's compute-only variant, which repeats one resident chunk); 0, the
// decode paths' value, reads row j. kLoads: key rows in flight a warp (the
// fused step, short of registers, takes fewer). Every thread of the block
// calls it with the same range.
template <typename T, int kWarps, int kWrap = 0, int kLoads = Row<T>::kLoads>
__device__ __forceinline__ void walk_keys(const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const float (&q)[kElems], size_t row_stride,
                                          size_t head_off, int lo, int hi, int hole_lo,
                                          int hole_hi, float& m, float& l,
                                          float (&acc)[kElems]) {
  using R = Row<T>;
  constexpr int U = kLoads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / kGroupLanes;
  const size_t lane_off = head_off + (lane % kGroupLanes) * kElems;
  for (int base = lo; base <= hi; base += tile_keys<kWarps, U>()) {
    typename R::Raw kr[U], vr[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + (u * kWarps + warp) * kGroups + g;
      live[u] = j <= hi && (j < hole_lo || j >= hole_hi);   // uniform in the group
      if (live[u]) {
        const size_t off = (size_t)(kWrap > 0 ? j % kWrap : j) * row_stride + lane_off;
        kr[u] = R::load(k + off);
        vr[u] = R::load(v + off);
      } else {
        kr[u] = typename R::Raw{};                    // scored, then masked to -inf
      }
    }
    float s[U];
    float tmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kk[kElems];
      R::unpack(kr[u], kk);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kElems; ++e) d = fmaf(q[e], kk[e], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      s[u] = live[u] ? d : -INFINITY;
      tmax = fmaxf(tmax, s[u]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 8));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 16));
    const float m_new = fmaxf(m, tmax);
    if (m_new == -INFINITY) continue;                // warp-uniform: nothing live yet
    const float alpha = exp2f((m - m_new) * kScaleLog2);   // 0 while m = -inf
    const float mc = m_new * kScaleLog2;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) continue;
      const float p = exp2f(fmaf(s[u], kScaleLog2, -mc));
      float vv[kElems];
      R::unpack(vr[u], vv);
      l += p;
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
    }
    m = m_new;
  }
}

// Add the 4 groups' partial l and acc of a warp: afterwards every lane
// holds the warp's l and the acc of its elements 8 (lane % 8) ... + 7.
__device__ __forceinline__ void reduce_groups(float& l, float (&acc)[kElems]) {
#pragma unroll
  for (int o = kGroupLanes; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
}

// Merge the states of the block's kWarps warps, after reduce_groups (every
// thread calls it; it synchronises the block). Threads d < kHeadDim get the
// merged m, l and acc[d]; an empty state is m = -inf, l = 0, acc = 0.
// sm_m, sm_l: kWarps floats; sm_acc: kWarps * kHeadDim floats.
template <int kWarps>
__device__ __forceinline__ void merge_warps(float m, float l, const float (&acc)[kElems],
                                            float* sm_m, float* sm_l, float* sm_acc,
                                            float& mb, float& lb, float& ab) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (lane < kGroupLanes) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) sm_acc[warp * kHeadDim + lane * kElems + e] = acc[e];
  }
  __syncthreads();
  mb = -INFINITY;
  lb = 0.f;
  ab = 0.f;
  if (threadIdx.x < kHeadDim) {
    const int d = threadIdx.x;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sm_m[w]);
    if (mb > -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (sm_l[w] > 0.f) {
          const float f = exp2f((sm_m[w] - mb) * kScaleLog2);
          lb += sm_l[w] * f;
          ab += sm_acc[w * kHeadDim + d] * f;
        }
      }
    }
  }
}

// Thread d < kHeadDim: merge n partial states of one (row, head) written by
// other blocks of this launch (m[i], l[i], acc[i * kHeadDim + d]) in split
// order with the max-rescale; an empty partial (l = 0) adds nothing. The
// loads bypass L1 (another SM wrote them) and are issued kMergeLoads
// partials at a time before any is used, so a merge of S partials waits on
// about S / kMergeLoads round trips to L2, not 2 S.
constexpr int kMergeLoads = 16;

__device__ __forceinline__ void merge_parts(const float* m, const float* l, const float* acc,
                                            int n, int d, float& mb, float& lb, float& ab) {
  mb = -INFINITY;
  lb = 0.f;
  ab = 0.f;
  for (int i0 = 0; i0 < n; i0 += kMergeLoads) {
    float mi[kMergeLoads], li[kMergeLoads], ai[kMergeLoads];
#pragma unroll
    for (int u = 0; u < kMergeLoads; ++u) {
      const int i = i0 + u;
      li[u] = 0.f;
      if (i < n) {
        mi[u] = __ldcg(m + i);
        li[u] = __ldcg(l + i);
        ai[u] = __ldcg(acc + (size_t)i * kHeadDim + d);
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeLoads; ++u) {
      if (!(li[u] > 0.f)) continue;
      const float m_new = fmaxf(mb, mi[u]);
      const float alpha = exp2f((mb - m_new) * kScaleLog2);   // 0 while mb = -inf
      const float f = exp2f((mi[u] - m_new) * kScaleLog2);
      lb = lb * alpha + li[u] * f;
      ab = ab * alpha + ai[u] * f;
      mb = m_new;
    }
  }
}

// Write this block's partial state (threads d < kHeadDim hold it), then
// count the block in. Returns true in every thread of the block that
// finishes the (row, head) last; that block has reset the counter for the
// next launch (or the next layer) and may read every partial.
__device__ __forceinline__ bool arrive_last(float mb, float lb, float ab, float* part_m,
                                            float* part_l, float* part_acc, int* counter,
                                            int n, int* sm_flag) {
  if (threadIdx.x < kHeadDim) {
    part_acc[threadIdx.x] = ab;
    if (threadIdx.x == 0) {
      *part_m = mb;
      *part_l = lb;
    }
    __threadfence();               // the partial is visible before the count
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int before = atomicAdd(counter, 1);
    *sm_flag = before == n - 1;
    if (before == n - 1) *counter = 0;
  }
  __syncthreads();
  const bool last = *sm_flag;
  if (last) __threadfence();
  return last;
}

// Fold one more key (unscaled score s, this thread's value element vd) into
// an online-softmax state, after every other key (K1s's and K4's current
// row). An empty state (m = -inf, l = 0) takes the key alone.
__device__ __forceinline__ void fold_key(float s, float vd, float& m, float& l, float& a) {
  const float m_new = fmaxf(m, s);
  const float alpha = exp2f((m - m_new) * kScaleLog2);
  const float p = exp2f((s - m_new) * kScaleLog2);
  l = l * alpha + p;
  a = a * alpha + p * vd;
  m = m_new;
}

}  // namespace
