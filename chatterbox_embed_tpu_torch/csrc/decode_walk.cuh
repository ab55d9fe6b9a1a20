// The single-token decode attention walk shared by the flash-decode kernel
// (flash_decode.cu, K1 and its deferred-insert entry K1s), the fused T3
// decode step (fused_decode.cu, K4) and the decode-anatomy probe
// (decode_anatomy.cu, K6): one query row of one (row, head)
// against a sequence-major cache, fp32 online softmax, scale 1/sqrt(64).
//
// Layout: the key/value row of slot j for (row, head) bh starts at
// j * row_stride + bh * 64 (row_stride = B * H * 64, one layer's cache).
// Lane i of a warp holds elements 2i and 2i+1 of the 64-wide head, so one
// key row is one coalesced warp load and q.k is a 5-step shuffle reduction.
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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

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

// Fold one key (scaled score s, this thread's value element vd) into an
// online-softmax state. alpha is 0 while the state is empty (m = -inf).
__device__ __forceinline__ void fold_key(float s, float vd, float& m, float& l,
                                         float& a) {
  const float m_new = fmaxf(m, s);
  const float alpha = expf(m - m_new);
  const float p = expf(s - m_new);
  l = l * alpha + p;
  a = a * alpha + p * vd;
  m = m_new;
}

// One warp's walk over the slots j = first, first + step, ... <= last,
// skipping the dead range [hole_lo, hole_hi). Four slots are loaded before
// any is used, so each warp keeps eight row loads in flight. The state
// (m, l, acc) is the warp's; acc holds this lane's two elements.
// kWrap > 0 reads slot j's row from cache row j % kWrap (the decode-anatomy
// probe's compute-only variant, which repeats one resident chunk); 0, the
// decode paths' value, reads row j.
template <typename T, int kWrap = 0>
__device__ __forceinline__ void walk_keys(const T* __restrict__ k,
                                          const T* __restrict__ v, float2 qv,
                                          size_t row_stride, size_t head_off,
                                          int first, int last, int step,
                                          int hole_lo, int hole_hi, float scale,
                                          int lane, float& m, float& l,
                                          float2& acc) {
  constexpr int kUnroll = 4;
  for (int j0 = first; j0 <= last; j0 += kUnroll * step) {
    float2 kk[kUnroll], vv[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * step;
      live[u] = j <= last && !(j >= hole_lo && j < hole_hi);   // warp-uniform
      if (live[u]) {
        const int jr = kWrap > 0 ? j % kWrap : j;
        const size_t off = (size_t)jr * row_stride + head_off + 2 * lane;
        kk[u] = load2(k + off);
        vv[u] = load2(v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      const float s = warp_sum(qv.x * kk[u].x + qv.y * kk[u].y) * scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);                // 0 on the first key
      const float p = expf(s - m_new);
      l = l * alpha + p;
      acc.x = acc.x * alpha + p * vv[u].x;
      acc.y = acc.y * alpha + p * vv[u].y;
      m = m_new;
    }
  }
}

// Merge the states of the block's kWarps warps (every thread calls it; it
// synchronises the block). Threads d < kHeadDim get the merged m, l and
// acc[d]; an empty state is m = -inf, l = 0, acc = 0.
// sm_m, sm_l: kWarps floats; sm_acc: kWarps * kHeadDim floats.
template <int kWarps>
__device__ __forceinline__ void merge_warps(float m, float l, float2 acc,
                                            float* sm_m, float* sm_l,
                                            float* sm_acc, float& mb, float& lb,
                                            float& ab) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  sm_acc[warp * kHeadDim + 2 * lane] = acc.x;
  sm_acc[warp * kHeadDim + 2 * lane + 1] = acc.y;
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
          const float f = expf(sm_m[w] - mb);
          lb += sm_l[w] * f;
          ab += sm_acc[w * kHeadDim + d] * f;
        }
      }
    }
  }
}

}  // namespace
