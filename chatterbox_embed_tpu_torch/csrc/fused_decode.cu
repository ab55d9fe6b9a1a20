// The whole T3 token step -- every Llama layer and the final RMSNorm -- in
// one launch, written for Hopper (sm_90a). It replaces the Pallas TPU kernel
// chatterbox_embed_tpu/kernels/fused_decode.py:_kernel (entry
// fused_decode_step, K4).
//
// What it computes (the same as the TPU kernel, with the same roundings to
// the compute dtype T): for B rows at one position, per layer i,
//   xn   = T(rmsnorm(h) * ln1[i])                        (fp32 norm)
//   q,k  = T(rope(T(xn . Wq^T))), T(rope(T(xn . Wk^T))); v = T(xn . Wv^T)
//   att  = T(softmax over cache slots [start, pos-1] plus the current row)
//   h    = T(h + T(att . Wo^T))
//   mm   = T(silu(xn2 . Wg^T) * (xn2 . Wu^T))            (xn2 = rmsnorm of h)
//   h    = T(h + T(mm . Wd))
// then h_out = T(rmsnorm(h) * fnorm). Every product accumulates in fp32.
// RoPE takes the position pos - start for every row (unragged rows; the
// caller gates). `start` may come from the device (start_dev), so that a
// CUDA graph replays one launch for every text length of a bucket. Each
// layer's new k/v row is written into the cache at slot pos; the attention
// never reads that slot, so the write is safe while the walk runs (the JAX
// package inserts it outside its kernel instead).
//
//   wall   (L, S, d) T   rows per layer [q^T k^T v^T | o^T | gate^T up^T |
//                        down^T laid flat over its I rows], one contiguous
//                        input row per output column (kernels/fused_decode.py:
//                        stack_for_fused)
//   ln1, ln2 (L, d), fnorm (d,) fp32;  inv_freq (hd/2,) fp32 (llama3 RoPE)
//   x (B, d) T;  cache_k, cache_v (L, Lc, B, H, 64) T, written at pos
//   h_out (B, d) T;  scratch h (B, d), qkv (B, 3*qo), att (B, qo),
//   mm (B, I) fp32, all holding values that T represents exactly; part
//   (B*H*kMaxSplits*(64 + 2)) fp32, the walk's partials; counters (B*H)
//   int32, set to 0 by the kernel
//
// What bounds it on an H100: the weight bytes. At T3's width (30 layers,
// d = 1024, I = 4096) the wall is 30 * 16384 * 1024 * 2 B = 1.0 GB in bf16,
// read once a step: ~0.3 ms at 3.35 TB/s, whatever B is up to ~16 rows.
// Then the latency of 5 grid-wide barriers a layer, and the cache walk.
//
// Design. One persistent cooperative launch: one block of 512 threads an
// SM (132 on an H100; a larger cooperative grid is refused with
// cudaErrorCooperativeLaunchTooLarge, which the entry returns), and
// cooperative_groups' grid.sync() separates the phases of a layer:
//   P1 qkv + RoPE   every block stages xn = T(rmsnorm(h)) for all rows in
//                   shared memory (each block recomputes the norm, so no
//                   barrier is spent on it); a warp owns a pair of output
//                   columns (j, j + hd/2) of one head, so it can rotate them
//                   itself; k and v rows go to the cache at pos.
//   P2 attention    the cache walk split across the whole grid: a task is
//                   (row, head, split), S = gridDim / (B*H) splits (at most
//                   kMaxSplits; 4 at B=2, 1 at B=16, where 256 tasks take
//                   two rounds of the 132 blocks), each a live-range
//                   split of [start, pos-1] walked by the block's 16 warps
//                   (decode_walk.cuh, shared with K1). The last block of a
//                   (row, head) to arrive merges the S partials, folds the
//                   current k/v in as one more key and writes att -- K1's
//                   counter scheme, so no barrier is added.
//   P3 o-proj       att staged in shared memory; two warps of a block share
//                   an output column (half its k-range each, added in
//                   shared memory), so the 1024 columns keep every warp of
//                   the grid busy; the residual goes into h.
//   P4 gate/up      rmsnorm(h) staged; a warp owns column j of gate and of
//                   up and writes T(silu(g) * u).
//   P5 down         mm staged; as P3, two warps to an output column of down
//                   (one contiguous I-long wall row), added into h.
// A warp reads each wall row once, 16 bytes a lane, coalesced, kDotLoads
// loads a lane in flight, and multiplies it with every row (B rows share
// each weight read); the sums are fp32 shuffle reductions. Staging loads
// kStageLoads values a thread before it stores any. The kernel is
// templated on a row count R in {2, 4, 8, 16}; rows b >= B are staged as
// zeros and never written.
// What the measurements chose (PERF.md, Findings: bf16, B = 2, Lc 512,
// pos 507, CUDA events over queued steps, each scratch build timed in turns
// with this one by scripts/torch_decode_check.py --builds): this design
// 1.33 ms; four or eight wall loads a lane in flight 1.47 / 1.63 ms (ptxas
// spills more); two blocks of 256 threads an SM 1.62 ms; the block's share
// of each wall phase asked of L2 (cp.async.bulk.prefetch.L2) one phase
// ahead 1.57 ms, or just before the barrier that precedes it 1.45 ms, and
// slower again with four or eight loads a lane. The step is bound by the
// latency of each phase's few dependent round trips (staging, wall loads,
// the write) and its 151 barriers, not by the wall's bytes.
// Not carried over from the TPU kernel: its DMA ring and block geometry
// (VMEM), the +-1 permutation matmul for RoPE, the one-hot row shuffles, and
// its rounding of q*k to the cache dtype before the sum.

#include <cooperative_groups.h>

#include "decode_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// walk splits a (row, head), at most: what 132 blocks give one row's 16
// heads (4 at B=2, 1 at B=16); the workspace is sized by it
constexpr int kMaxSplits = 8;
constexpr int kDotLoads = 2;                     // 16-byte wall loads a lane in flight, a row
constexpr int kStageLoads = 8;                   // activation loads a thread in flight, staging
constexpr int kWalkLoads = 4;                    // key rows a warp in flight in the walk

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static void unpack(float4 u, float* o) {
    o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
  }
  // weights stream once per step: the evict-first load keeps them from
  // pushing the caches and the scratch out of L2
  __device__ static Raw load_stream(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  __device__ static void load(const float* p, float* o) {
    unpack(*reinterpret_cast<const float4*>(p), o);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static void unpack(uint4 u, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ static Raw load_stream(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    unpack(*reinterpret_cast<const uint4*>(p), o);
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T to_t(float x);
template <>
__device__ __forceinline__ float to_t<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* wall;
  const float* ln1;
  const float* ln2;
  const float* fnorm;
  const float* inv_freq;
  const void* x;
  void* cache_k;
  void* cache_v;
  void* h_out;
  float* h;
  float* qkv;
  float* att;
  float* mm;
  float* part;
  int* counters;
  const int* start_dev;      // null, or the device int that replaces start
  int layers, rows, d, heads, hd, inter, lcache, pos, start, splits;
  float eps;
};

// One warp: y[b] = sum_k act[b][k] * w0[k] (and z[b] with w1), k < len, for
// the R staged rows; the result is in every lane. Each lane keeps kDotLoads
// 16-byte loads of each wall row in flight before it uses any.
template <typename T, int R, bool kTwo>
__device__ __forceinline__ void warp_dots(const T* act, int act_stride,
                                          const T* __restrict__ w0,
                                          const T* __restrict__ w1, int len,
                                          int lane, float (&y)[R],
                                          float (&z)[R]) {
  constexpr int N = Vec<T>::N;
  using Raw = typename Vec<T>::Raw;
#pragma unroll
  for (int b = 0; b < R; ++b) {
    y[b] = 0.f;
    z[b] = 0.f;
  }
  for (int k0 = lane * N; k0 < len; k0 += kDotLoads * 32 * N) {
    Raw ra[kDotLoads], rb[kDotLoads];
#pragma unroll
    for (int u = 0; u < kDotLoads; ++u) {
      const int k = k0 + u * 32 * N;
      if (k < len) {
        ra[u] = Vec<T>::load_stream(w0 + k);
        if constexpr (kTwo) rb[u] = Vec<T>::load_stream(w1 + k);
      }
    }
#pragma unroll
    for (int u = 0; u < kDotLoads; ++u) {
      const int k = k0 + u * 32 * N;
      if (k >= len) break;
      float wa[N], wb[N];
      Vec<T>::unpack(ra[u], wa);
      if constexpr (kTwo) Vec<T>::unpack(rb[u], wb);
#pragma unroll
      for (int b = 0; b < R; ++b) {
        float a[N];
        Vec<T>::load(act + (size_t)b * act_stride + k, a);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          y[b] = fmaf(a[e], wa[e], y[b]);
          if constexpr (kTwo) z[b] = fmaf(a[e], wb[e], z[b]);
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < R; ++b) {
    y[b] = warp_sum(y[b]);
    if constexpr (kTwo) z[b] = warp_sum(z[b]);
  }
}

// Every block: fn(b, k, src[b][k]) for every element of the R x len rows
// (0 for rows b >= rows), each thread keeping kStageLoads loads in flight
// before it uses any (a load followed by a store to shared memory would
// otherwise wait out each round trip to L2). src was written by other
// blocks before the last barrier: the loads bypass L1.
template <int R, typename F>
__device__ __forceinline__ void staged(const float* __restrict__ src, int len, int rows,
                                       F&& fn) {
  const int total = R * len;
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageLoads * kThreads) {
    float x[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = e0 + u * kThreads;
      x[u] = e < total && e / len < rows ? __ldcg(src + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = e0 + u * kThreads;
      if (e < total) fn(e / len, e % len, x[u]);
    }
  }
}

// Every block: act[b][k] = T(rmsnorm(h[b]) * scale[k]) for b < rows, zeros
// for rows <= b < R. fp32 sum of squares over the block, then 1/sqrt.
template <typename T, int R>
__device__ void stage_rmsnorm(const float* h, const float* __restrict__ scale, int d,
                              int rows, float eps, T* act, int act_stride,
                              float* red, float* inv_rms) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float ss[R];
#pragma unroll
  for (int b = 0; b < R; ++b) ss[b] = 0.f;
  staged<R>(h, d, rows, [&](int b, int, float x) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r == b) ss[r] = fmaf(x, x, ss[r]);
  });
#pragma unroll
  for (int b = 0; b < R; ++b) {
    const float t = warp_sum(ss[b]);
    if (lane == 0) red[b * kWarps + warp] = t;
  }
  __syncthreads();
  if (threadIdx.x < R) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[threadIdx.x * kWarps + w];
    inv_rms[threadIdx.x] = 1.0f / sqrtf(t / (float)d + eps);
  }
  __syncthreads();
  staged<R>(h, d, rows, [&](int b, int k, float x) {
    act[(size_t)b * act_stride + k] = to_t<T>(b < rows ? x * inv_rms[b] * __ldg(scale + k)
                                                       : 0.f);
  });
  __syncthreads();
}

// Every block: act[b][k] = src[b][k] (values T holds exactly), zeros for
// rows <= b < R.
template <typename T, int R>
__device__ void stage_copy(const float* src, int len, int rows, T* act,
                           int act_stride) {
  staged<R>(src, len, rows, [&](int b, int k, float x) {
    act[(size_t)b * act_stride + k] = to_t<T>(x);
  });
  __syncthreads();
}

// h[b][n] = T(h[b][n] + T(act[b] . wrow_n)) for the n < d output columns of
// one projection, whose wall rows (len long) start at w. Two warps of a
// block share a column, half of its k-range each; their sums meet in
// shared memory (sm_y: kWarps / 2 x R floats).
template <typename T, int R>
__device__ void residual_proj(const T* act, int act_stride, const T* __restrict__ w, int len,
                              float* h, int d, int rows, float* sm_y) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = warp / 2, half = warp % 2, span = len / 2;
  float y[R], unused[R];
  for (int base = blockIdx.x * (kWarps / 2); base < d; base += gridDim.x * (kWarps / 2)) {
    const int n = base + pair;                     // block-uniform trip count
    if (n < d)
      warp_dots<T, R, false>(act + half * span, act_stride,
                             w + (size_t)n * len + half * span, nullptr, span, lane, y,
                             unused);
    if (n < d && half == 1 && lane == 0) {
#pragma unroll
      for (int b = 0; b < R; ++b) sm_y[pair * R + b] = y[b];
    }
    __syncthreads();
    if (n < d && half == 0 && lane == 0) {
#pragma unroll
      for (int b = 0; b < R; ++b) {
        if (b >= rows) break;
        float* hp = h + (size_t)b * d + n;
        *hp = round_to<T>(*hp + round_to<T>(y[b] + sm_y[pair * R + b]));
      }
    }
    __syncthreads();
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
fused_step_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* act = reinterpret_cast<T*>(smem_raw);          // R x act_stride, T
  __shared__ float red[R * kWarps];
  __shared__ float inv_rms[R];
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps * kHeadDim];
  __shared__ float sm_y[kWarps / 2 * R];
  __shared__ int sm_last;

  const T* wall = static_cast<const T*>(p.wall);
  const T* x = static_cast<const T*>(p.x);
  T* cache_k = static_cast<T*>(p.cache_k);
  T* cache_v = static_cast<T*>(p.cache_v);
  const int d = p.d, hd = p.hd, inter = p.inter, rows = p.rows;
  const int qo = p.heads * hd;
  const int half = hd / 2;
  const int bh_total = rows * p.heads;
  const size_t s_total = (size_t)3 * qo + d + 3 * (size_t)inter;
  const int act_stride = d > inter ? d : inter;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;
  const size_t slot = (size_t)rows * qo;            // one cache slot, B*H*hd
  const int start = p.start_dev != nullptr ? max(*p.start_dev, 0) : p.start;
  const float rope_pos = (float)(p.pos - start);
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < rows * d;
       e += gridDim.x * kThreads)
    p.h[e] = load1(x + e);
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < bh_total; e += gridDim.x * kThreads)
    p.counters[e] = 0;
  grid.sync();

  for (int layer = 0; layer < p.layers; ++layer) {
    const size_t r0 = (size_t)layer * s_total;       // the layer's first wall row
    const T* w = wall + r0 * d;
    T* ck = cache_k + (size_t)layer * p.lcache * slot;
    T* cv = cache_v + (size_t)layer * p.lcache * slot;

    // P1: q, k, v and RoPE; k, v rows into the cache at pos
    stage_rmsnorm<T, R>(p.h, p.ln1 + (size_t)layer * d, d, rows, p.eps, act,
                        act_stride, red, inv_rms);
    for (int task = gwarp; task < 3 * qo / 2; task += nwarps) {
      const int seg = task / (qo / 2);              // 0 q, 1 k, 2 v
      const int t = task % (qo / 2);
      const int head = t / half, jj = t % half;
      const int c0 = seg * qo + head * hd + jj;
      float y0[R], y1[R];
      warp_dots<T, R, true>(act, act_stride, w + (size_t)c0 * d,
                            w + (size_t)(c0 + half) * d, d, lane, y0, y1);
      float cs = 1.f, sn = 0.f;
      if (seg < 2) {
        const float ang = rope_pos * p.inv_freq[jj];
        cs = cosf(ang);
        sn = sinf(ang);
      }
      if (lane == 0) {
#pragma unroll
        for (int b = 0; b < R; ++b) {
          if (b >= rows) break;
          const float a = round_to<T>(y0[b]), c = round_to<T>(y1[b]);
          float o0 = a, o1 = c;
          if (seg < 2) {
            o0 = round_to<T>(a * cs + (-c) * sn);
            o1 = round_to<T>(c * cs + a * sn);
          }
          float* dst = p.qkv + (size_t)b * 3 * qo + c0;
          dst[0] = o0;
          dst[half] = o1;
          if (seg > 0) {
            T* row = (seg == 1 ? ck : cv) + (size_t)p.pos * slot + (size_t)b * qo +
                     head * hd + jj;
            row[0] = to_t<T>(o0);
            row[half] = to_t<T>(o1);
          }
        }
      }
    }
    grid.sync();

    // P2: attention; task (row, head, split) walks a split of [start, pos-1]
    for (int task = blockIdx.x; task < bh_total * p.splits; task += gridDim.x) {
      const int bh = task % bh_total, split = task / bh_total;
      const int b = bh / p.heads, head = bh % p.heads;
      const float* qrow = p.qkv + (size_t)b * 3 * qo + head * hd;
      float q8[kElems], k8[kElems];
      load_lane(qrow, q8);
      load_lane(qrow + qo, k8);
      float s_cur = 0.f;                             // q . k_cur, in every lane
#pragma unroll
      for (int e = 0; e < kElems; ++e) s_cur = fmaf(q8[e], k8[e], s_cur);
      s_cur += __shfl_xor_sync(0xffffffffu, s_cur, 1);
      s_cur += __shfl_xor_sync(0xffffffffu, s_cur, 2);
      s_cur += __shfl_xor_sync(0xffffffffu, s_cur, 4);
      int lo = start, hi = p.pos - 1;
      {
        const int live = hi - lo + 1;
        const int per = live > 0 ? (live + p.splits - 1) / p.splits : 0;
        lo += split * per;
        hi = min(hi, lo + per - 1);
      }
      float m = -INFINITY, l = 0.f;
      float acc[kElems] = {};
      walk_keys<T, kWarps, 0, kWalkLoads>(ck, cv, q8, slot, (size_t)bh * hd, lo, hi, 0, 0, m, l,
                                          acc);
      reduce_groups(l, acc);
      float mb, lb, ab;
      merge_warps<kWarps>(m, l, acc, sm_m, sm_l, sm_acc, mb, lb, ab);
      const size_t pi = (size_t)bh * p.splits;
      float* part_m = p.part;
      float* part_l = p.part + (size_t)bh_total * p.splits;
      float* part_acc = p.part + 2 * (size_t)bh_total * p.splits;
      if (arrive_last(mb, lb, ab, part_m + pi + split, part_l + pi + split,
                      part_acc + (pi + split) * kHeadDim, p.counters + bh, p.splits,
                      &sm_last) &&
          threadIdx.x < kHeadDim) {
        merge_parts(part_m + pi, part_l + pi, part_acc + pi * kHeadDim, p.splits,
                    threadIdx.x, mb, lb, ab);
        fold_key(s_cur, qrow[2 * qo + threadIdx.x], mb, lb, ab);
        p.att[(size_t)b * qo + head * hd + threadIdx.x] = round_to<T>(ab / lb);
      }
      __syncthreads();                              // sm_* reused next round
    }
    grid.sync();

    // P3: o-proj, residual
    stage_copy<T, R>(p.att, qo, rows, act, act_stride);
    residual_proj<T, R>(act, act_stride, w + (size_t)3 * qo * d, qo, p.h, d, rows, sm_y);
    grid.sync();

    // P4: gate, up, SiLU
    stage_rmsnorm<T, R>(p.h, p.ln2 + (size_t)layer * d, d, rows, p.eps, act,
                        act_stride, red, inv_rms);
    const T* wg = w + (size_t)(3 * qo + d) * d;
    for (int j = gwarp; j < inter; j += nwarps) {
      float g[R], u[R];
      warp_dots<T, R, true>(act, act_stride, wg + (size_t)j * d,
                            wg + (size_t)(inter + j) * d, d, lane, g, u);
      if (lane == 0) {
#pragma unroll
        for (int b = 0; b < R; ++b) {
          if (b >= rows) break;
          const float silu = g[b] / (1.f + expf(-g[b]));
          p.mm[(size_t)b * inter + j] = round_to<T>(silu * u[b]);
        }
      }
    }
    grid.sync();

    // P5: down, residual
    stage_copy<T, R>(p.mm, inter, rows, act, act_stride);
    residual_proj<T, R>(act, act_stride, w + (size_t)(3 * qo + d + 2 * inter) * d, inter,
                        p.h, d, rows, sm_y);
    grid.sync();
  }

  // final RMSNorm, one block per row
  for (int b = blockIdx.x; b < rows; b += gridDim.x) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < d; k += kThreads) {
      const float v = p.h[(size_t)b * d + k];
      ss += v * v;
    }
    ss = warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) t += red[wi];
    const float r = 1.0f / sqrtf(t / (float)d + p.eps);
    T* out = static_cast<T*>(p.h_out) + (size_t)b * d;
    for (int k = threadIdx.x; k < d; k += kThreads)
      out[k] = to_t<T>(p.h[(size_t)b * d + k] * r * p.fnorm[k]);
    __syncthreads();
  }
}

// The grid of one template on the current device: the shared-memory
// attribute, the cooperative check and the occupancy query run once per
// (device, shared bytes), so that a launch makes no other runtime call (none
// inside a CUDA graph capture).
template <typename T, int R>
cudaError_t grid_for(void (*kern)(Params), size_t smem, int* grid) {
  static int set_dev = -1, set_grid = 0;
  static size_t set_smem = 0;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev == set_dev && smem == set_smem) {
    *grid = set_grid;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute((const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  set_dev = dev;
  set_smem = smem;
  set_grid = per_sm * sms;
  *grid = set_grid;
  return cudaSuccess;
}

// The launch is cudaLaunchKernelEx with the cooperative attribute (what
// cudaLaunchCooperativeKernel does), the form CUDA 12 documents for stream
// capture: a captured step keeps its grid-wide barriers.
template <typename T, int R>
int launch(const Params& p, cudaStream_t stream) {
  void (*kern)(Params) = fused_step_kernel<T, R>;
  const int act_stride = p.d > p.inter ? p.d : p.inter;
  const size_t smem = (size_t)R * act_stride * sizeof(T);
  int grid = 0;
  cudaError_t err = grid_for<T, R>(kern, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  Params arg = p;
  const int by_grid = grid / (p.rows * p.heads);
  arg.splits = by_grid < 1 ? 1 : (by_grid > kMaxSplits ? kMaxSplits : by_grid);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, arg);
}

template <typename T>
int launch_rows(const Params& p, int rows_t, cudaStream_t stream) {
  switch (rows_t) {
    case 2: return launch<T, 2>(p, stream);
    case 4: return launch<T, 4>(p, stream);
    case 8: return launch<T, 8>(p, stream);
    case 16: return launch<T, 16>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16; rows_t is the
// compiled row count (2, 4, 8 or 16, >= rows). part must hold rows * heads
// * kMaxSplits * (head_dim + 2) floats and counters rows * heads ints.
// start_dev is null or a device int that replaces `start` (then not checked
// here; the kernel takes a negative one as 0).
// Returns the cudaError_t of the launch (0 on success;
// cudaErrorCooperativeLaunchTooLarge when no block fits on an SM); it never
// synchronises and allocates nothing.
extern "C" int cbx_fused_decode(const void* wall, const float* ln1,
                                const float* ln2, const float* fnorm,
                                const float* inv_freq, const void* x,
                                void* cache_k, void* cache_v, void* h_out,
                                float* h, float* qkv, float* att, float* mm,
                                float* part, int* counters,
                                int layers, int rows, int rows_t, int d,
                                int heads, int head_dim, int inter, int lcache,
                                int pos, int start, int dtype, float eps,
                                void* stream, const int* start_dev) {
  if (head_dim != kHeadDim || heads * head_dim != d || rows < 1 || rows > rows_t ||
      pos < 0 || pos >= lcache || (start_dev == nullptr && (pos < start || start < 0)))
    return (int)cudaErrorInvalidValue;
  const Params p{wall, ln1, ln2, fnorm, inv_freq, x, cache_k, cache_v, h_out, h,
                 qkv, att, mm, part, counters, start_dev, layers, rows, d, heads, head_dim,
                 inter, lcache, pos, start, 1, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rows<float>(p, rows_t, s);
  if (dtype == 1) return launch_rows<__nv_bfloat16>(p, rows_t, s);
  return (int)cudaErrorInvalidValue;
}
