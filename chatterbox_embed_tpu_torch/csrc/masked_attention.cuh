// Masked softmax attention over a whole key row, written for Hopper (sm_90a):
// the fp32 kernel. One templated kernel serves two entries that differ only
// in the q.k width:
//   rel_attention.cu    cbx_rel_attention    (K2: the conformer's rel-pos
//                       attention, q.k over the augmented width Da = 576)
//   flash_attention.cu  cbx_flash_attention  (K3: the CFM estimator's
//                       self-attention, q.k over the head width 64)
// bf16 inputs go to the tensor-core kernel of masked_attention_tc.cuh; this
// one serves fp32 inputs only (the full-width consistency checks and the
// callers that run in fp32), where its fp32 arithmetic is the point.
//
// What it computes, for every (row b, head h, query t):
//   s[j]   = scale * sum_d q[b, t, h, d] * k[b, j, h, d]   over d < Da
//   out    = sum_{j valid} softmax_j(s) v[b, j, h, :]      over the keys j
//            with key_valid[b, j]; a row with no valid key writes 0
// in fp32 (an online softmax (m, l, acc) per query row). Invalid queries
// attend the valid keys as valid ones do (callers mask outputs).
//
//   q, k        (B, T, H, Da)  contiguous, read in place (no transposes)
//   v, out      (B, T, H, 64)  contiguous
//   key_valid   (B, T)         bool (one byte)
//
// Design (a simple one that is right): a block of 256 threads owns 64 query
// rows of one (row, head). It walks the keys in tiles of 64. For each tile
// it stages q and k through shared memory in 64-wide slices of the q.k width
// as fp32, and each thread accumulates a 4x4 score tile in registers (rows
// ty + 16 i, keys tx + 16 j: the 16 threads of a query row are 16 lanes of
// one warp, so the row max and row sum are 4-step shuffles). Invalid keys,
// and keys past T, get s = -inf and add nothing. The fp32 probabilities go
// to shared memory and the same 4x4 mapping accumulates p.v into the output
// tile in registers. Shared memory per block: 66,560 bytes (dynamic, above
// the 48 KB default; the launch raises the limit once).
//
// What bounds it on an H100: arithmetic, as fp32 FMAs on the CUDA cores; the
// inner loop is bound by shared-memory loads (8 loads for 16 FMAs), so it
// reaches well under the card's 67 TFLOP/s fp32. The kernel keeps its
// element-type parameter; float is the one type it is built for.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "masked_attention_tc.cuh"

// Everything here has internal linkage: each .cu that includes this header
// builds its own library, and a shared symbol (the static flag of a template,
// which the dynamic linker would unify across libraries) must not leak from
// one library into another.
namespace cbx {
namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kDC = 64;         // q.k width per staged slice
constexpr int kDV = 64;         // value and output width
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 tile each
constexpr int kPad = kDC + 1;   // row pitch of the staged q/k slices
constexpr int kPPad = kBK + 1;  // row pitch of the probability tile
constexpr size_t kSmemBytes =
    sizeof(float) * (kBQ * kPad + kBK * kPad + kBK * kDV + kBQ * kPPad) +
    sizeof(int) * kBK;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const unsigned char* __restrict__ key_valid,
                        T* __restrict__ out, float* __restrict__ lse, int seq,
                        int heads, int da, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBQ][kPad]
  float* ks = qs + kBQ * kPad;           // [kBK][kPad]
  float* vs = ks + kBK * kPad;           // [kBK][kDV]
  float* ps = vs + kBK * kDV;            // [kBQ][kPPad]
  int* valid = reinterpret_cast<int*>(ps + kBQ * kPPad);   // [kBK]

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // element (t, d) of this (row, head): base[t * stride + d]
  const size_t qk_stride = (size_t)heads * da;
  const size_t v_stride = (size_t)heads * kDV;
  const T* qb = q + ((size_t)b * seq * heads + h) * da;
  const T* kb = k + ((size_t)b * seq * heads + h) * da;
  const T* vb = v + ((size_t)b * seq * heads + h) * kDV;
  const unsigned char* mb = key_valid + (size_t)b * seq;

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    if (tid < kBK) valid[tid] = (k0 + tid < seq) && mb[k0 + tid] != 0;

    // scores of this key tile: s[i][j] = q[q0 + ty + 16 i] . k[k0 + tx + 16 j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < da; d0 += kDC) {
      for (int e = tid; e < kBQ * kDC; e += kThreads) {
        const int r = e / kDC;
        const int c = e % kDC;
        const int tq = q0 + r;
        const int tk = k0 + r;
        qs[r * kPad + c] = tq < seq ? to_float(qb[tq * qk_stride + d0 + c]) : 0.f;
        ks[r * kPad + c] = tk < seq ? to_float(kb[tk * qk_stride + d0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kDC; ++c) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kPad + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * kPad + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
      __syncthreads();
    }

    for (int e = tid; e < kBK * kDV; e += kThreads) {
      const int r = e / kDV;
      const int c = e % kDV;
      const int tk = k0 + r;
      vs[r * kDV + c] = tk < seq ? to_float(vb[tk * v_stride + c]) : 0.f;
    }

    // online softmax: fold this tile into each query row's (m, l, acc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[tx + 16 * j] ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // m_new = -inf: no valid key in this row yet, so p = 0 and the state
      // stays as it is (exp(-inf - -inf) would be NaN)
      const bool none = m_new == -INFINITY;
      const float alpha = none ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = none ? 0.f : expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPPad + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

    // acc[i][j] += sum_kk p[ty + 16 i][kk] * v[kk][tx + 16 j]
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kPPad + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vs[kk * kDV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
    // the row's log-sum-exp, +inf without a valid key (exp(s - lse) = 0)
    if (lse != nullptr && tx == 0)
      lse[(size_t)blockIdx.y * seq + t] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;   // no valid key: 0
    T* o = out + ((size_t)b * seq + t) * v_stride + (size_t)h * kDV;
#pragma unroll
    for (int j = 0; j < 4; ++j) store(o + tx + 16 * j, acc[i][j] * inv);
  }
}

// Launch on `stream`; no allocation, no synchronisation. Returns the
// cudaError_t of the launch (0 on success).
template <typename T>
int launch_masked_attention(const void* q, const void* k, const void* v,
                            const void* key_valid, void* out, float* lse, int batch,
                            int seq, int heads, int da, float scale,
                            cudaStream_t stream) {
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        masked_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_raised = true;
  }
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * heads);
  masked_attention_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(key_valid),
      static_cast<T*>(out), lse, seq, heads, da, scale);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 (this header's kernel), 1 = bfloat16 (the tensor-core
// kernel of masked_attention_tc.cuh; kNarrowOnly is its). `lse` null, or
// (B, H, T) fp32 for each query row's log-sum-exp (natural log, +inf for a
// row without a valid key): K3 under autograd, for K3b.
template <bool kNarrowOnly>
int dispatch_masked_attention(const void* q, const void* k, const void* v,
                              const void* key_valid, void* out, float* lse, int batch,
                              int seq, int heads, int da, float scale, int dtype,
                              void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || da < kDC || da % kDC != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_masked_attention<float>(q, k, v, key_valid, out, lse, batch, seq,
                                          heads, da, scale, s);
  if (dtype == 1)
    return dispatch_masked_attention_tc<kNarrowOnly>(q, k, v, key_valid, out, lse, batch,
                                                     seq, heads, da, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cbx
