// K3b: the backward of the CFM estimator's key-masked self-attention (K3),
// written for Hopper (sm_90a). It replaces the two backward kernels of the
// stock Pallas TPU flash_attention that
// chatterbox_embed_tpu/models/layers.py:mha_flash calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0:
// _flash_attention_bwd_dq :1287, kernel :1146, and _flash_attention_bwd_dkv
// :941, kernel :796), with K3's masked semantics.
//
// What it computes, for every (row b, head h), scale = 1/sqrt(64):
//   s_ij   = scale * q_i . k_j,      P_ij = exp(s_ij - lse_i) over the valid
//            keys j of row b (0 at the others), lse_i the row's log-sum-exp
//   di_i   = dO_i . O_i              (O is K3's output, as the forward wrote it)
//   dS_ij  = P_ij (dO_i . v_j - di_i)
//   dq_i   = scale * sum_j dS_ij k_j
//   dk_j   = scale * sum_i dS_ij q_i,   dv_j = sum_i P_ij dO_i
// Every query row attends the valid keys, invalid query rows too (K3's
// forward, layers.mha's key-mask semantics). A row b with no valid key gets
// zero gradients (K3 writes 0 there). The backward recomputes lse: K3's
// forward does not store it, and its two headers stay as K2 shares them.
//
//   q, k, v, out, dout, dq, dk, dv   (B, T, H, 64) contiguous, float or bf16
//   key_valid                        (B, T) bool (one byte)
//   lse, di                          (B, H, T) fp32 scratch, written by dq
//
// Two kernels, launched in this order on one stream:
//   K3b-dq   one block a (query tile of 64, row, head). Pass 1 walks the
//            key tiles for the row max and sum, then lse; di from dO and O;
//            pass 2 walks the key tiles again and accumulates dq. Writes dq,
//            lse and di.
//   K3b-dkv  one block a (key tile of 64, row, head); it keeps its k and v
//            tile resident and walks every query tile (q, dO, lse, di),
//            accumulating dk and dv. A key tile with no valid key writes 0.
// Both skip a key tile with no valid key (__syncthreads_or over the tile's
// mask), so the work follows the mask, as the bound does.
//
// Design (simple and right first; SIMT, as K3's fp32 kernel): 256 threads, a
// 16 x 16 grid, each thread a 4 x 4 tile (rows ty + 16 i, columns
// tx + 16 j; the 16 threads of a row are 16 lanes of one warp, so row sums
// and maxima are 4-step shuffles). Tiles are staged in shared memory as
// fp32 with a row pitch of 65 (no bank conflicts on the column walks).
// Inputs of either type are read as fp32 and every sum is fp32; gradients
// are written in the input's type.
//
// What bounds it on an H100: arithmetic on the CUDA cores. dq does 4 and
// dkv 4 multiply-adds a (query, key, dim) (10 T^2 D operations a (row,
// head) is the bound's count: the forward's two products recomputed and
// three more); the inner loops load two shared-memory values for each
// multiply-add of a 4 x 4 tile, so they run well under the card's 67 TFLOP/s
// fp32. Tensor cores (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// Internal linkage: each .cu builds its own library (see masked_attention.cuh).
namespace cbx {
namespace {

constexpr int kTile = 64;       // query rows or keys a tile
constexpr int kD = 64;          // head width
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 tile each
constexpr int kPad = kD + 1;    // row pitch of a staged tile
constexpr int kTileFloats = kTile * kPad;
// dq: q, dO, k, v, dS tiles and the key mask
constexpr size_t kDqSmemBytes = sizeof(float) * 5 * kTileFloats + sizeof(int) * kTile;
// dkv: k, v, q, dO, P, dS tiles, lse and di of a query tile, the key mask
constexpr size_t kDkvSmemBytes =
    sizeof(float) * (6 * kTileFloats + 2 * kTile) + sizeof(int) * kTile;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [r0, r0 + 64) of one (row, head) of a (B, T, H, 64) tensor -> a
// [64][kPad] fp32 tile; rows past T read 0. `base` points at (b, 0, h, 0).
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ base, int r0,
                                      int seq, size_t stride) {
  for (int e = threadIdx.x; e < kTile * kD; e += kThreads) {
    const int r = e / kD;
    const int c = e % kD;
    const int t = r0 + r;
    dst[r * kPad + c] = t < seq ? to_f(base[(size_t)t * stride + c]) : 0.f;
  }
}

// acc[i][j] += sum_c a[ty + 16 i][c] * b[tx + 16 j][c]: row-by-row products
// of two staged tiles.
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll 8
  for (int c = 0; c < kD; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kPad + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kPad + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r p[ty + 16 i][r] * m[r][tx + 16 j]: a [64][64] weight
// tile times a staged tile.
__device__ __forceinline__ void tile_mm(float (&acc)[4][4], const float* p, const float* m,
                                        int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float pv[4], mv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kPad + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) mv[j] = m[r * kPad + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], mv[j], acc[i][j]);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The key mask of tile [k0, k0 + 64) into valid[]; true when any key of the
// tile is valid. A barrier: every thread of the block must call it.
__device__ __forceinline__ bool load_mask(int* valid, const unsigned char* __restrict__ mb,
                                          int k0, int seq) {
  const int tid = threadIdx.x;
  const int ok = tid < kTile && k0 + tid < seq && mb[k0 + tid] != 0;
  if (tid < kTile) valid[tid] = ok;
  return __syncthreads_or(ok) != 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const unsigned char* __restrict__ key_valid,
                        const T* __restrict__ out, const T* __restrict__ dout,
                        float* __restrict__ lse_out, float* __restrict__ di_out,
                        T* __restrict__ dq, int seq, int heads, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [64][kPad] this block's queries
  float* dos = qs + kTileFloats;      // [64][kPad] their dO
  float* ks = dos + kTileFloats;      // [64][kPad] a key tile
  float* vs = ks + kTileFloats;       // [64][kPad] its values
  float* ds = vs + kTileFloats;       // [64][kPad] dS of the tile
  int* valid = reinterpret_cast<int*>(ds + kTileFloats);   // [64]

  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t stride = (size_t)heads * kD;
  const size_t off = ((size_t)b * seq * heads + h) * kD;
  const unsigned char* mb = key_valid + (size_t)b * seq;

  stage(qs, q + off, q0, seq, stride);
  stage(dos, dout + off, q0, seq, stride);

  // pass 1: each query row's max and sum over the valid keys -> lse
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    if (!load_mask(valid, mb, k0, seq)) continue;
    stage(ks, k + off, k0, seq, stride);
    __syncthreads();
    float s[4][4] = {};
    tile_dot(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[tx + 16 * j] ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));   // finite: the tile has a valid key
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum16(rs);
      m[i] = m_new;
    }
    __syncthreads();   // ks and valid are rewritten by the next tile
  }

  // lse (-inf for a row without a valid key) and di = dO . O
  float lse[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    float part = 0.f;
    if (t < seq) {
      const T* o = out + off + (size_t)t * stride;
#pragma unroll
      for (int j = 0; j < 4; ++j) part = fmaf(dos[r * kPad + tx + 16 * j], to_f(o[tx + 16 * j]), part);
    }
    di[i] = row_sum16(part);
    if (tx == 0 && t < seq) {
      lse_out[(size_t)blockIdx.y * seq + t] = lse[i];
      di_out[(size_t)blockIdx.y * seq + t] = di[i];
    }
  }

  // pass 2: dq += dS . k over the valid key tiles
  float acc[4][4] = {};
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    if (!load_mask(valid, mb, k0, seq)) continue;
    stage(ks, k + off, k0, seq, stride);
    stage(vs, v + off, k0, seq, stride);
    __syncthreads();
    float s[4][4] = {};
    float dp[4][4] = {};
    tile_dot(s, qs, ks, ty, tx);
    tile_dot(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[tx + 16 * j] && lse[i] != -INFINITY
                            ? expf(s[i][j] * scale - lse[i]) : 0.f;
        ds[(ty + 16 * i) * kPad + tx + 16 * j] = p * (dp[i][j] - di[i]);
      }
    __syncthreads();
    tile_mm(acc, ds, ks, ty, tx);
    __syncthreads();   // ks, vs, ds and valid are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
    T* o = dq + off + (size_t)t * stride;
#pragma unroll
    for (int j = 0; j < 4; ++j) put(o + tx + 16 * j, acc[i][j] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const unsigned char* __restrict__ key_valid,
                         const T* __restrict__ dout, const float* __restrict__ lse_in,
                         const float* __restrict__ di_in, T* __restrict__ dk,
                         T* __restrict__ dv, int seq, int heads, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                   // [64][kPad] this block's keys
  float* vs = ks + kTileFloats;       // [64][kPad] their values
  float* qs = vs + kTileFloats;       // [64][kPad] a query tile
  float* dos = qs + kTileFloats;      // [64][kPad] its dO
  float* pt = dos + kTileFloats;      // [64 keys][kPad] P of the tile, transposed
  float* dst = pt + kTileFloats;      // [64 keys][kPad] dS of the tile, transposed
  float* lse_s = dst + kTileFloats;   // [64] lse of the query tile
  float* di_s = lse_s + kTile;        // [64] di of the query tile
  int* valid = reinterpret_cast<int*>(di_s + kTile);   // [64] this block's key mask

  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t stride = (size_t)heads * kD;
  const size_t off = ((size_t)b * seq * heads + h) * kD;
  const float* lse_b = lse_in + (size_t)blockIdx.y * seq;
  const float* di_b = di_in + (size_t)blockIdx.y * seq;

  float adk[4][4] = {};
  float adv[4][4] = {};
  if (load_mask(valid, key_valid + (size_t)b * seq, k0, seq)) {
    stage(ks, k + off, k0, seq, stride);
    stage(vs, v + off, k0, seq, stride);
    for (int q0 = 0; q0 < seq; q0 += kTile) {
      stage(qs, q + off, q0, seq, stride);
      stage(dos, dout + off, q0, seq, stride);
      if (threadIdx.x < kTile) {
        const int t = q0 + threadIdx.x;
        lse_s[threadIdx.x] = t < seq ? lse_b[t] : -INFINITY;
        di_s[threadIdx.x] = t < seq ? di_b[t] : 0.f;
      }
      __syncthreads();
      // key rows ty + 16 a against query columns tx + 16 c
      float s[4][4] = {};
      float dp[4][4] = {};
      tile_dot(s, ks, qs, ty, tx);
      tile_dot(dp, vs, dos, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float lse = lse_s[tx + 16 * c];
          const float p = valid[ty + 16 * a] && lse != -INFINITY
                              ? expf(s[a][c] * scale - lse) : 0.f;
          pt[(ty + 16 * a) * kPad + tx + 16 * c] = p;
          dst[(ty + 16 * a) * kPad + tx + 16 * c] = p * (dp[a][c] - di_s[tx + 16 * c]);
        }
      __syncthreads();
      tile_mm(adv, pt, dos, ty, tx);
      tile_mm(adk, dst, qs, ty, tx);
      __syncthreads();   // qs, dos, pt, dst, lse_s and di_s are rewritten next
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = k0 + ty + 16 * a;
    if (t >= seq) continue;
    T* ok = dk + off + (size_t)t * stride;
    T* ov = dv + off + (size_t)t * stride;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      put(ok + tx + 16 * c, adk[a][c] * scale);
      put(ov + tx + 16 * c, adv[a][c]);
    }
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* key_valid,
              const void* out, const void* dout, void* lse, void* di, void* dq, int batch,
              int seq, int heads, float scale, cudaStream_t stream) {
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(attention_bwd_dq_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)kDqSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_raised = true;
  }
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  attention_bwd_dq_kernel<T><<<grid, kThreads, kDqSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(key_valid), static_cast<const T*>(out),
      static_cast<const T*>(dout), static_cast<float*>(lse), static_cast<float*>(di),
      static_cast<T*>(dq), seq, heads, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_valid,
               const void* dout, const void* lse, const void* di, void* dk, void* dv,
               int batch, int seq, int heads, float scale, cudaStream_t stream) {
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)kDkvSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_raised = true;
  }
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  attention_bwd_dkv_kernel<T><<<grid, kThreads, kDkvSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(key_valid), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<T*>(dk),
      static_cast<T*>(dv), seq, heads, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int batch, int seq, int heads, int head_dim) {
  return batch < 1 || seq < 1 || heads < 1 || head_dim != kD || batch * heads > 65535;
}

}  // namespace
}  // namespace cbx

// Plain C entries for ctypes; both take the same arguments (the dq entry
// ignores dk and dv, the dkv entry out and dq). dtype: 0 = float32,
// 1 = bfloat16. head_dim must be 64. Each returns the cudaError_t of its
// launch (0 on success); neither synchronises nor allocates. Launch dq
// first: dkv reads the lse and di it writes.
extern "C" int cbx_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* key_valid, const void* out,
                                          const void* dout, void* lse, void* di, void* dq,
                                          void* dk, void* dv, int batch, int seq, int heads,
                                          int head_dim, int dtype, void* stream) {
  (void)dk;
  (void)dv;
  if (cbx::bad_shape(batch, seq, heads, head_dim)) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cbx::launch_dq<float>(q, k, v, key_valid, out, dout, lse, di, dq, batch, seq,
                                 heads, scale, s);
  if (dtype == 1)
    return cbx::launch_dq<__nv_bfloat16>(q, k, v, key_valid, out, dout, lse, di, dq, batch,
                                         seq, heads, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int cbx_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* key_valid, const void* out,
                                           const void* dout, void* lse, void* di, void* dq,
                                           void* dk, void* dv, int batch, int seq, int heads,
                                           int head_dim, int dtype, void* stream) {
  (void)out;
  (void)dq;
  if (cbx::bad_shape(batch, seq, heads, head_dim)) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cbx::launch_dkv<float>(q, k, v, key_valid, dout, lse, di, dk, dv, batch, seq,
                                  heads, scale, s);
  if (dtype == 1)
    return cbx::launch_dkv<__nv_bfloat16>(q, k, v, key_valid, dout, lse, di, dk, dv, batch,
                                          seq, heads, scale, s);
  return (int)cudaErrorInvalidValue;
}
