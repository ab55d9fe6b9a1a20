// Weight-stream probe (K5), written for Hopper (sm_90a). It replaces the
// Pallas TPU kernel scripts/microbench_weight_stream.py:_kernel (entry
// stream_once): stream a wall of weights through on-chip memory in slabs,
// with a small matrix product as the consumer, to measure what a hand-written
// stream of the decode step's weights reaches on the card.
//
// What it computes (the same function as the TPU kernel):
//   x    (8, 1024)            bf16 activations (the decode rows, padded to 8)
//   w    (n_chunks, R, 1024)  bf16 or int8 wall, R a multiple of 128
//   out  (8, 128) fp32        out[i, c] = sum over all wall rows g with
//                             g % 128 == c of dot(x[i], w_flat[g])
// (per slab the TPU kernel forms y = x . w^T (8, R) and adds y's R / 128
// column groups into (8, 128); R % 128 == 0, so a row's group is its global
// index mod 128). bf16 products accumulate in fp32. With an int8 wall x is
// cast to int8 by truncation (as astype does) and products accumulate in
// int32, exactly.
//
// What bounds it on an H100: the wall's bytes (1 GB at full size against
// 0.07 MB of x and out), at 8 multiply-adds per weight: memory-bound by a
// factor of ~30 even on the fp32 SIMT pipes. So the design is about keeping
// enough bytes in flight, and slab size and ring depth stay parameters:
//   - The TPU kernel walks slab after slab on one core. Here every slab is
//     split over the grid: block b copies rows [b * rps, (b + 1) * rps) of
//     each slab (rps = R / blocks, one contiguous piece of rps * row_bytes)
//     into one stage of its ring in shared memory with cp.async, 16 bytes a
//     thread, `nbuf` stages deep: while slab c is consumed, slabs c + 1 ..
//     c + nbuf - 1 are in flight. Bytes in flight over the card are about
//     (nbuf - 1) * slab, which is what the sweep varies.
//   - Consumer: the block's 8 warps split the 1024 columns, 128 each, and a
//     lane owns 4 consecutive columns, whose 8 x values it keeps in registers
//     for the whole walk (32 floats, or 8 packed int8 words). A stage row is
//     read as one conflict-free 8-byte (bf16) or 4-byte (int8) load a lane.
//     A block's rows fall into the same rps groups in every slab, so the
//     partial sums stay in registers too (rps * 8 a lane) until the end.
//   - Merge: lanes by shuffle, warps through shared memory, into
//     partial[R][8]; a second kernel adds, for each (i, c), the partials of
//     rows c, c + 128, ... in ascending order. No atomics: the result is the
//     same bits in every run.
// rps is a template parameter (4, 8 or 16: the sweep's 1, 2 and 4 MB bf16
// slabs and 1 and 2 MB int8 slabs over 128 blocks) so that the accumulators
// stay in registers; the wrapper checks that R / blocks is one of them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 1024;        // the wall's row width (the model's d)
constexpr int kRowsX = 8;          // activation rows
constexpr int kGroups = 128;       // output column groups
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerLane = kCols / kThreads;   // 4

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's committed groups are still
// in flight (the instruction takes an immediate).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// The consumer's element-type-specific parts. Acc is the accumulator type,
// XRegs the registers that hold this lane's 8 x 4 activation values.
template <typename T>
struct Consume;

template <>
struct Consume<__nv_bfloat16> {
  using Acc = float;
  struct XRegs { float v[kRowsX][kColsPerLane]; };

  static __device__ __forceinline__ void load_x(const __nv_bfloat16* x, int col, XRegs& xr) {
#pragma unroll
    for (int i = 0; i < kRowsX; ++i)
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        xr.v[i][c] = __bfloat162float(x[i * kCols + col + c]);
  }

  // one stage row: this lane's 4 weights against its 8 x 4 activations
  static __device__ __forceinline__ void row(const unsigned char* srow, int col,
                                             const XRegs& xr, Acc* acc) {
    const uint2 raw = *reinterpret_cast<const uint2*>(srow + col * 2);
    const float2 w01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 w23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
#pragma unroll
    for (int i = 0; i < kRowsX; ++i) {
      float a = acc[i];
      a = fmaf(w01.x, xr.v[i][0], a);
      a = fmaf(w01.y, xr.v[i][1], a);
      a = fmaf(w23.x, xr.v[i][2], a);
      a = fmaf(w23.y, xr.v[i][3], a);
      acc[i] = a;
    }
  }

  static __device__ __forceinline__ float to_float(Acc a) { return a; }
};

template <>
struct Consume<int8_t> {
  using Acc = int;
  struct XRegs { int v[kRowsX]; };     // 4 int8 values packed in each word

  static __device__ __forceinline__ void load_x(const __nv_bfloat16* x, int col, XRegs& xr) {
#pragma unroll
    for (int i = 0; i < kRowsX; ++i) {
      unsigned packed = 0;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        // float -> int8 by truncation toward zero, clamped to int8's range
        int q = (int)__bfloat162float(x[i * kCols + col + c]);
        q = max(-128, min(127, q));
        packed |= ((unsigned)q & 0xffu) << (8 * c);
      }
      xr.v[i] = (int)packed;
    }
  }

  static __device__ __forceinline__ void row(const unsigned char* srow, int col,
                                             const XRegs& xr, Acc* acc) {
    const int w = *reinterpret_cast<const int*>(srow + col);
#pragma unroll
    for (int i = 0; i < kRowsX; ++i) acc[i] = __dp4a(w, xr.v[i], acc[i]);
  }

  static __device__ __forceinline__ float to_float(Acc a) { return (float)a; }
};

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// grid: `blocks` blocks of kThreads threads; dynamic shared memory:
// nbuf * kRps * kCols * sizeof(T) bytes of ring, then kWarps * kRps * 8
// accumulators for the merge.
template <typename T, int kRps>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const __nv_bfloat16* __restrict__ x, const T* __restrict__ w,
              float* __restrict__ partial, int n_chunks, int rows, int nbuf) {
  using C = Consume<T>;
  using Acc = typename C::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStageBytes = kRps * kCols * (int)sizeof(T);
  constexpr int kCopies = kStageBytes / (16 * kThreads);    // 16-byte copies a thread
  static_assert(kStageBytes % (16 * kThreads) == 0, "a stage is whole 16-byte copies");

  const int tid = threadIdx.x;
  const int col = tid * kColsPerLane;               // warp w owns columns [128 w, 128 w + 128)
  const size_t slab_bytes = (size_t)rows * kCols * sizeof(T);
  const unsigned char* src0 = reinterpret_cast<const unsigned char*>(w)
                              + (size_t)blockIdx.x * kStageBytes;

  auto prefetch = [&](int c) {
    if (c < n_chunks) {
      const unsigned char* src = src0 + (size_t)c * slab_bytes;
      unsigned char* dst = smem + (size_t)(c % nbuf) * kStageBytes;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int off = (i * kThreads + tid) * 16;
        cp_async16(dst + off, src + off);
      }
    }
    cp_async_commit();          // an empty group past the end keeps the count regular
  };

  for (int c = 0; c < nbuf - 1; ++c) prefetch(c);

  typename C::XRegs xr;
  C::load_x(x, col, xr);
  Acc acc[kRps][kRowsX];
#pragma unroll
  for (int j = 0; j < kRps; ++j)
#pragma unroll
    for (int i = 0; i < kRowsX; ++i) acc[j][i] = 0;

  for (int c = 0; c < n_chunks; ++c) {
    // slab c's group is the oldest of the nbuf - 1 in flight; when it has
    // landed for every thread, every thread has also finished consuming
    // slab c - 1, whose stage the next copy overwrites
    cp_async_wait(nbuf - 2);
    __syncthreads();
    prefetch(c + nbuf - 1);
    const unsigned char* stage = smem + (size_t)(c % nbuf) * kStageBytes;
#pragma unroll
    for (int j = 0; j < kRps; ++j)
      C::row(stage + (size_t)j * kCols * sizeof(T), col, xr, acc[j]);
  }
  cp_async_wait(0);

  // merge: lanes, then the 8 warps (each holds a 128-column share of every sum)
  Acc* red = reinterpret_cast<Acc*>(smem + (size_t)nbuf * kStageBytes);
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < kRps; ++j)
#pragma unroll
    for (int i = 0; i < kRowsX; ++i) {
      const Acc s = warp_sum(acc[j][i]);
      if (lane == 0) red[(warp * kRps + j) * kRowsX + i] = s;
    }
  __syncthreads();
  if (tid < kRps * kRowsX) {
    Acc s = 0;
#pragma unroll
    for (int wq = 0; wq < kWarps; ++wq) s += red[wq * kRps * kRowsX + tid];
    // tid = j * 8 + i; the block's row j is row blockIdx.x * kRps + j of a slab
    partial[((size_t)blockIdx.x * kRps) * kRowsX + tid] = C::to_float(s);
  }
}

// out[i][c] = sum of partial[g][i] over g = c, c + 128, ... < rows, in order.
__global__ void merge_kernel(const float* __restrict__ partial, float* __restrict__ out,
                             int rows) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= kRowsX * kGroups) return;
  const int i = t / kGroups, c = t % kGroups;
  float s = 0.f;
  for (int g = c; g < rows; g += kGroups) s += partial[(size_t)g * kRowsX + i];
  out[i * kGroups + c] = s;
}

template <typename T, int kRps>
int launch(const void* x, const void* w, float* partial, float* out, int n_chunks, int rows,
           int nbuf, int blocks, cudaStream_t stream) {
  const size_t smem = (size_t)nbuf * kRps * kCols * sizeof(T)
                      + (size_t)kWarps * kRps * kRowsX * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stream_kernel<T, kRps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stream_kernel<T, kRps><<<blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const T*>(w), partial, n_chunks, rows,
      nbuf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(kRowsX * kGroups + 255) / 256, 256, 0, stream>>>(partial, out, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, float* partial, float* out, int n_chunks, int rows,
             int nbuf, int blocks, cudaStream_t stream) {
  switch (rows / blocks) {
    case 4: return launch<T, 4>(x, w, partial, out, n_chunks, rows, nbuf, blocks, stream);
    case 8: return launch<T, 8>(x, w, partial, out, n_chunks, rows, nbuf, blocks, stream);
    case 16: return launch<T, 16>(x, w, partial, out, n_chunks, rows, nbuf, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. dtype: 1 = bfloat16 wall, 2 = int8 wall; x is
// bf16 in both. partial: rows * 8 floats of scratch; out: 8 * 128 floats.
// rows / blocks must be 4, 8 or 16 and 2 <= nbuf <= 8. Returns the
// cudaError_t of the launches (0 on success); it never synchronises and
// allocates nothing.
extern "C" int cbx_weight_stream(const void* x, const void* w, float* partial, float* out,
                                 int n_chunks, int rows, int cols, int nbuf, int blocks,
                                 int dtype, void* stream) {
  if (cols != kCols || rows % kGroups != 0 || blocks <= 0 || rows % blocks != 0 ||
      nbuf < 2 || nbuf > 8 || n_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, partial, out, n_chunks, rows, nbuf, blocks, s);
  if (dtype == 2)
    return dispatch<int8_t>(x, w, partial, out, n_chunks, rows, nbuf, blocks, s);
  return (int)cudaErrorInvalidValue;
}
