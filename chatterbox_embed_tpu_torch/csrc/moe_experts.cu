// Grouped SwiGLU of a mixture's routed experts (K7), written for Hopper
// (sm_90a). It replaces no TPU kernel: the JAX package runs no mixture of
// experts. It was added for T3's DeepSeek-V2 backbone
// (models/deepseek_v2.py), whose 26 MoE layers route each row to 6 of 64
// experts.
//
// What it computes: rows x (N, D) bf16 sorted by expert, expert e owning
// rows [offsets[e], offsets[e + 1]); for each row of expert e
//   h = silu(x . Wg[e]) * (x . Wu[e])      (F wide, stored bf16)
//   y = h . Wd[e]                          (D wide, fp32)
// Wg, Wu (E, D, F) and Wd (E, F, D) bf16, products accumulated in fp32.
// The offsets are read on the device and the grid is fixed, so a CUDA graph
// replays the launches whatever the routing is, with no host read.
//
// What bounds it on an H100: the touched experts' weights, 17.3 MB an
// expert, against few rows an expert: ~4 at a decode step (32 rows, 192
// assignments, ~43 of 64 experts touched as served, the largest ~18 rows);
// at a prefill (3,504 assignments) ~55 an expert when the rows are
// independent, and as served ~41 experts touched, the largest holding
// ~470 of its 584 rows. A prefill does 55-115 operations a weight byte,
// under the card's 295, so every call is bound by reading each touched
// expert's weights once. The design streams them once at any row count up
// to 128 an expert, on the tensor cores:
//   - Two launches, the gated product then the down product, each a
//     persistent grid of one block an SM. A block walks the work items
//     (expert, 64 output columns) of the touched experts, item blockIdx.x,
//     then every gridDim.x-th, in expert order; the items are counted from
//     the offsets on the device, so no block is spent on an empty expert.
//     An expert of more than 128 rows gives one item a column tile and
//     chunk of 128 rows, the chunks side by side, so that the tile's second
//     read finds it in L2.
//   - A and B swapped: wgmma's 64-row operand A is a 64 x 64 weight tile
//     (64 depths of W[e] by 64 output columns, read as stored: the columns
//     contiguous, so A is MN-major), and its N side is the item's rows of x
//     (K-major), as wide as the smallest of 8, 16, 32, 64, 128 that holds
//     them (W). The W rows read end at the item's last row, so no row past
//     it is read (nor past N, which the C entry is not told); the rows before
//     the item's first that fill out the width (an earlier expert's, or
//     zeros before row 0) enter only accumulator columns never stored.
//   - A producer warp (one lane) keeps a ring of stages full with TMA: a
//     stage holds one 64-deep step of the item's weight tiles (gate and up
//     in the gated launch, 8 KB each, marked evict-first in L2 unless the
//     expert's other chunks read them again) and of its rows (W x 128
//     bytes, one box), all under the 128-byte swizzle that the wgmma
//     descriptors name; an mbarrier counts the stage's bytes in. The ring
//     runs on across items, so one item's epilogue overlaps the next one's
//     loads.
//   - One consumer warpgroup issues the stage's wgmmas (4 depth slices of
//     16, fp32 accumulators, gate and up side by side in the gated launch),
//     keeps one stage's products in flight and hands the stage before back
//     to the producer. Its epilogue writes silu(g) * u rounded to bf16, or
//     y in fp32, for the item's rows only. Every output element is one
//     thread's sum in a fixed order: no atomics, the same bits in every
//     run, graphed or not.
// Every bound it has: K and the output width multiples of 64 (the wrapper
// asks for 128), row strides of 16 bytes (D = 2048, F = 1408 for
// DeepSeek-V2-Lite), fewer than 2^24 rows.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kTile = 64;                   // output columns of an item; depth of a stage
constexpr int kTileBytes = kTile * kTile * 2;   // one weight tile (8 KB)
constexpr int kMaxRows = 128;               // rows of an item (a chunk of an expert)
constexpr int kRowsBytes = kMaxRows * kTile * 2;    // the rows' slice of a stage (16 KB)
constexpr int kRingBytes = 196608;          // 6 gated stages of 32 KB, 8 down stages of 24 KB
constexpr uint64_t kRowsExtent = 1u << 24;  // the rows' map's height: no box reaches past N
constexpr uint64_t kEvictFirst = 0x12F0000000000000ull;    // L2 policies: read once,
constexpr uint64_t kEvictNormal = 0x1000000000000000ull;   // read again (chunks)

template <bool GATED>
struct Stages {
  static constexpr int kMats = GATED ? 2 : 1;
  static constexpr int kBytes = kMats * kTileBytes + kRowsBytes;
  static constexpr int kCount = kRingBytes / kBytes;
};

// the maps TMA reads: the weights (one or two) as (E * K, M) in 64 x 64
// boxes, the rows as (kRowsExtent, K) in boxes of 64 depths by 8 << b rows,
// one map a width, so that a stage's rows come in one copy (as 8-row boxes,
// a wide item's 8 or 16 copies a stage made K7 at a served prefill 39 %
// slower on an H100)
struct Maps {
  CUtensorMap w0, w1, x[5];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}
// a 2-d box of `map` at (inner c0, outer c1) into shared memory, counted on
// `bar`, kept in L2 by `policy`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "l"(policy)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads of an accumulator above the wait
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// wgmma descriptor of a tile whose rows are 128 bytes under the 128-byte
// swizzle: start address / 16, 8-row groups 1024 bytes apart (the leading
// offset is not used by these tiles; it is set to 16 bytes)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{64} << 32) | (uint64_t{1} << 62);
}

// d (64 x W fp32, W / 2 registers a thread) += A . B: A 64 x 16 MN-major (a
// weight tile's 16 depth rows of 64 columns), B W x 16 K-major (W rows' 16
// depths)
template <int W>
__device__ __forceinline__ void wgmma_tn(float (&d)[W / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tn<8>(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tn<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tn<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tn<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tn<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// One work item: expert e, output columns [col, col + 64), rows [r0, r0 + rows)
struct Item {
  int e, col, r0, rows, chunks;
};

// The items of the touched experts in order: expert by expert, within an
// expert column tile by column tile, within a tile its chunks of 128 rows.
// at(i) for increasing i, as a block walks them.
struct Walk {
  const int* off;
  int experts, tiles;
  int e = -1, base = 0, count = 0, chunks = 0;

  __device__ Walk(const int* off_, int experts_, int tiles_)
      : off(off_), experts(experts_), tiles(tiles_) {}

  __device__ bool at(int i, Item& it) {
    while (i >= base + count) {
      base += count;
      if (++e >= experts) return false;
      chunks = (off[e + 1] - off[e] + kMaxRows - 1) / kMaxRows;
      count = chunks * tiles;
    }
    const int local = i - base;
    const int chunk = local % chunks;
    it.e = e;
    it.col = (local / chunks) * kTile;
    it.r0 = off[e] + chunk * kMaxRows;
    it.rows = min(kMaxRows, off[e + 1] - it.r0);
    it.chunks = chunks;
    return true;
  }
};

__device__ __forceinline__ int width_of(int rows) {
  return rows <= 8 ? 8 : rows <= 16 ? 16 : rows <= 32 ? 32 : rows <= 64 ? 64 : 128;
}

// The consumer warpgroup's part of one item of width W: the item's nk
// stages through the ring (stage s, phase ph carried across items), then
// its epilogue. out is (N, M): bf16 silu(g) * u if GATED, else fp32.
template <bool GATED, int W>
__device__ __forceinline__ void consume(const Item& it, uint32_t ring, uint32_t full,
                                        uint32_t empty, int nk, int& s, uint32_t& ph,
                                        void* __restrict__ out, int M) {
  using St = Stages<GATED>;
  constexpr int R = W / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float g[R], u[GATED ? R : 1];
#pragma unroll
  for (int i = 0; i < R; ++i) g[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GATED ? R : 1); ++i) u[i] = 0.f;
  int prev = -1;
  for (int k = 0; k < nk; ++k) {
    mbar_wait(full + 8 * s, ph);
    const uint32_t a = ring + s * St::kBytes;
    const uint32_t b = a + St::kMats * kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_tn<W>(g, desc(a + kk * 16 * 128), desc(b + kk * 32));
      if constexpr (GATED) wgmma_tn<W>(u, desc(a + kTileBytes + kk * 16 * 128), desc(b + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<1>();                  // the stage before is read: hand it back
    if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    prev = s;
    if (++s == St::kCount) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  pin(g);
  if constexpr (GATED) pin(u);
  if (lane == 0) mbar_arrive(empty + 8 * prev);
  // d[4j + q]: column m = 16 warp + lane / 4 (+ 8 for q >= 2), stage row
  // n = 8j + 2 (lane % 4) + q % 2, which is row r0 + rows - W + n of x
  const int m0 = it.col + 16 * warp + (lane >> 2);
  const int first = it.r0 + it.rows - W;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
    if (n >= W - it.rows) {
      const size_t o = (size_t)(first + n) * M + m0 + ((i & 2) ? 8 : 0);
      if constexpr (GATED) {
        const float v = g[i] / (1.f + __expf(-g[i])) * u[i];
        reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
      } else {
        reinterpret_cast<float*>(out)[o] = g[i];
      }
    }
  }
}

// GATED: out (N, M) bf16 = silu(x . W0[e]) * (x . W1[e]); else out (N, M)
// fp32 = x . W0[e]. x (N, K) bf16; W0, W1 (E, K, M) bf16, all through `maps`.
template <bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
moe_kernel(const __grid_constant__ Maps maps, const int* __restrict__ offsets,
           void* __restrict__ out, int experts, int K, int M) {
  using St = Stages<GATED>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;   // the swizzle wants 1 KB
  const uint32_t full = ring + St::kCount * St::kBytes;           // kCount mbarriers
  const uint32_t empty = full + 8 * St::kCount;                   // kCount mbarriers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < St::kCount; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's arrival, with the bytes
      mbar_init(empty + 8 * s, kConsumers / 32);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nk = K / kTile;
  Walk walk(offsets, experts, M / kTile);
  Item it;
  if (warp == kConsumers / 32) {
    // the producer: one lane issues every copy
    if (lane != 0) return;
    int s = 0;
    uint32_t ph = 0;
    for (int i = blockIdx.x; walk.at(i, it); i += gridDim.x) {
      const int w = width_of(it.rows);
      const CUtensorMap* xmap = &maps.x[__ffs(w) - 4];   // 8 << b rows
      const uint32_t bytes = St::kMats * kTileBytes + w * kTile * 2;
      const int first = it.r0 + it.rows - w;     // the w rows end at the item's last row
      const uint64_t policy = it.chunks > 1 ? kEvictNormal : kEvictFirst;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        mbar_expect_tx(full + 8 * s, bytes);
        const uint32_t a = ring + s * St::kBytes;
        const int wrow = it.e * K + k * kTile;
        tma_load(a, &maps.w0, it.col, wrow, full + 8 * s, policy);
        if (GATED) tma_load(a + kTileBytes, &maps.w1, it.col, wrow, full + 8 * s, policy);
        tma_load(a + St::kMats * kTileBytes, xmap, k * kTile, first, full + 8 * s, kEvictNormal);
        if (++s == St::kCount) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  int s = 0;
  uint32_t ph = 0;
  for (int i = blockIdx.x; walk.at(i, it); i += gridDim.x) {
    switch (width_of(it.rows)) {
      case 8: consume<GATED, 8>(it, ring, full, empty, nk, s, ph, out, M); break;
      case 16: consume<GATED, 16>(it, ring, full, empty, nk, s, ph, out, M); break;
      case 32: consume<GATED, 32>(it, ring, full, empty, nk, s, ph, out, M); break;
      case 64: consume<GATED, 64>(it, ring, full, empty, nk, s, ph, out, M); break;
      default: consume<GATED, 128>(it, ring, full, empty, nk, s, ph, out, M); break;
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 matrix (rows, cols), rows `cols` apart, read in boxes of 64 columns
// by box_rows under the 128-byte swizzle; 0 or an error code
int make_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
             uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(ptr) & 15) || (cols * 2) % 16) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kTile, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <bool GATED>
int launch(const void* x, const void* offsets, const void* w0, const void* w1, void* out,
           int experts, int K, int M, cudaStream_t stream) {
  Maps maps;
  int rc = make_map(&maps.w0, w0, (uint64_t)experts * K, M, kTile);
  if (rc == 0 && GATED) rc = make_map(&maps.w1, w1, (uint64_t)experts * K, M, kTile);
  if (!GATED) maps.w1 = maps.w0;
  for (int b = 0; b < 5 && rc == 0; ++b) rc = make_map(&maps.x[b], x, kRowsExtent, K, 8u << b);
  if (rc != 0) return rc;
  using St = Stages<GATED>;
  const int smem = St::kCount * St::kBytes + 16 * St::kCount + 1024;
  cudaError_t err = cudaFuncSetAttribute(moe_kernel<GATED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  moe_kernel<GATED><<<sms, kThreads, smem, stream>>>(maps, static_cast<const int*>(offsets), out,
                                                     experts, K, M);
  return (int)cudaGetLastError();
}

}  // namespace

// h (N, F) bf16 scratch and y (N, D) fp32 output, both from the caller.
extern "C" int cbx_moe_experts(const void* x, const void* offsets, const void* w_gate,
                               const void* w_up, const void* w_down, void* h, void* y,
                               int n_experts, int d, int f, void* stream) {
  if (x == nullptr) return 0;      // no rows
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch<true>(x, offsets, w_gate, w_up, h, n_experts, d, f, s);
  if (rc != 0) return rc;
  return launch<false>(h, offsets, w_down, nullptr, y, n_experts, f, d, s);
}
