// Masked softmax attention on the H100's tensor cores: the bf16 kernel behind
//   rel_attention.cu    cbx_rel_attention    (K2: the conformer's rel-pos
//                       attention, q.k over the augmented width Da = 576)
//   flash_attention.cu  cbx_flash_attention  (K3: the CFM estimator's
//                       self-attention, q.k over the head width 64)
// It replaces, for bf16 inputs, the Pallas TPU kernels
// chatterbox_embed_tpu/kernels/rel_attention.py:_kernel and the stock flash
// attention behind chatterbox_embed_tpu/models/layers.py:mha_flash. fp32
// inputs stay on the SIMT kernel of masked_attention.cuh, whose note states
// the function computed; this kernel computes the same:
//   out[b, t, h, :] = sum_{j valid} softmax_j(scale * q[b,t,h,:].k[b,j,h,:])
//                     v[b, j, h, :]
// with scores, softmax, the denominator (summed from the unrounded p) and the
// output sum in fp32, and p rounded to bf16 only as the operand of p.v. A
// row with no valid key writes 0; invalid queries attend the valid keys.
// Given an `lse` buffer (K3 under autograd), it also writes each query
// row's log-sum-exp (natural log; +inf for a row with no valid key), which
// K3b (flash_attention_bwd.cu) reads; K2 and serving pass none. K3b builds
// its bf16 kernels from the primitives below (cp.async, the swizzled tile
// descriptor, the ss and rs products, the live-tile bitmap).
//
// What bounds it on an H100: operations. K2 at (8, 812) is 5.4e10 FLOP against
// 133 MB of operands, K3 at (16, 812) 2.2e10 against 53 MB; both are far
// above the card's 295 FLOP a byte, so the least time is the tensor cores'
// (989 TFLOP/s in bf16). K3 (width 64) spends as many clocks on exp2 in the
// special-function units (16 a clock an SM) as on its two products.
//
// What the design does about it:
//   * Both products run as wgmma.mma_async m64n64k16 (bf16 in, fp32 out), one
//     warpgroup per 64 query rows. S = Q.K^T takes Q (resident in shared
//     memory for the whole block) and a 64-key x 64-wide slice of K, both
//     K-major; over Da = 64 * ns the ns slices of a key tile accumulate into
//     the same 32 registers a thread before the softmax runs. O += P.V takes
//     P from registers: the fp32 accumulator fragment of S, after the softmax,
//     packed pairwise to bf16x2, is the A fragment of the next wgmma, so P
//     never touches shared memory. V (keys x 64, the 64 contiguous) is the
//     transposed-B form.
//   * Row max: two shuffles within a quad of lanes. The row sum stays a
//     per-lane partial until the end (the rescale factor is the same in the
//     four lanes). exp2 with scale * log2(e) folded into the exponent's
//     multiply-add; the max is taken over the raw scores, so scale > 0.
//   * K slices and V tiles come through one ring of 8 KB stages (a 64 x 64
//     bf16 tile, rows of 128 bytes under the 128-byte swizzle that the wgmma
//     descriptors name), filled by 16-byte cp.async from all threads of the
//     block, kStages - 2 stages ahead of the products. Rows past T are
//     zero-filled (cp.async with a source size of 0), so a p of 0 never
//     meets stale bits.
//   * The products of stage i stay in flight while stage i + 1 is awaited;
//     p.v of a tile runs behind the next tile's q.k. The softmax of one
//     warpgroup overlaps the products of the others on the SM: 4 blocks
//     (K3) or 2 (K2, whose resident Q takes 72 KB). A block is one warpgroup:
//     two warpgroups sharing one K/V stream (128 query rows) halve the reads
//     of K from L2 but meet at a block barrier for every stage and then want
//     the tensor cores, and the exp2 units, at the same time; on an H100
//     that measured 3-9 % slower at T = 812 on an all-valid mask.
//   * A key tile with no valid key is neither loaded nor multiplied: each
//     warp ballots the tile's key_valid bytes into a bitmap of live tiles
//     before the first load, so loads and products walk the same list.
//
// Shared memory a block: (ns + kStages) * 8192 bytes, Q first. The two
// instances (q.k width 64, and 128..576) and their ring depths are the
// constants below; kernels/masked_attention.py:plan mirrors them for the tests.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace cbx {
namespace {

constexpr int kTcTile = 64;           // query rows a block, keys a tile, slice width, value width
constexpr int kTcStageBytes = 8192;   // one ring stage: a 64 x 64 bf16 tile
constexpr int kTcMaxDa = 576;         // widest q.k the resident Q leaves room for
constexpr int kTcSmemLimit = 232448;  // dynamic shared memory a block may have
constexpr int kTcThreads = 128;       // one warpgroup
// ring depth (stages) and blocks an SM by instance: q.k width 64 ("narrow")
// or 128..576 ("wide")
constexpr int kTcStagesNarrow = 6;
constexpr int kTcStagesWide = 5;
constexpr int kTcBlocksNarrow = 4;
constexpr int kTcBlocksWide = 2;
constexpr float kTcLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t tc_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `live` false writes 16 zero bytes and reads nothing
__device__ __forceinline__ void tc_cp_async16(uint32_t dst, const void* src, bool live) {
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void tc_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void tc_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// shared-memory writes of this thread become visible to the tensor cores' reads
__device__ __forceinline__ void tc_fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tc_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void tc_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void tc_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving uses of an accumulator across this point
__device__ __forceinline__ void tc_pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ float tc_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));    // ex2(-inf) = +0
  return y;
}
__device__ __forceinline__ uint32_t tc_pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);     // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 4 bytes global -> shared (through L1); `live` false writes 4 zero bytes
__device__ __forceinline__ void tc_cp_async4(uint32_t dst, const void* src, bool live) {
  const int n = live ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

// Bitmap of the live 64-key tiles among tiles [base, base + 64): bit u is
// set when tile base + u holds a valid key of key_valid row `mb`. Every warp
// ballots the same bytes, so all threads of a block get the same map without
// a barrier.
__device__ __forceinline__ uint64_t tc_live_tiles(const unsigned char* __restrict__ mb, int seq,
                                                  int base, int n_tiles, int lane) {
  uint64_t live = 0;
  const int nt = min(64, n_tiles - base);
  for (int j0 = 0; j0 < nt; j0 += 8) {       // 8 tiles' loads in flight together
    unsigned any[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int key = (base + j0 + u) * kTcTile + 2 * lane;
      any[u] = (key < seq ? __ldg(mb + key) : 0) | (key + 1 < seq ? __ldg(mb + key + 1) : 0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (__any_sync(0xffffffffu, any[u] != 0)) live |= uint64_t{1} << (j0 + u);
  }
  return live;
}

// The valid keys of tile [k0, k0 + 64) as a 64-bit map (bit j: key k0 + j;
// keys past T are not valid). Every lane of the warp gets the map.
__device__ __forceinline__ uint64_t tc_tile_keys(const unsigned char* __restrict__ mb, int seq,
                                                 int k0, int lane) {
  const int a = k0 + lane, b = a + 32;
  const unsigned lo = __ballot_sync(0xffffffffu, a < seq && __ldg(mb + a) != 0);
  const unsigned hi = __ballot_sync(0xffffffffu, b < seq && __ldg(mb + b) != 0);
  return (uint64_t{hi} << 32) | lo;
}

// wgmma descriptor of a shared-memory tile whose rows are 128 bytes under the
// 128-byte swizzle: start address / 16, 8-row groups 1024 bytes apart (the
// leading offset is not used by this layout; it is set to 16 bytes).
__device__ __forceinline__ uint64_t tc_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{64} << 32) | (uint64_t{1} << 62);
}

#define CBX_TC_D32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),    \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),             \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),             \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),             \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define CBX_TC_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (64 x 64 fp32, 32 registers a thread) = or += A . B^T with A (64 rows x
// 16) and B (64 rows x 16) both in shared memory, the 16 contiguous (K-major)
__device__ __forceinline__ void tc_wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CBX_TC_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CBX_TC_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A . B with A (64 x 16) in registers (4 bf16x2 a thread) and B (16 rows
// x 64, the 64 contiguous) in shared memory: the transposed-B form
__device__ __forceinline__ void tc_wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CBX_TC_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CBX_TC_D32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// One warpgroup, 64 query rows; kStages ring stages; kMinBlocks blocks an SM
// (the register cap follows from it).
template <int kStages, int kMinBlocks>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks)
masked_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const unsigned char* __restrict__ key_valid,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                           int seq, int heads, int da, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  constexpr int kAhead = kStages - 2;        // stages in flight ahead of the products
  constexpr int kRowStep = kTcThreads / 8;   // rows between a thread's copies
  constexpr int kCopies = kTcTile / kRowStep;   // 16-byte copies a thread a stage
  static_assert(kAhead >= 1, "the ring needs three stages");

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int ns = da >> 6;                    // 64-wide slices of the q.k width
  const int q0 = blockIdx.x * kTcTile;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;

  const uint32_t smem = tc_smem_u32(tc_smem);
  if ((smem & 1023u) != 0) __trap();         // the swizzle needs 1024-byte tiles
  const uint32_t q_smem = smem;              // [ns] tiles of 64 rows x 64
  const uint32_t ring = smem + ns * kTcStageBytes;   // [kStages] tiles

  const size_t qk_stride = (size_t)heads * da;
  const size_t v_stride = (size_t)heads * kTcTile;
  const __nv_bfloat16* qb = q + ((size_t)b * seq * heads + h) * da;
  const __nv_bfloat16* kb = k + ((size_t)b * seq * heads + h) * da;
  const __nv_bfloat16* vb = v + ((size_t)b * seq * heads + h) * kTcTile;
  const unsigned char* mb = key_valid + (size_t)b * seq;

  // a thread copies chunk `lc` (16 bytes) of rows lr, lr + kRowStep, ...; the
  // swizzle puts chunk c of row r at chunk position c ^ (r % 8), and r % 8 is
  // the same for all of a thread's rows (kRowStep is a multiple of 8)
  const int lc = tid & 7;
  const int lr = tid >> 3;
  const uint32_t ldst = lr * 128 + ((lc ^ (lr & 7)) << 4);

  for (int p = 0; p < ns; ++p) {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int t = q0 + lr + i * kRowStep;
      const __nv_bfloat16* src = qb + (size_t)min(t, seq - 1) * qk_stride + p * 64 + lc * 8;
      tc_cp_async16(q_smem + p * kTcStageBytes + ldst + i * kRowStep * 128, src, t < seq);
    }
  }
  tc_cp_async_commit();

  // online softmax state of this thread's two rows (warp * 16 + lane / 4 and
  // that + 8 of the block's 64), in the exp2 domain; l is a per-lane
  // partial over this lane's 16 columns of every tile
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (seq + kTcTile - 1) / kTcTile;
  for (int base = 0; base < n_tiles; base += 64) {
    // bitmap of the live key tiles among the next 64: every warp ballots the
    // same bytes, so all threads of the block walk the same list
    const uint64_t live = tc_live_tiles(mb, seq, base, n_tiles, lane);
    if (live == 0) continue;

    // the loads' cursor: tile (lowest bit of ld_rem), slice ld_s (ns = the V
    // tile), ring stage ld_stage. One commit a call, with or without a load,
    // so that the count of pending groups tells which stage has landed.
    uint64_t ld_rem = live;
    int ld_s = 0, ld_stage = 0;
    auto load_next = [&]() {
      if (ld_rem != 0) {
        const int k0 = (base + __ffsll((long long)ld_rem) - 1) * kTcTile;
        const bool is_v = ld_s == ns;
        const __nv_bfloat16* src = is_v ? vb + lc * 8 : kb + ld_s * 64 + lc * 8;
        const size_t stride = is_v ? v_stride : qk_stride;
        const uint32_t dst = ring + ld_stage * kTcStageBytes + ldst;
#pragma unroll
        for (int i = 0; i < kCopies; ++i) {
          const int key = k0 + lr + i * kRowStep;
          tc_cp_async16(dst + i * kRowStep * 128,
                        src + (size_t)min(key, seq - 1) * stride, key < seq);
        }
        if (++ld_s > ns) {
          ld_s = 0;
          ld_rem &= ld_rem - 1;
        }
        if (++ld_stage == kStages) ld_stage = 0;
      }
      tc_cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kAhead; ++i) load_next();

    int stage = 0;
    uint64_t rem = live;
    while (rem != 0) {
      const int tile = base + __ffsll((long long)rem) - 1;
      rem &= rem - 1;
      // this tile's key mask: lane l holds keys 2 l and 2 l + 1
      const int mkey = tile * kTcTile + 2 * lane;
      const unsigned v0 = mkey < seq ? __ldg(mb + mkey) : 0;
      const unsigned v1 = mkey + 1 < seq ? __ldg(mb + mkey + 1) : 0;

      // s = q . k^T over the ns slices of this key tile
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      tc_pin(s);
      for (int sl = 0; sl < ns; ++sl) {
        // stage `stage` has landed in every thread's copies once all have
        // waited and met; its last reader (two items back) has finished
        tc_cp_async_wait<kAhead - 1>();
        tc_fence_async_proxy();
        __syncthreads();
        const uint32_t a_base = q_smem + sl * kTcStageBytes;
        const uint32_t b_base = ring + stage * kTcStageBytes;
        tc_wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          tc_wgmma_ss(s, tc_desc(a_base + kk * 32), tc_desc(b_base + kk * 32),
                      (sl | kk) != 0);
        tc_wgmma_commit();
        tc_wgmma_wait<1>();                  // the slice before has been read
        load_next();
        if (++stage == kStages) stage = 0;
      }
      tc_wgmma_wait<0>();                    // s is whole; the last p.v is done too
      tc_pin(s);
      tc_pin(o);

      // fold the tile into (m, l, o). Columns of this lane: 8 j + 2 quad + e
      // (e = 0, 1) in s[4 j + e] (row) and s[4 j + 2 + e] (row + 8). The max
      // is taken over the raw scores (scale > 0) and the scale goes into the
      // exponent's multiply-add.
      const unsigned lo = __ballot_sync(0xffffffffu, v0 != 0);
      const unsigned hi = __ballot_sync(0xffffffffu, v1 != 0);
      if ((lo & hi) != 0xffffffffu) {
        const unsigned los = lo >> quad, his = hi >> quad;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool e0 = (los >> (4 * j)) & 1u, e1 = (his >> (4 * j)) & 1u;
          if (!e0) s[4 * j + 0] = s[4 * j + 2] = -INFINITY;
          if (!e1) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      // a live tile has a valid key, so mn is finite unless a score is not;
      // then 0 is subtracted (-inf - -inf would be NaN) and p = exp2(-inf) = 0,
      // and the factor exp2(-inf) = 0 meets a state that is still 0
      const float sub0 = mn0 == -INFINITY ? 0.f : mn0;
      const float sub1 = mn1 == -INFINITY ? 0.f : mn1;
      const float f0 = tc_exp2(m0 - sub0), f1 = tc_exp2(m1 - sub1);
      m0 = mn0;
      m1 = mn1;
      uint32_t p[16];
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = tc_exp2(fmaf(s[4 * j + 0], scale_log2, -sub0));
        const float p1 = tc_exp2(fmaf(s[4 * j + 1], scale_log2, -sub0));
        const float p2 = tc_exp2(fmaf(s[4 * j + 2], scale_log2, -sub1));
        const float p3 = tc_exp2(fmaf(s[4 * j + 3], scale_log2, -sub1));
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        p[2 * j + 0] = tc_pack(p0, p1);
        p[2 * j + 1] = tc_pack(p2, p3);
        o[4 * j + 0] *= f0;
        o[4 * j + 1] *= f0;
        o[4 * j + 2] *= f1;
        o[4 * j + 3] *= f1;
      }
      l0 = l0 * f0 + rs0;
      l1 = l1 * f1 + rs1;

      // o += p . v: keys 16 kk .. 16 kk + 15 of p are the accumulator's column
      // blocks 2 kk and 2 kk + 1, which is the A fragment's register order
      tc_cp_async_wait<kAhead - 1>();
      tc_fence_async_proxy();
      __syncthreads();
      const uint32_t v_base = ring + stage * kTcStageBytes;
      tc_pin(o);
      tc_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc_wgmma_rs(o, p[4 * kk + 0], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                    tc_desc(v_base + kk * 16 * 128));
      tc_wgmma_commit();
      tc_wgmma_wait<1>();
      load_next();
      if (++stage == kStages) stage = 0;
    }
    tc_wgmma_wait<0>();
    tc_pin(o);
    __syncthreads();                         // the ring is free for the next 64 tiles
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;     // no valid key: 0
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int t0 = q0 + warp * 16 + (lane >> 2);
  const int t1 = t0 + 8;
  if (lse != nullptr && quad == 0) {
    // natural-log units from the exp2 domain; +inf for a row without a
    // valid key, so that exp(s - lse) is exactly 0 for every finite s
    float* lb = lse + (size_t)blockIdx.y * seq;
    if (t0 < seq) lb[t0] = l0 > 0.f ? (m0 + log2f(l0)) * kTcLn2 : INFINITY;
    if (t1 < seq) lb[t1] = l1 > 0.f ? (m1 + log2f(l1)) * kTcLn2 : INFINITY;
  }
  __nv_bfloat16* ob = out + (size_t)b * seq * v_stride + (size_t)h * kTcTile + 2 * quad;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (t0 < seq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)t0 * v_stride + 8 * j) =
          tc_pack(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
    if (t1 < seq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)t1 * v_stride + 8 * j) =
          tc_pack(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

#undef CBX_TC_D32
#undef CBX_TC_REGS32

// Launch on `stream`; no allocation, no synchronisation. `max_ns` is the
// widest q.k (in slices) this instance is launched with: its shared-memory
// limit is raised once to that.
template <int kStages, int kMinBlocks>
int launch_masked_attention_tc(const void* q, const void* k, const void* v,
                               const void* key_valid, void* out, float* lse, int batch,
                               int seq, int heads, int da, float scale, int max_ns,
                               cudaStream_t stream) {
  static_assert((kTcMaxDa / kTcTile + kStages) * kTcStageBytes <= kTcSmemLimit,
                "the resident Q and the ring must fit a block's shared memory");
  auto kernel = masked_attention_tc_kernel<kStages, kMinBlocks>;
  static bool prepared = false;
  if (!prepared) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (max_ns + kStages) * kTcStageBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    prepared = true;
  }
  const size_t smem = (size_t)(da / kTcTile + kStages) * kTcStageBytes;
  const dim3 grid((seq + kTcTile - 1) / kTcTile, batch * heads);
  const float scale_log2 = scale * 1.4426950408889634f;
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const unsigned char*>(key_valid),
      static_cast<__nv_bfloat16*>(out), lse, seq, heads, da, scale_log2);
  return (int)cudaGetLastError();
}

// bf16 inputs. kNarrowOnly leaves the wide instance out of a library whose
// entry only ever passes a q.k width of 64.
template <bool kNarrowOnly>
int dispatch_masked_attention_tc(const void* q, const void* k, const void* v,
                                 const void* key_valid, void* out, float* lse, int batch,
                                 int seq, int heads, int da, float scale,
                                 cudaStream_t stream) {
  if (da < kTcTile || da % kTcTile != 0 || da > kTcMaxDa || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  if (da == kTcTile)
    return launch_masked_attention_tc<kTcStagesNarrow, kTcBlocksNarrow>(
        q, k, v, key_valid, out, lse, batch, seq, heads, da, scale, 1, stream);
  if constexpr (kNarrowOnly) {
    return (int)cudaErrorInvalidValue;
  } else {
    return launch_masked_attention_tc<kTcStagesWide, kTcBlocksWide>(
        q, k, v, key_valid, out, lse, batch, seq, heads, da, scale, kTcMaxDa / kTcTile,
        stream);
  }
}

}  // namespace
}  // namespace cbx
