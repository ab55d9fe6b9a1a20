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
//            keys j of row b (0 at the others)
//   di_i   = dO_i . O_i              (O is K3's output, as the forward wrote it)
//   dS_ij  = P_ij (dO_i . v_j - di_i)
//   dq_i   = scale * sum_j dS_ij k_j
//   dk_j   = scale * sum_i dS_ij q_i,   dv_j = sum_i P_ij dO_i
// lse_i is the row's log-sum-exp that K3's forward saved (the stock op saves
// its l and m the same way, flash_attention.py:246-251); it is +inf for a row
// with no valid key, so P is exactly 0 there and the row gets zero
// gradients. Every query row attends the valid keys, invalid query rows too
// (K3's forward, layers.mha's key-mask semantics).
//
//   q, k, v, out, dout, dq, dk, dv   (B, T, H, 64) contiguous, float or bf16
//   key_valid                        (B, T) bool (one byte)
//   lse                              (B, H, T) fp32, from K3 (read)
//   di                               (B, H, T) fp32 scratch, written by dq
//
// Two kernels, launched in this order on one stream (the TPU op computes di
// outside its kernels and runs dkv first; here dq writes di, so it runs first):
//   K3b-dq   one block a (64 query rows, row, head): di from dO and O, then
//            a walk over the live key tiles only: S = Q.K^T, dP = dO.V^T, dS,
//            dQ += dS.K. Three products a (query, key) pair.
//   K3b-dkv  one block a (64 keys, row, head); K and V stay resident and the
//            block walks every query tile: S^T = K.Q^T, dP^T = V.dO^T, P^T and
//            dS^T with lse and di by column, dV += P^T.dO, dK += dS^T.Q. Four
//            products a pair. A key tile with no valid key writes zeros.
//
// What bounds it on an H100: operations (7 B H T^2 64 multiply-adds against a
// few MB of operands). bf16 runs on the tensor cores (989 TFLOP/s), fp32 on
// the CUDA cores (67 TFLOP/s; TF32 stays off in the port).
//
// bf16 design, from the forward's primitives (masked_attention_tc.cuh): one
// warpgroup a block; every product is wgmma m64n64k16 with fp32 sums. The
// block's resident pair (Q, dO for dq; K, V for dkv) and the streamed pair
// (K, V; Q, dO) are 64 x 64 bf16 tiles in shared memory under the 128-byte
// swizzle, filled by 16-byte cp.async with zero-fill past T. A streamed tile
// serves twice: K-major as the B of S (or S^T), and with the transpose bit as
// the B of dQ += dS.K (or dK += dS^T.Q, dV += P^T.dO), the way the forward
// reads V. P and dS stay in registers: the fp32 accumulator fragment, packed
// pairwise to bf16x2, is the A fragment of the next product. The ring holds
// kBwdSlots tile pairs, kBwdAhead of them in flight; the pair read two tiles
// back is the one overwritten, so one block barrier a tile serves both the
// arrival and the reuse. Rows past T read zeros and are written nowhere; in
// dkv their lse counts as +inf, so a zero-filled row adds nothing.
//
// fp32 design: 128 threads a block, each a 4 x 8 register tile of a 64 x 64
// product (rows ty + 16 i, columns tx + 8 j for S-like products; columns
// 4 tx + (j & 3) + 32 (j >> 2) for the products over keys or queries).
// Tiles sit in shared memory as they are stored (rows of 64 floats, pitch 68
// floats), filled by 16-byte cp.async; both kinds of product read only
// float4s: 12 for 128 multiply-adds a thread (3/8 of a word a multiply-add,
// against 1/2 for 4 x 4 tiles of scalar loads). Three barriers a tile: the
// staged tiles rewritten, landed, and the dS (P) tile written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "masked_attention_tc.cuh"

// Internal linkage: each .cu builds its own library (see masked_attention.cuh).
namespace cbx {
namespace {

constexpr int kBwdThreads = 128;      // one warpgroup (bf16); 16 x 8 threads (fp32)
constexpr int kBwdSlots = 4;          // bf16 ring depth: streamed tile pairs
constexpr int kBwdAhead = 2;          // bf16 tile pairs in flight ahead of the products
constexpr int kBwdSlotBytes = 16384;  // a pair of 64 x 64 bf16 tiles
constexpr int kBwdStatBytes = 512;    // lse and di of a query tile (dkv)
constexpr int kBwdBlocks = 2;         // blocks an SM, every K3b kernel (launch bounds)
constexpr int kBwdSmemDqTc = 81920;   // resident Q, dO + the ring
constexpr int kBwdSmemDkvTc = 83968;  // resident K, V + the ring + lse, di a slot
constexpr int kBwdPitch = 68;         // fp32 tile row pitch, floats
constexpr int kBwdSmemDqF32 = 87040;  // q, dO, k, v, dS tiles
constexpr int kBwdSmemDkvF32 = 104960;   // k, v, q, dO, P^T, dS^T tiles + lse, di
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kF32Tile = kTcTile * kBwdPitch;   // floats a staged fp32 tile
static_assert(kBwdSlots == kBwdAhead + 2, "a slot is rewritten two tiles after its read");
static_assert(kBwdSlotBytes == 2 * kTcStageBytes, "a slot is two tiles");
static_assert(kBwdSmemDqTc == 2 * kTcStageBytes + kBwdSlots * kBwdSlotBytes, "dq smem");
static_assert(kBwdSmemDkvTc == 2 * kTcStageBytes + kBwdSlots * (kBwdSlotBytes + kBwdStatBytes),
              "dkv smem");
static_assert(kBwdSmemDqF32 == 5 * kF32Tile * 4, "fp32 dq smem");
static_assert(kBwdSmemDkvF32 == 6 * kF32Tile * 4 + 2 * kTcTile * 4, "fp32 dkv smem");
static_assert(kBwdBlocks * (kBwdSmemDkvF32 + 1024) <= 228 * 1024, "two blocks an SM");

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// 64 rows [r0, r0 + 64) of one (row, head) of a (B, T, H, 64) bf16 tensor into
// a swizzled 8 KB tile at `dst`, rows past T zero-filled; `base` points at
// (b, 0, h, 0). Every thread of the warpgroup copies 4 chunks of 16 bytes.
__device__ __forceinline__ void tc_stage_tile(uint32_t dst, const __nv_bfloat16* base, int r0,
                                              int seq, size_t stride) {
  const int lc = threadIdx.x & 7;
  const int lr = threadIdx.x >> 3;
  const uint32_t ldst = lr * 128 + ((lc ^ (lr & 7)) << 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + lr + 16 * i;
    tc_cp_async16(dst + ldst + i * 16 * 128, base + (size_t)min(t, seq - 1) * stride + lc * 8,
                  t < seq);
  }
}

__device__ __forceinline__ float2 bf2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// A thread's two accumulator rows of a 64 x 64 fp32 tile, scaled, as bf16
// pairs into rows t0, t0 + 8 of a (B, T, H, 64) tensor (`base` at (b, 0, h,
// 2 quad)); rows past T are not written.
__device__ __forceinline__ void tc_store_rows(__nv_bfloat16* base, const float (&d)[32], float f,
                                              int t0, int seq, size_t stride) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (t0 < seq)
      *reinterpret_cast<uint32_t*>(base + (size_t)t0 * stride + 8 * j) =
          tc_pack(d[4 * j + 0] * f, d[4 * j + 1] * f);
    if (t0 + 8 < seq)
      *reinterpret_cast<uint32_t*>(base + (size_t)(t0 + 8) * stride + 8 * j) =
          tc_pack(d[4 * j + 2] * f, d[4 * j + 3] * f);
  }
}

__global__ void __launch_bounds__(kTcThreads, kBwdBlocks)
attention_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const unsigned char* __restrict__ key_valid,
                           const __nv_bfloat16* __restrict__ out,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse_in, float* __restrict__ di_out,
                           __nv_bfloat16* __restrict__ dq, int seq, int heads, float scale,
                           float scale_log2) {
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int q0 = blockIdx.x * kTcTile;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;

  const uint32_t smem = tc_smem_u32(bwd_smem);
  if ((smem & 1023u) != 0) __trap();         // the swizzle needs 1024-byte tiles
  const uint32_t q_smem = smem;
  const uint32_t do_smem = smem + kTcStageBytes;
  const uint32_t ring = smem + 2 * kTcStageBytes;   // [kBwdSlots] (K, V)

  const size_t stride = (size_t)heads * kTcTile;
  const size_t off = ((size_t)b * seq * heads + h) * kTcTile;
  const unsigned char* mb = key_valid + (size_t)b * seq;
  tc_stage_tile(q_smem, q + off, q0, seq, stride);
  tc_stage_tile(do_smem, dout + off, q0, seq, stride);
  tc_cp_async_commit();

  // this thread's rows t0 = q0 + warp * 16 + lane / 4 and t0 + 8: lse in the
  // exp2 domain (+inf past T: P = 0) and di = dO . O, the four lanes of a quad
  // 16 columns each
  const int t0 = q0 + warp * 16 + (lane >> 2);
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + 8 * r;
    float part = 0.f;
    lse2[r] = INFINITY;
    if (t < seq) {
      lse2[r] = lse_in[(size_t)blockIdx.y * seq + t] * kLog2e;
      const uint4* o4 = reinterpret_cast<const uint4*>(out + off + (size_t)t * stride + 16 * quad);
      const uint4* g4 = reinterpret_cast<const uint4*>(dout + off + (size_t)t * stride + 16 * quad);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint4 o = __ldg(o4 + c), g = __ldg(g4 + c);
        const uint32_t ow[4] = {o.x, o.y, o.z, o.w}, gw[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 a = bf2(ow[w]), e = bf2(gw[w]);
          part = fmaf(a.x, e.x, fmaf(a.y, e.y, part));
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    di[r] = part;
    if (quad == 0 && t < seq) di_out[(size_t)blockIdx.y * seq + t] = part;
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const int n_tiles = (seq + kTcTile - 1) / kTcTile;
  for (int base = 0; base < n_tiles; base += 64) {
    const uint64_t live = tc_live_tiles(mb, seq, base, n_tiles, lane);
    if (live == 0) continue;
    // the loads' cursor: one commit a call, with or without a load, so that
    // the count of pending groups tells which slot has landed
    uint64_t ld_rem = live;
    int ld_slot = 0;
    auto load_next = [&]() {
      if (ld_rem != 0) {
        const int k0 = (base + __ffsll((long long)ld_rem) - 1) * kTcTile;
        const uint32_t dst = ring + ld_slot * kBwdSlotBytes;
        tc_stage_tile(dst, k + off, k0, seq, stride);
        tc_stage_tile(dst + kTcStageBytes, v + off, k0, seq, stride);
        ld_rem &= ld_rem - 1;
        if (++ld_slot == kBwdSlots) ld_slot = 0;
      }
      tc_cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kBwdAhead; ++i) load_next();

    int slot = 0;
    uint64_t rem = live;
    while (rem != 0) {
      const int tile = base + __ffsll((long long)rem) - 1;
      rem &= rem - 1;
      const uint64_t keys = tc_tile_keys(mb, seq, tile * kTcTile, lane);
      // this slot has landed in every thread's copies once all have waited
      // and met; every thread has waited for the products of two tiles back
      tc_cp_async_wait<kBwdAhead - 1>();
      tc_fence_async_proxy();
      __syncthreads();
      const uint32_t k_t = ring + slot * kBwdSlotBytes;
      const uint32_t v_t = k_t + kTcStageBytes;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      tc_pin(s);
      tc_pin(dp);
      tc_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc_wgmma_ss(s, tc_desc(q_smem + kk * 32), tc_desc(k_t + kk * 32), kk != 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc_wgmma_ss(dp, tc_desc(do_smem + kk * 32), tc_desc(v_t + kk * 32), kk != 0);
      tc_wgmma_commit();
      load_next();                           // into the slot of two tiles back
      tc_wgmma_wait<0>();                    // s, dp whole; the last dQ product done
      tc_pin(s);
      tc_pin(dp);
      tc_pin(acc);

      // P and dS. Columns (keys) of this lane: 8 j + 2 quad + e in s[4 j + e]
      // (row t0) and s[4 j + 2 + e] (row t0 + 8)
      uint32_t ds[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (keys >> (8 * j + 2 * quad + e)) & 1u;
          const float p0 = ok ? tc_exp2(fmaf(s[4 * j + e], scale_log2, -lse2[0])) : 0.f;
          const float p1 = ok ? tc_exp2(fmaf(s[4 * j + 2 + e], scale_log2, -lse2[1])) : 0.f;
          x[e] = p0 * (dp[4 * j + e] - di[0]);
          x[2 + e] = p1 * (dp[4 * j + 2 + e] - di[1]);
        }
        ds[2 * j + 0] = tc_pack(x[0], x[1]);
        ds[2 * j + 1] = tc_pack(x[2], x[3]);
      }

      // dQ += dS . K: keys 16 kk .. 16 kk + 15 of dS are the accumulator's
      // column blocks 2 kk and 2 kk + 1 (the A fragment's register order); K
      // (keys x 64, the 64 contiguous) is the transposed-B form
      tc_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc_wgmma_rs(acc, ds[4 * kk + 0], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3],
                    tc_desc(k_t + kk * 16 * 128));
      tc_wgmma_commit();
      if (++slot == kBwdSlots) slot = 0;
    }
    tc_wgmma_wait<0>();
    tc_pin(acc);
    __syncthreads();                         // the ring is free for the next 64 tiles
  }
  tc_cp_async_wait<0>();
  tc_store_rows(dq + off + 2 * quad, acc, scale, t0, seq, stride);
}

__global__ void __launch_bounds__(kTcThreads, kBwdBlocks)
attention_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const unsigned char* __restrict__ key_valid,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse_in, const float* __restrict__ di_in,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int seq, int heads, float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int k0 = blockIdx.x * kTcTile;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const size_t stride = (size_t)heads * kTcTile;
  const size_t off = ((size_t)b * seq * heads + h) * kTcTile;
  const unsigned char* mb = key_valid + (size_t)b * seq;
  const int t0 = k0 + warp * 16 + (lane >> 2);   // this thread's key rows t0, t0 + 8

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  const uint64_t keys = tc_tile_keys(mb, seq, k0, lane);
  if (keys == 0) {                           // no valid key: zero gradients
    tc_store_rows(dk + off + 2 * quad, dka, 0.f, t0, seq, stride);
    tc_store_rows(dv + off + 2 * quad, dva, 0.f, t0, seq, stride);
    return;
  }
  const bool kv0 = (keys >> (t0 - k0)) & 1u;
  const bool kv1 = (keys >> (t0 - k0 + 8)) & 1u;

  const uint32_t smem = tc_smem_u32(bwd_smem);
  if ((smem & 1023u) != 0) __trap();
  const uint32_t k_smem = smem;
  const uint32_t v_smem = smem + kTcStageBytes;
  const uint32_t ring = smem + 2 * kTcStageBytes;     // [kBwdSlots] (Q, dO)
  const uint32_t stat = ring + kBwdSlots * kBwdSlotBytes;   // [kBwdSlots] (lse[64], di[64])
  const float* stat_f = reinterpret_cast<const float*>(bwd_smem + 2 * kTcStageBytes +
                                                       kBwdSlots * kBwdSlotBytes);
  tc_stage_tile(k_smem, k + off, k0, seq, stride);
  tc_stage_tile(v_smem, v + off, k0, seq, stride);
  tc_cp_async_commit();

  const float* lse_b = lse_in + (size_t)blockIdx.y * seq;
  const float* di_b = di_in + (size_t)blockIdx.y * seq;
  const int n_tiles = (seq + kTcTile - 1) / kTcTile;
  int ld_tile = 0, ld_slot = 0;
  auto load_next = [&]() {
    if (ld_tile < n_tiles) {
      const int r0 = ld_tile * kTcTile;
      const uint32_t dst = ring + ld_slot * kBwdSlotBytes;
      tc_stage_tile(dst, q + off, r0, seq, stride);
      tc_stage_tile(dst + kTcStageBytes, dout + off, r0, seq, stride);
      // lse (threads 0-63) and di (64-127) of the tile's rows; 0 past T
      const int r = tid & 63;
      const int t = r0 + r;
      const float* src = tid < 64 ? lse_b : di_b;
      tc_cp_async4(stat + ld_slot * kBwdStatBytes + (tid >> 6) * 256 + r * 4,
                   src + min(t, seq - 1), t < seq);
      ++ld_tile;
      if (++ld_slot == kBwdSlots) ld_slot = 0;
    }
    tc_cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kBwdAhead; ++i) load_next();

  int slot = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    tc_cp_async_wait<kBwdAhead - 1>();
    tc_fence_async_proxy();
    __syncthreads();
    const uint32_t q_t = ring + slot * kBwdSlotBytes;
    const uint32_t do_t = q_t + kTcStageBytes;
    const float* lse_s = stat_f + slot * (kBwdStatBytes / 4);
    const float* di_s = lse_s + kTcTile;
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    tc_pin(st);
    tc_pin(dpt);
    tc_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc_wgmma_ss(st, tc_desc(k_smem + kk * 32), tc_desc(q_t + kk * 32), kk != 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc_wgmma_ss(dpt, tc_desc(v_smem + kk * 32), tc_desc(do_t + kk * 32), kk != 0);
    tc_wgmma_commit();
    load_next();                             // into the slot of two tiles back
    tc_wgmma_wait<0>();                      // st, dpt whole; the last dK, dV products done
    tc_pin(st);
    tc_pin(dpt);
    tc_pin(dka);
    tc_pin(dva);

    // P^T and dS^T: rows are this thread's keys t0, t0 + 8; columns (queries)
    // 8 j + 2 quad + e, with lse and di by column. Columns past T count as
    // lse = +inf: P = 0.
    const int lim = seq - tile * kTcTile;
    uint32_t pp[16], dd[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 g = *reinterpret_cast<const float2*>(di_s + c);
      const float l2[2] = {l.x * kLog2e, l.y * kLog2e}, gi[2] = {g.x, g.y};
      float pa[2], pb[2], da[2], db[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool col = c + e < lim;
        pa[e] = kv0 && col ? tc_exp2(fmaf(st[4 * j + e], scale_log2, -l2[e])) : 0.f;
        pb[e] = kv1 && col ? tc_exp2(fmaf(st[4 * j + 2 + e], scale_log2, -l2[e])) : 0.f;
        da[e] = pa[e] * (dpt[4 * j + e] - gi[e]);
        db[e] = pb[e] * (dpt[4 * j + 2 + e] - gi[e]);
      }
      pp[2 * j + 0] = tc_pack(pa[0], pa[1]);
      pp[2 * j + 1] = tc_pack(pb[0], pb[1]);
      dd[2 * j + 0] = tc_pack(da[0], da[1]);
      dd[2 * j + 1] = tc_pack(db[0], db[1]);
    }

    // dV += P^T . dO and dK += dS^T . Q: the query tile's dO and Q (queries x
    // 64) are the transposed-B operands
    tc_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc_wgmma_rs(dva, pp[4 * kk + 0], pp[4 * kk + 1], pp[4 * kk + 2], pp[4 * kk + 3],
                  tc_desc(do_t + kk * 16 * 128));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc_wgmma_rs(dka, dd[4 * kk + 0], dd[4 * kk + 1], dd[4 * kk + 2], dd[4 * kk + 3],
                  tc_desc(q_t + kk * 16 * 128));
    tc_wgmma_commit();
    if (++slot == kBwdSlots) slot = 0;
  }
  tc_wgmma_wait<0>();
  tc_pin(dka);
  tc_pin(dva);
  tc_cp_async_wait<0>();
  tc_store_rows(dk + off + 2 * quad, dka, scale, t0, seq, stride);
  tc_store_rows(dv + off + 2 * quad, dva, 1.f, t0, seq, stride);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

// 64 rows [r0, r0 + 64) of one (row, head) of a (B, T, H, 64) fp32 tensor into
// a [64][kBwdPitch] tile, rows past T zero-filled: 16-byte cp.async, 8 a thread.
__device__ __forceinline__ void f32_stage_tile(float* dst, const float* base, int r0, int seq,
                                               size_t stride) {
  const uint32_t d = tc_smem_u32(dst);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = threadIdx.x + kBwdThreads * i;
    const int r = e >> 4, c4 = e & 15;
    const int t = r0 + r;
    tc_cp_async16(d + (r * kBwdPitch + 4 * c4) * 4,
                  base + (size_t)min(t, seq - 1) * stride + 4 * c4, t < seq);
  }
}

// acc[i][j] += a[ty + 16 i] . b[tx + 8 j] over the 64 columns: products of
// rows of two staged tiles (S = Q.K^T, dP = dO.V^T and their transposes)
__device__ __forceinline__ void f32_rows_dot(float (&acc)[4][8], const float* a, const float* b,
                                             int ty, int tx) {
#pragma unroll 2
  for (int d = 0; d < kTcTile; d += 4) {
    float4 av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kBwdPitch + d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 8 * j) * kBwdPitch + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][j] += sum_r p[ty + 16 i][r] m[r][4 tx + (j & 3) + 32 (j >> 2)]: a
// 64 x 64 weight tile (dS, P^T, dS^T) times a staged tile
__device__ __forceinline__ void f32_tile_mm(float (&acc)[4][8], const float* p, const float* m,
                                            int ty, int tx) {
#pragma unroll 2
  for (int r = 0; r < kTcTile; r += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kBwdPitch + r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 m0 = *reinterpret_cast<const float4*>(m + (r + u) * kBwdPitch + 4 * tx);
      const float4 m1 = *reinterpret_cast<const float4*>(m + (r + u) * kBwdPitch + 32 + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
        acc[i][0] = fmaf(w, m0.x, acc[i][0]);
        acc[i][1] = fmaf(w, m0.y, acc[i][1]);
        acc[i][2] = fmaf(w, m0.z, acc[i][2]);
        acc[i][3] = fmaf(w, m0.w, acc[i][3]);
        acc[i][4] = fmaf(w, m1.x, acc[i][4]);
        acc[i][5] = fmaf(w, m1.y, acc[i][5]);
        acc[i][6] = fmaf(w, m1.z, acc[i][6]);
        acc[i][7] = fmaf(w, m1.w, acc[i][7]);
      }
    }
  }
}

// rows r0 + ty + 16 i of a (B, T, H, 64) fp32 tensor (`base` at (b, 0, h, 0))
// from a tile_mm accumulator, times f; rows past T are not written
__device__ __forceinline__ void f32_store_rows(float* base, const float (&acc)[4][8], float f,
                                               int r0, int ty, int tx, int seq, size_t stride) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + ty + 16 * i;
    if (t >= seq) continue;
    float* o = base + (size_t)t * stride + 4 * tx;
    *reinterpret_cast<float4*>(o) =
        make_float4(acc[i][0] * f, acc[i][1] * f, acc[i][2] * f, acc[i][3] * f);
    *reinterpret_cast<float4*>(o + 32) =
        make_float4(acc[i][4] * f, acc[i][5] * f, acc[i][6] * f, acc[i][7] * f);
  }
}

__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v,
                            const unsigned char* __restrict__ key_valid,
                            const float* __restrict__ out, const float* __restrict__ dout,
                            const float* __restrict__ lse_in, float* __restrict__ di_out,
                            float* __restrict__ dq, int seq, int heads, float scale) {
  extern __shared__ __align__(16) float f32_smem[];
  float* qs = f32_smem;                // [64][kBwdPitch] this block's queries
  float* dos = qs + kF32Tile;          // their dO
  float* ks = dos + kF32Tile;          // a key tile
  float* vs = ks + kF32Tile;           // its values
  float* dss = vs + kF32Tile;          // dS of the tile (queries x keys)

  const int q0 = blockIdx.x * kTcTile;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int lane = threadIdx.x & 31;
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const size_t stride = (size_t)heads * kTcTile;
  const size_t off = ((size_t)b * seq * heads + h) * kTcTile;
  const unsigned char* mb = key_valid + (size_t)b * seq;

  f32_stage_tile(qs, q + off, q0, seq, stride);
  f32_stage_tile(dos, dout + off, q0, seq, stride);
  tc_cp_async_commit();

  // rows ty + 16 i: lse (+inf past T) and di = dO . O (8 threads a row, 8
  // columns each)
  float lse[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    float part = 0.f;
    lse[i] = INFINITY;
    if (t < seq) {
      lse[i] = lse_in[(size_t)blockIdx.y * seq + t];
      const float4* o4 = reinterpret_cast<const float4*>(out + off + (size_t)t * stride + 8 * tx);
      const float4* g4 = reinterpret_cast<const float4*>(dout + off + (size_t)t * stride + 8 * tx);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 o = __ldg(o4 + c), g = __ldg(g4 + c);
        part = fmaf(o.x, g.x, fmaf(o.y, g.y, fmaf(o.z, g.z, fmaf(o.w, g.w, part))));
      }
    }
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
    di[i] = part;
    if (tx == 0 && t < seq) di_out[(size_t)blockIdx.y * seq + t] = part;
  }

  float acc[4][8] = {};
  const int n_tiles = (seq + kTcTile - 1) / kTcTile;
  for (int base = 0; base < n_tiles; base += 64) {
    uint64_t rem = tc_live_tiles(mb, seq, base, n_tiles, lane);
    while (rem != 0) {
      const int k0 = (base + __ffsll((long long)rem) - 1) * kTcTile;
      rem &= rem - 1;
      const uint64_t keys = tc_tile_keys(mb, seq, k0, lane);
      __syncthreads();                       // the last tile's dQ product has read ks, dss
      f32_stage_tile(ks, k + off, k0, seq, stride);
      f32_stage_tile(vs, v + off, k0, seq, stride);
      tc_cp_async_commit();
      tc_cp_async_wait<0>();
      __syncthreads();                       // the tile (and q, dO) landed
      float s[4][8] = {}, dp[4][8] = {};
      f32_rows_dot(s, qs, ks, ty, tx);
      f32_rows_dot(dp, dos, vs, ty, tx);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = (keys >> (tx + 8 * j)) & 1u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ok ? expf(fmaf(s[i][j], scale, -lse[i])) : 0.f;
          dss[(ty + 16 * i) * kBwdPitch + tx + 8 * j] = p * (dp[i][j] - di[i]);
        }
      }
      __syncthreads();                       // dS is whole
      f32_tile_mm(acc, dss, ks, ty, tx);
    }
  }
  tc_cp_async_wait<0>();
  f32_store_rows(dq + off, acc, scale, q0, ty, tx, seq, stride);
}

__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks)
attention_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v,
                             const unsigned char* __restrict__ key_valid,
                             const float* __restrict__ dout, const float* __restrict__ lse_in,
                             const float* __restrict__ di_in, float* __restrict__ dk,
                             float* __restrict__ dv, int seq, int heads, float scale) {
  extern __shared__ __align__(16) float f32_smem[];
  float* ks = f32_smem;                // [64][kBwdPitch] this block's keys
  float* vs = ks + kF32Tile;           // their values
  float* qs = vs + kF32Tile;           // a query tile
  float* dos = qs + kF32Tile;          // its dO
  float* pts = dos + kF32Tile;         // P^T of the tile (keys x queries)
  float* dsts = pts + kF32Tile;        // dS^T
  float* lse_s = dsts + kF32Tile;      // [64] lse of the query tile
  float* di_s = lse_s + kTcTile;       // [64] its di

  const int k0 = blockIdx.x * kTcTile;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int lane = threadIdx.x & 31;
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const size_t stride = (size_t)heads * kTcTile;
  const size_t off = ((size_t)b * seq * heads + h) * kTcTile;
  const float* lse_b = lse_in + (size_t)blockIdx.y * seq;
  const float* di_b = di_in + (size_t)blockIdx.y * seq;

  float adk[4][8] = {}, adv[4][8] = {};
  const uint64_t keys = tc_tile_keys(key_valid + (size_t)b * seq, seq, k0, lane);
  if (keys != 0) {
    f32_stage_tile(ks, k + off, k0, seq, stride);
    f32_stage_tile(vs, v + off, k0, seq, stride);
    tc_cp_async_commit();
    for (int q0 = 0; q0 < seq; q0 += kTcTile) {
      __syncthreads();                       // the last tile's products have read qs, dos, pts, dsts
      f32_stage_tile(qs, q + off, q0, seq, stride);
      f32_stage_tile(dos, dout + off, q0, seq, stride);
      {
        const int r = threadIdx.x & 63;
        const int t = q0 + r;
        float* dst = threadIdx.x < 64 ? lse_s : di_s;
        tc_cp_async4(tc_smem_u32(dst + r), (threadIdx.x < 64 ? lse_b : di_b) + min(t, seq - 1),
                     t < seq);
      }
      tc_cp_async_commit();
      tc_cp_async_wait<0>();
      __syncthreads();                       // the tile (and k, v) landed
      // key rows ty + 16 i against query columns tx + 8 j
      float s[4][8] = {}, dp[4][8] = {};
      f32_rows_dot(s, ks, qs, ty, tx);
      f32_rows_dot(dp, vs, dos, ty, tx);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        const bool col = q0 + c < seq;       // past T: lse counts as +inf, P = 0
        const float l = lse_s[c], g = di_s[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = col && ((keys >> (ty + 16 * i)) & 1u);
          const float p = ok ? expf(fmaf(s[i][j], scale, -l)) : 0.f;
          pts[(ty + 16 * i) * kBwdPitch + c] = p;
          dsts[(ty + 16 * i) * kBwdPitch + c] = p * (dp[i][j] - g);
        }
      }
      __syncthreads();                       // P^T and dS^T are whole
      f32_tile_mm(adv, pts, dos, ty, tx);
      f32_tile_mm(adk, dsts, qs, ty, tx);
    }
  }
  f32_store_rows(dk + off, adk, scale, k0, ty, tx, seq, stride);
  f32_store_rows(dv + off, adv, 1.f, k0, ty, tx, seq, stride);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// the shared-memory limit and carveout of a kernel, raised once
template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes, bool& done) {
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

int launch_dq(const void* q, const void* k, const void* v, const void* key_valid,
              const void* out, const void* dout, const void* lse, void* di, void* dq,
              int batch, int seq, int heads, int dtype, cudaStream_t stream) {
  const float scale = 0.125f;                // 1 / sqrt(64)
  const dim3 grid((seq + kTcTile - 1) / kTcTile, batch * heads);
  const auto* mask = static_cast<const unsigned char*>(key_valid);
  if (dtype == 0) {
    static bool ready = false;
    const int rc = prepare(attention_bwd_dq_f32_kernel, kBwdSmemDqF32, ready);
    if (rc != 0) return rc;
    attention_bwd_dq_f32_kernel<<<grid, kBwdThreads, kBwdSmemDqF32, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<const float*>(out),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(di), static_cast<float*>(dq), seq, heads, scale);
  } else {
    static bool ready = false;
    const int rc = prepare(attention_bwd_dq_tc_kernel, kBwdSmemDqTc, ready);
    if (rc != 0) return rc;
    using bf = __nv_bfloat16;
    attention_bwd_dq_tc_kernel<<<grid, kTcThreads, kBwdSmemDqTc, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), mask,
        static_cast<const bf*>(out), static_cast<const bf*>(dout),
        static_cast<const float*>(lse), static_cast<float*>(di), static_cast<bf*>(dq), seq,
        heads, scale, scale * kLog2e);
  }
  return (int)cudaGetLastError();
}

int launch_dkv(const void* q, const void* k, const void* v, const void* key_valid,
               const void* dout, const void* lse, const void* di, void* dk, void* dv,
               int batch, int seq, int heads, int dtype, cudaStream_t stream) {
  const float scale = 0.125f;
  const dim3 grid((seq + kTcTile - 1) / kTcTile, batch * heads);
  const auto* mask = static_cast<const unsigned char*>(key_valid);
  if (dtype == 0) {
    static bool ready = false;
    const int rc = prepare(attention_bwd_dkv_f32_kernel, kBwdSmemDkvF32, ready);
    if (rc != 0) return rc;
    attention_bwd_dkv_f32_kernel<<<grid, kBwdThreads, kBwdSmemDkvF32, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<float*>(dk), static_cast<float*>(dv), seq, heads, scale);
  } else {
    static bool ready = false;
    const int rc = prepare(attention_bwd_dkv_tc_kernel, kBwdSmemDkvTc, ready);
    if (rc != 0) return rc;
    using bf = __nv_bfloat16;
    attention_bwd_dkv_tc_kernel<<<grid, kTcThreads, kBwdSmemDkvTc, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), mask,
        static_cast<const bf*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(di), static_cast<bf*>(dk), static_cast<bf*>(dv), seq, heads,
        scale, scale * kLog2e);
  }
  return (int)cudaGetLastError();
}

bool bad_call(int batch, int seq, int heads, int head_dim, int dtype) {
  return batch < 1 || seq < 1 || heads < 1 || head_dim != kTcTile || batch * heads > 65535 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace
}  // namespace cbx

// Plain C entries for ctypes; both take the same arguments (the dq entry
// ignores dk and dv, the dkv entry out and dq). dtype: 0 = float32,
// 1 = bfloat16. head_dim must be 64. lse is K3's (B, H, T) output; di is
// written by the dq entry and read by the dkv entry, so launch dq first.
// Each returns the cudaError_t of its launch (0 on success); neither
// synchronises nor allocates.
extern "C" int cbx_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* key_valid, const void* out,
                                          const void* dout, void* lse, void* di, void* dq,
                                          void* dk, void* dv, int batch, int seq, int heads,
                                          int head_dim, int dtype, void* stream) {
  (void)dk;
  (void)dv;
  if (cbx::bad_call(batch, seq, heads, head_dim, dtype)) return (int)cudaErrorInvalidValue;
  return cbx::launch_dq(q, k, v, key_valid, out, dout, lse, di, dq, batch, seq, heads, dtype,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int cbx_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* key_valid, const void* out,
                                           const void* dout, void* lse, void* di, void* dq,
                                           void* dk, void* dv, int batch, int seq, int heads,
                                           int head_dim, int dtype, void* stream) {
  (void)out;
  (void)dq;
  if (cbx::bad_call(batch, seq, heads, head_dim, dtype)) return (int)cudaErrorInvalidValue;
  return cbx::launch_dkv(q, k, v, key_valid, dout, lse, di, dk, dv, batch, seq, heads, dtype,
                         static_cast<cudaStream_t>(stream));
}
