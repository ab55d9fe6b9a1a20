// Kimi Delta Attention's recurrence (K9), written for Hopper (sm_90a). It
// replaces no TPU kernel: the JAX package has no linear attention. It was
// added for T3's Kimi-Linear backbone (models/kimi_linear.py), whose 20
// KDA layers each keep a dk x dv = 128 x 128 fp32 state S a (row, head).
//
// What it computes, for each row b, head h and position t >= skip[b]
// (kernels/kda.py:kda_recurrent_reference step by step, fla's
// fused_recurrent_kda):
//   S' = Diag(exp(g_t)) S            (g_t the log decay of each key channel)
//   u  = beta_t (v_t - S'^T k_t)      (the delta rule's correction)
//   S  = S' + k_t u^T
//   o_t = S^T q_t
// all in fp32; q, k, v, g, beta come in fp32 (q and k L2-normalised).
// Positions below skip[b] (the row's left pad) are passed over: S does not
// change and o is 0. S starts from s_in, or from zero when s_in is null
// (a prefill), and is written to s_out at the end (s_out may be s_in).
//
// What bounds it on an H100: a decode call's bytes. A step of the engine
// (32 rows, one token) reads and writes 32 x 32 x 64 KB = 67 MB of state a
// layer against ~7 flops an element, so its floor is the state's traffic
// over 3.35 TB/s, ~40 us a layer. A prefill (2 rows, a few hundred tokens)
// is bound by the token-to-token chain instead: each token's update needs
// the last one's state.
//
// Design: one warp a (row, head, 32-column value tile); lane j holds the
// state's column j (128 fp32 values) in registers for the whole call, so
// each tile is read once and written once, with 128 independent coalesced
// loads (a row of 32 columns is 128 contiguous bytes) in flight a lane.
// Both sums over the key channels (S'^T k and S^T q) run down a lane's own
// column: no shuffle and no shared-memory reduction, four partial sums to
// break the dependence chain. The token's q, k and exp(g) (128 each, the
// same for every lane) are staged in shared memory, 4 values a lane, and
// read as broadcasts; the next token's are loaded into registers while the
// current one is computed. Only __syncwarp: a block is one warp. No
// atomics, so the same bits in every run; no host read and no allocation,
// so a CUDA graph captures it.
//
// Prompts are at most a few hundred positions (the engine's context), so
// the chunked (WY) form, which turns a long prefill into matrix products,
// is not built.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDK = 128;       // key channels: a lane's column of the state
constexpr int kTile = 32;      // value columns a warp
constexpr int kPer = kDK / 32; // staged values a lane a vector

struct Next {
  float q[kPer], k[kPer], g[kPer], v, beta;
};

__device__ __forceinline__ void load_token(Next& n, const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ g,
                                           const float* __restrict__ v,
                                           const float* __restrict__ beta, size_t row, int dv,
                                           int j, int lane) {
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const size_t c = row * kDK + lane + 32 * m;
    n.q[m] = q[c];
    n.k[m] = k[c];
    n.g[m] = g[c];
  }
  n.v = v[row * dv + j];
  n.beta = beta[row];
}

__global__ void __launch_bounds__(kTile)
kda_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ g, const float* __restrict__ beta,
           const float* s_in, float* s_out, float* __restrict__ o,  // s_in may be s_out
           const int* __restrict__ skip, int T, int H, int dv) {
  __shared__ __align__(16) float sq[kDK];
  __shared__ __align__(16) float sk[kDK];
  __shared__ __align__(16) float sa[kDK];
  const int bh = blockIdx.x;               // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int lane = threadIdx.x;
  const int j = blockIdx.y * kTile + lane;
  const size_t base = (size_t)bh * kDK * dv + j;

  float s[kDK];
  if (s_in != nullptr) {
#pragma unroll
    for (int i = 0; i < kDK; ++i) s[i] = s_in[base + (size_t)i * dv];
  } else {
#pragma unroll
    for (int i = 0; i < kDK; ++i) s[i] = 0.f;
  }
  int t0 = skip != nullptr ? skip[b] : 0;
  t0 = t0 < 0 ? 0 : (t0 > T ? T : t0);
  for (int t = 0; t < t0; ++t) o[(((size_t)b * T + t) * H + h) * dv + j] = 0.f;

  Next n;
  if (t0 < T) load_token(n, q, k, g, v, beta, ((size_t)b * T + t0) * H + h, dv, j, lane);
  for (int t = t0; t < T; ++t) {
    const size_t row = ((size_t)b * T + t) * H + h;
    __syncwarp();
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      sq[lane + 32 * m] = n.q[m];
      sk[lane + 32 * m] = n.k[m];
      sa[lane + 32 * m] = expf(n.g[m]);
    }
    const float vj = n.v, bt = n.beta;
    __syncwarp();
    if (t + 1 < T) load_token(n, q, k, g, v, beta, row + H, dv, j, lane);

    float kv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kDK; ++i) {
      s[i] *= sa[i];
      kv[i & 3] = fmaf(sk[i], s[i], kv[i & 3]);
    }
    const float u = bt * (vj - ((kv[0] + kv[1]) + (kv[2] + kv[3])));
    float ov[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kDK; ++i) {
      s[i] = fmaf(sk[i], u, s[i]);
      ov[i & 3] = fmaf(sq[i], s[i], ov[i & 3]);
    }
    o[row * dv + j] = (ov[0] + ov[1]) + (ov[2] + ov[3]);
  }
#pragma unroll
  for (int i = 0; i < kDK; ++i) s_out[base + (size_t)i * dv] = s[i];
}

}  // namespace

// q, k, g (B, T, H, dk); v, o (B, T, H, dv); beta (B, T, H); s_in (may be
// null: zero), s_out (B, H, dk, dv); skip (B,) int32 or null. All fp32 but
// skip, contiguous; dk 128, dv a multiple of 32.
extern "C" int cbx_kda_recurrent(const void* q, const void* k, const void* v, const void* g,
                                 const void* beta, const void* s_in, void* s_out, void* o,
                                 const void* skip, int B, int T, int H, int dk, int dv,
                                 void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (dk != kDK || dv <= 0 || dv % kTile || T < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(B * H), (unsigned)(dv / kTile));
  kda_kernel<<<grid, kTile, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(beta),
      static_cast<const float*>(s_in), static_cast<float*>(s_out), static_cast<float*>(o),
      static_cast<const int*>(skip), T, H, dv);
  return (int)cudaGetLastError();
}
