// Key-masked self-attention of the batched CFM estimator, written for Hopper
// (sm_90a). It replaces the stock Pallas TPU flash_attention that
// chatterbox_embed_tpu/models/layers.py:mha_flash calls (non-causal, key
// padding given as segment ids, no `ab` bias on this path).
//
// q, k, v, out (B, T, H, 64) and key_valid (B, T); scale 1/sqrt(64). Two
// kernels, each with its design notes: bf16 inputs run on the tensor cores
// (masked_attention_tc.cuh), fp32 inputs on the CUDA cores
// (masked_attention.cuh). What bounds it: 4 * T^2 * 64 FLOP per (row, head)
// for scores and p.v, about 0.17 GFLOP at T = 812 against 0.4 MB of
// operands, so it is compute-bound too.
//
// Semantics: the port takes layers.mha's key-mask semantics at every query
// row (every query attends the valid keys of its row). The TPU kernel
// differs at invalid query rows only, which attend the invalid keys there
// (segment id 0). No valid output reads those rows: the estimator masks
// every conv input and its output. So this kernel equals its plain version
// (layers.mha with a key mask) at every row that has a valid key, and the
// JAX package at every valid row. A row with no valid key writes 0 here,
// where layers.mha averages all keys; no CFM row on the path is empty.

#include "masked_attention.cuh"
#include "masked_attention_tc.cuh"

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. head_dim
// must be 64. `lse` is null (serving) or a (B, H, T) fp32 buffer that gets
// each query row's log-sum-exp over its valid keys, natural log, +inf for a
// row without one: what the stock TPU op saves as its residuals l and m
// (flash_attention.py:246-251, jax 0.9.0), for K3b. Returns the cudaError_t
// of the launch (0 on success); it never synchronises and allocates nothing.
extern "C" int cbx_flash_attention(const void* q, const void* k, const void* v,
                                   const void* key_valid, void* out, void* lse,
                                   int batch, int seq, int heads, int head_dim,
                                   int dtype, void* stream) {
  if (head_dim != cbx::kDV) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)head_dim);
  return cbx::dispatch_masked_attention<true>(q, k, v, key_valid, out,
                                              static_cast<float*>(lse), batch, seq,
                                              heads, head_dim, scale, dtype, stream);
}
