// Rel-pos attention of the batched conformer, written for Hopper (sm_90a).
// It replaces the Pallas TPU kernel
// chatterbox_embed_tpu/kernels/rel_attention.py:_kernel (entry rel_attention).
//
// The Transformer-XL score ac + bd arrives factored into one augmented
// product (models/conformer.py builds the operands):
//   q_aug = [q + u | A | B],  k_aug = [k | cos | sin]   (B, T, H, Da = 576)
// so the kernel is masked softmax((q_aug . k_aug^T) * scale) . v with v
// (B, T, H, 64) and key_valid (B, T): the same as the TPU kernel, including
// that invalid queries attend the valid keys and that a row with no valid
// key gives 0. Two kernels, each with its design notes: bf16 inputs run on
// the tensor cores (masked_attention_tc.cuh: wgmma for both products, Q
// resident in shared memory, K streamed in 64-wide slices), fp32 inputs on
// the CUDA cores (masked_attention.cuh). What bounds it: 2 * T^2 * (576 + 64)
// FLOP per (row, head), about 0.84 GFLOP at T = 812 against 2 MB of
// operands, so it is compute-bound.
//
// Not carried over from the TPU kernel: the padding of T and Da to multiples
// of 128 and the whole-row VMEM blocks.

#include "masked_attention.cuh"
#include "masked_attention_tc.cuh"

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (q_aug, k_aug,
// v and out share it). da must be a multiple of 64 (bf16: at most 576) and
// dv must be 64. Returns the cudaError_t of the launch (0 on success); it
// never synchronises and allocates nothing.
extern "C" int cbx_rel_attention(const void* q_aug, const void* k_aug,
                                 const void* v, const void* key_valid,
                                 void* out, int batch, int seq, int heads,
                                 int da, int dv, float scale, int dtype,
                                 void* stream) {
  if (dv != cbx::kDV) return (int)cudaErrorInvalidValue;
  return cbx::dispatch_masked_attention<false>(q_aug, k_aug, v, key_valid, out,
                                               nullptr, batch, seq, heads, da,
                                               scale, dtype, stream);
}
