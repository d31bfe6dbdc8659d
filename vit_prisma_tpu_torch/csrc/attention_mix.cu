// Head-major attention mix, forward: z = softmax(q k^T) v per head.
//
// Replaces the Pallas TPU kernel `_mix_kernel`, launched by `_mix_forward`
// in vit_prisma_tpu/ops/attention.py (kernel B15 of the ROADMAP, entry
// `attention_mix`).  q, k, v and z are [B, N, T, H]: head n of batch item b
// is one contiguous [T, H] block.  The contract is B1's (q pre-scaled,
// float32 scores and softmax with a division, p rounded to the input dtype,
// float32 PV accumulation, z in the input dtype), without a mask; the JAX
// kernel's head-group packing and batch blocks are tile pickers for the TPU
// and change no result, so B15 runs B1's kernel (attention_mix_core.cuh)
// with the head-major strides.

#include "attention_mix_core.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int attention_mix_fwd(const void* q, const void* k, const void* v, void* z,
                                 int batch, int n_heads, int n_tok, int d_head, int dtype,
                                 int device, void* stream) {
  const long long th = (long long)n_tok * d_head;
  const mix::Layout lay{d_head, th, n_heads * th};
  return mix::run(q, k, v, z, batch, n_tok, n_heads, d_head, 0, dtype, device, lay, stream);
}
