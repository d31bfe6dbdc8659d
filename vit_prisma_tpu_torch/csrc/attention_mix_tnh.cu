// Token-major attention mix, forward: z = softmax(q k^T) v per head.
//
// Replaces the Pallas TPU kernel `_mix_kernel_tnh`, launched by
// `_mix_tnh_forward` in vit_prisma_tpu/ops/attention.py (kernel B1 of the
// ROADMAP).  Same contract: q, k, v and z are [B, T, N*H] in the layout the
// QKV projection GEMMs write, so head n of token (b, t) starts at element
// (b*T + t)*N*H + n*H.  The kernel itself, its design and its shared-memory
// budget are in attention_mix_core.cuh, which kernel B15 (attention_mix.cu,
// the head-major layout) shares.

#include "attention_mix_core.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int attention_mix_tnh_fwd(const void* q, const void* k,
                                     const void* v, void* z, int batch,
                                     int n_tok, int n_heads, int d_head,
                                     int causal, int dtype, int device,
                                     void* stream) {
  const long long nh = (long long)n_heads * d_head;
  const mix::Layout lay{nh, d_head, (long long)n_tok * nh};
  return mix::run(q, k, v, z, batch, n_tok, n_heads, d_head, causal, dtype, device, lay,
                  stream);
}

extern "C" const char* vpt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
