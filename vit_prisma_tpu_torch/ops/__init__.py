"""The port's hand-written kernels, each behind a wrapper that adds one to
its ``launches`` where it launches its kernel."""


def counted_kernels():
    """Every launch-counted kernel wrapper of the port, by name."""
    from vit_prisma_tpu_torch.ops import attention as A
    from vit_prisma_tpu_torch.ops import sae_step as S
    from vit_prisma_tpu_torch.ops.ln_matmul import ln_matmul
    from vit_prisma_tpu_torch.ops.opt_step import adam_update
    from vit_prisma_tpu_torch.ops.shuffle import take_rows
    from vit_prisma_tpu_torch.ops.topk import kth_value
    return {f.__name__: f for f in (
        A.attention_mix_tnh, A.attention_mix_tnh_bwd, take_rows, S.sae_fused_forward,
        S.sae_fused_backward, S.sae_fused_backward_stored, adam_update,
        S.sae_fused_forward_topk, S.sae_fused_backward_topk, kth_value,
        S.sae_gated_fused_forward, S.sae_gated_fused_backward, ln_matmul,
        A.flash_attention_padded, A.flash_attention_padded_bwd_dkv,
        A.flash_attention_padded_bwd_dq, A.attention_mix, A.fused_attention_block)}
