"""vit_prisma_tpu_torch — the PyTorch and CUDA port of vit_prisma_tpu.

It runs the hooked ViT of the JAX package (same config fields, hook names,
parameter names and layouts), its gradient paths, SAE splicing and
supervised training on PyTorch, with the JAX package's Pallas kernels
rewritten by hand for NVIDIA Hopper (sm_90a) under ``csrc/``.  It imports no
JAX.
"""

__version__ = "0.1.0"

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig, TextTransformerConfig
from vit_prisma_tpu_torch.models.vit import HookedViT, vit_forward, hook_names, init_vit_params
from vit_prisma_tpu_torch.models.sae_vit import HookedSAEViT
from vit_prisma_tpu_torch.models.loading.registry import get_model_config
from vit_prisma_tpu_torch.prisma.hooks import HookRuntime, HookInfo
from vit_prisma_tpu_torch.utils.prisma_utils import get_act_name
from vit_prisma_tpu_torch.serving import CompiledForward, export_forward, load_forward
