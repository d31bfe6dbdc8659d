"""vit_prisma_tpu_torch — the PyTorch and CUDA port of vit_prisma_tpu.

It runs the hooked ViT of the JAX package (same config fields, hook names,
parameter names and layouts), its gradient paths, SAE splicing, supervised
training, the activation cache's analyses, model loading, the CLIP text
tower (``HookedTextTransformer``), its tokenizer and zero-shot
classification (``model_eval``) on PyTorch,
with the JAX package's Pallas kernels rewritten by hand for NVIDIA Hopper
(sm_90a) under ``csrc/``.  It imports no JAX.
"""

__version__ = "0.1.0"

from vit_prisma_tpu_torch.configs.vit_config import ViTConfig, TextTransformerConfig
from vit_prisma_tpu_torch.models.vit import HookedViT, vit_forward, hook_names, init_vit_params
from vit_prisma_tpu_torch.models.sae_vit import HookedSAEViT
from vit_prisma_tpu_torch.models.text import HookedTextTransformer
from vit_prisma_tpu_torch.models.loading.loader import load_hooked_model
from vit_prisma_tpu_torch.models.loading.registry import get_model_config
from vit_prisma_tpu_torch.prisma.cache import ActivationCache
from vit_prisma_tpu_torch.prisma.factored_matrix import FactoredMatrix
from vit_prisma_tpu_torch.prisma.hooks import HookRuntime, HookInfo
from vit_prisma_tpu_torch.utils.prisma_utils import get_act_name, test_prompt
from vit_prisma_tpu_torch.serving import CompiledForward, export_forward, load_forward
