"""Visualization of the PyTorch port: numpy copies of the JAX package's
modules (attention grids, patch-level logit-lens overlays, the HTML
attention viewer, SAE dashboards)."""

from vit_prisma_tpu_torch.visualization.visualize_attention import (
    plot_attn_heads, prepare_attn_grid_data,
)
from vit_prisma_tpu_torch.visualization.patch_level_logit_lens import (
    display_grid_on_image, display_grid_on_image_with_heatmap,
    display_patch_logit_lens, patch_heatmap_overlay, denormalize_image,
)
from vit_prisma_tpu_torch.visualization.attention_js import (
    plot_javascript, save_attention_viewer, display_attention_viewer,
)
from vit_prisma_tpu_torch.visualization.sae_dashboards import (
    hist, visualize_sparsities, rare_direction_cosine_sims,
    default_frequency_conditions,
)
from vit_prisma_tpu_torch.visualization.sae_dashboards_html import (
    histogram_payload, build_sparsity_dashboard_html,
    interactive_sparsity_dashboard,
)
