"""The port's attention grid, patch-level logit-lens overlay and HTML
attention viewer against the JAX package's: the same arrays and HTML for
the same numpy inputs, and the plotting functions under the Agg backend."""

import numpy as np
import pytest

from tests._torch_parity import seeded
from vit_prisma_tpu import visualization as jax_vis
from vit_prisma_tpu_torch import visualization as port_vis


def _attn(L=2, H=3, T=5, seed=0):
    a = np.abs(seeded(seed, (L, H, T, T)))
    return a / a.sum(-1, keepdims=True)


@pytest.mark.parametrize("opts", [
    {}, dict(log_transform=True), dict(fourier_transform_global=True),
    dict(fourier_transform_local=True, global_min_max=True), dict(global_normalize=True)])
def test_attn_grid_data_matches_jax(opts):
    a = _attn()
    want = jax_vis.prepare_attn_grid_data(a, 2, 3, **opts)
    got = port_vis.prepare_attn_grid_data(a, 2, 3, **opts)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_patch_overlays_match_jax():
    img = seeded(1, (3, 16, 16))
    np.testing.assert_array_equal(port_vis.denormalize_image(img), jax_vis.denormalize_image(img))
    vals = seeded(2, (16,))
    np.testing.assert_array_equal(port_vis.patch_heatmap_overlay(vals, 16, 4),
                                  jax_vis.patch_heatmap_overlay(vals, 16, 4))
    from vit_prisma_tpu.visualization import patch_level_logit_lens as jl
    from vit_prisma_tpu_torch.visualization import patch_level_logit_lens as pl
    assert pl.patch_text_positions(16, 4) == jl.patch_text_positions(16, 4)


@pytest.mark.parametrize("has_cls,ndim", [(True, 4), (False, 3)])
def test_attention_viewer_html_matches_jax(tmp_path, has_cls, ndim):
    T = 17 if has_cls else 16
    a = _attn(T=T, seed=3)
    if ndim == 3:
        a = a[0]
    img = seeded(4, (3, 16, 16))
    assert port_vis.plot_javascript(a, img, 4, has_cls) == jax_vis.plot_javascript(a, img, 4, has_cls)
    p = port_vis.save_attention_viewer(str(tmp_path / "v.html"), a, img, 4, has_cls)
    assert open(p).read() == jax_vis.plot_javascript(a, img, 4, has_cls)


def test_plots_run_under_agg(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    a = _attn()
    fig = port_vis.plot_attn_heads(a, n_heads=3, n_layers=2, figsize=(4, 4), global_min_max=True,
                                   save_path=str(tmp_path / "g.png"), show=False)
    assert len(fig.axes) == 7 and (tmp_path / "g.png").exists()
    fig = port_vis.plot_attn_heads(a, n_heads=3, n_layers=2, figsize=(4, 4),
                                   graph_type="histogram_graph", show=False)
    assert len(fig.axes) == 6
    img = seeded(5, (3, 16, 16))
    assert port_vis.display_grid_on_image(img, 4) is not None
    ax, hm = port_vis.display_grid_on_image_with_heatmap(img, seeded(6, (16,)), 4)
    assert hm.get_array().shape == (16, 16)
    patches = {i: [(float(i), f"class{i}, extra", i)] for i in range(17)}
    fig = port_vis.display_patch_logit_lens(img, patches, patch_size=4,
                                            save_path=str(tmp_path / "l.png"), show=False)
    assert (tmp_path / "l.png").exists() and len(fig.axes[0].texts) == 16
    fig = port_vis.display_patch_logit_lens(img, patches, patch_size=4, use_emoji=True,
                                            show=False)
    assert len(fig.axes[0].texts) == 16
    plt.close("all")
