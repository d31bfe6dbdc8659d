"""Interactive attention viewer: a self-contained HTML/JS page (a numpy copy of
``vit_prisma_tpu/visualization/attention_js.py`` for the PyTorch port).

The arrays and HTML equal the JAX package's for the same inputs;
matplotlib is imported inside each plotting function.
"""

from __future__ import annotations

import json
import numpy as np

from vit_prisma_tpu_torch.visualization.patch_level_logit_lens import denormalize_image

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Attention viewer</title>
<style>
 body {{ font-family: sans-serif; margin: 16px; }}
 #wrap {{ display: flex; gap: 24px; }}
 canvas {{ image-rendering: pixelated; border: 1px solid #888; }}
 select {{ margin-right: 12px; }}
</style></head>
<body>
<h3>Attention viewer — hover a patch</h3>
<div>
 Layer: <select id="layer"></select>
 Head: <select id="head"></select>
 <label><input type="checkbox" id="fromcls"> attention FROM CLS</label>
</div>
<div id="wrap">
 <div><p>image (query)</p><canvas id="img" width="{W}" height="{W}"></canvas></div>
 <div><p>attention (keys)</p><canvas id="attn" width="{W}" height="{W}"></canvas></div>
</div>
<p id="info"></p>
<script>
const DATA = {data_json};
const P = DATA.patch_size, N = DATA.grid, S = {scale};
const imgC = document.getElementById('img'), attnC = document.getElementById('attn');
const ictx = imgC.getContext('2d'), actx = attnC.getContext('2d');
const layerSel = document.getElementById('layer'), headSel = document.getElementById('head');
for (let l = 0; l < DATA.n_layers; l++) layerSel.add(new Option('L' + l, l));
for (let h = 0; h < DATA.n_heads; h++) headSel.add(new Option('H' + h, h));
function drawImage() {{
  const im = DATA.image;  // H x W x 3 in [0,1]
  for (let y = 0; y < im.length; y++) for (let x = 0; x < im[0].length; x++) {{
    const [r, g, b] = im[y][x];
    ictx.fillStyle = `rgb(${{r * 255 | 0}},${{g * 255 | 0}},${{b * 255 | 0}})`;
    ictx.fillRect(x * S, y * S, S, S);
  }}
  ictx.strokeStyle = 'rgba(255,255,255,0.5)';
  for (let i = 1; i < N; i++) {{
    ictx.beginPath(); ictx.moveTo(i * P * S, 0); ictx.lineTo(i * P * S, imgC.height); ictx.stroke();
    ictx.beginPath(); ictx.moveTo(0, i * P * S); ictx.lineTo(imgC.width, i * P * S); ictx.stroke();
  }}
}}
function drawAttn(q) {{
  const l = +layerSel.value, h = +headSel.value;
  const row = DATA.attn[l][h][q];           // length = n_tokens
  const vals = DATA.has_cls ? row.slice(1) : row;  // spatial keys
  const vmax = Math.max(...vals, 1e-9);
  actx.clearRect(0, 0, attnC.width, attnC.height);
  for (let i = 0; i < vals.length; i++) {{
    const r = Math.floor(i / N), c = i % N;
    const v = vals[i] / vmax;
    actx.fillStyle = `rgba(${{30 + 225 * v | 0}}, ${{60 * v | 0}}, ${{140 - 100 * v | 0}}, 1)`;
    actx.fillRect(c * P * S, r * P * S, P * S, P * S);
  }}
  const cls = DATA.has_cls ? ` | to CLS: ${{row[0].toFixed(4)}}` : '';
  document.getElementById('info').textContent =
    `query token ${{q}} (layer ${{l}}, head ${{h}}), max attn ${{vmax.toFixed(4)}}${{cls}}`;
}}
imgC.addEventListener('mousemove', (e) => {{
  const rect = imgC.getBoundingClientRect();
  const c = Math.min(N - 1, Math.floor((e.clientX - rect.left) / (P * S)));
  const r = Math.min(N - 1, Math.floor((e.clientY - rect.top) / (P * S)));
  const q = (DATA.has_cls && !document.getElementById('fromcls').checked ? 1 : 0) + r * N + c;
  drawAttn(document.getElementById('fromcls').checked && DATA.has_cls ? 0 : q);
}});
layerSel.onchange = headSel.onchange = () => drawAttn(DATA.has_cls ? 1 : 0);
drawImage(); drawAttn(DATA.has_cls ? 1 : 0);
</script></body></html>
"""


def plot_javascript(attention, image, patch_size: int = 32,
                    has_cls: bool = True, scale: int = 2,
                    max_side: int = 224) -> str:
    """Build the standalone HTML viewer.

    ``attention``: [n_layers, n_heads, T, T] (or [n_heads, T, T] for one
    layer); ``image``: CHW normalized or HWC [0,1]."""
    attn = np.asarray(attention, np.float32)
    if attn.ndim == 3:
        attn = attn[None]
    n_layers, n_heads, T, _ = attn.shape
    img = denormalize_image(image)
    if img.shape[0] > max_side:
        step = img.shape[0] // max_side
        img = img[::step, ::step]
    grid = int(round((T - 1 if has_cls else T) ** 0.5))
    data = {
        "attn": np.round(attn, 5).tolist(),
        "image": np.round(img, 4).tolist(),
        "patch_size": img.shape[0] // grid,
        "grid": grid,
        "n_layers": n_layers,
        "n_heads": n_heads,
        "has_cls": bool(has_cls),
    }
    W = img.shape[0] * scale
    return _TEMPLATE.format(data_json=json.dumps(data), W=W, scale=scale)


def save_attention_viewer(path: str, attention, image, patch_size: int = 32,
                          has_cls: bool = True) -> str:
    html = plot_javascript(attention, image, patch_size, has_cls)
    with open(path, "w") as f:
        f.write(html)
    return path


def display_attention_viewer(attention, image, patch_size: int = 32,
                             has_cls: bool = True):
    """Render inline in a Jupyter notebook."""
    from IPython.display import HTML, display
    display(HTML(plot_javascript(attention, image, patch_size, has_cls)))
