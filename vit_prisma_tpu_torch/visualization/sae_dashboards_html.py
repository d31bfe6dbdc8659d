"""Interactive SAE sparsity dashboard: a self-contained HTML page (a numpy
copy of ``vit_prisma_tpu/visualization/sae_dashboards_html.py`` for the
PyTorch port; the same page, byte for byte, from the same statistics).

The per-token and per-image log-feature-frequency histograms plus a
cosine-similarity histogram per feature-frequency condition, with per-bar
hover tooltips, a light/dark theme that follows the OS (plus a manual
toggle), and a table view per chart so every value is reachable without
hovering.  No external assets or JS libraries — the histogram statistics
are computed here in numpy (test-covered without a browser) and embedded
as JSON.

Static PNG/SVG rendering of the same figures lives in
``sae_dashboards.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from vit_prisma_tpu_torch.visualization.sae_dashboards import (
    _save_dir, rare_direction_cosine_sims)


def histogram_payload(values, bins: int = 80,
                      title: str = "", xlabel: str = "") -> Optional[dict]:
    """Binned histogram statistics for one chart: edges, counts, percent.
    Returns None for empty input (the chart is skipped, as an empty
    feature-frequency condition is)."""
    values = np.asarray(values, np.float64).reshape(-1)
    values = values[np.isfinite(values)]
    if values.size == 0:
        return None
    counts, edges = np.histogram(values, bins=bins)
    return {
        "title": title,
        "xlabel": xlabel,
        "edges": [round(float(e), 6) for e in edges],
        "counts": [int(c) for c in counts],
        "percent": [round(100.0 * float(c) / values.size, 4) for c in counts],
        "n": int(values.size),
    }


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>__TITLE__</title>
<style>
/* palette: the validated default data-viz palette, slot 1 (blue) —
   single series per chart, light/dark steps selected per surface */
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb;
  --surface-2: #f1f0ee;
  --text-primary: #0b0b0b;
  --text-secondary: #52514e;
  --grid: #e4e3e0;
  --series-1: #2a78d6;
  font-family: system-ui, sans-serif;
  background: var(--surface-1);
  color: var(--text-primary);
  margin: 0; padding: 20px;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #242422;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #32312f; --series-1: #3987e5;
  }
}
:root[data-theme="dark"] .viz-root {
  color-scheme: dark;
  --surface-1: #1a1a19; --surface-2: #242422;
  --text-primary: #ffffff; --text-secondary: #c3c2b7;
  --grid: #32312f; --series-1: #3987e5;
}
.viz-root h2 { font-size: 18px; font-weight: 600; margin: 0 0 4px; }
.viz-root .sub { color: var(--text-secondary); font-size: 13px; margin: 0 0 16px; }
.controls { margin: 0 0 16px; }
.controls button {
  font: inherit; font-size: 13px; color: var(--text-primary);
  background: var(--surface-2); border: 1px solid var(--grid);
  border-radius: 6px; padding: 4px 10px; cursor: pointer;
}
.grid-cards { display: grid; grid-template-columns: repeat(auto-fit, minmax(420px, 1fr)); gap: 16px; }
.card { background: var(--surface-1); border: 1px solid var(--grid);
        border-radius: 8px; padding: 12px 14px; }
.card h3 { font-size: 14px; font-weight: 600; margin: 0 0 2px; }
.card .meta { color: var(--text-secondary); font-size: 12px; margin: 0 0 8px; }
.card svg { display: block; width: 100%; height: auto; }
.bar { fill: var(--series-1); }
.hit { fill: transparent; }
.hit:hover + .bar, .hit:focus + .bar { filter: brightness(1.18); }
.gridline { stroke: var(--grid); stroke-width: 1; }
.axis-text { fill: var(--text-secondary); font-size: 10px;
             font-variant-numeric: tabular-nums; }
#tooltip {
  position: fixed; pointer-events: none; display: none; z-index: 10;
  background: var(--surface-1); color: var(--text-primary);
  border: 1px solid var(--grid); border-radius: 6px;
  padding: 6px 9px; font-size: 12px; box-shadow: 0 2px 8px rgba(0,0,0,.18);
}
#tooltip .v { font-weight: 600; font-size: 13px; }
#tooltip .k { color: var(--text-secondary); }
details { margin-top: 8px; }
details summary { cursor: pointer; font-size: 12px; color: var(--text-secondary); }
table { border-collapse: collapse; font-size: 12px; margin-top: 6px;
        font-variant-numeric: tabular-nums; }
td, th { border: 1px solid var(--grid); padding: 2px 8px; text-align: right; }
th { color: var(--text-secondary); font-weight: 600; }
</style></head>
<body><div class="viz-root">
<h2>__TITLE__</h2>
<p class="sub">__SUBTITLE__</p>
<div class="controls"><button id="themetoggle" type="button">Toggle dark mode</button></div>
<div class="grid-cards" id="cards"></div>
<div id="tooltip" role="status"></div>
<script>
const CHARTS = __DATA__;
const W = 440, H = 240, PAD = {l: 44, r: 8, t: 8, b: 30};
const tooltip = document.getElementById('tooltip');
const SVGNS = 'http://www.w3.org/2000/svg';
function el(tag, attrs) {
  const e = document.createElementNS(SVGNS, tag);
  for (const k in attrs) e.setAttribute(k, attrs[k]);
  return e;
}
function fmt(x) {
  if (!isFinite(x)) return String(x);
  const a = Math.abs(x);
  if (a !== 0 && (a < 0.01 || a >= 100000)) return x.toExponential(2);
  return (Math.round(x * 1000) / 1000).toLocaleString();
}
function niceTicks(lo, hi, n) {
  const span = hi - lo || 1;
  const step0 = span / n, mag = Math.pow(10, Math.floor(Math.log10(step0)));
  const step = [1, 2, 5, 10].map(m => m * mag).find(s => span / s <= n) || mag * 10;
  const ticks = [];
  for (let v = Math.ceil(lo / step) * step; v <= hi + 1e-12; v += step)
    ticks.push(Math.round(v * 1e9) / 1e9);
  return ticks;
}
function showTip(ev, c, i) {
  tooltip.style.display = 'block';
  tooltip.replaceChildren();
  const v = document.createElement('div'); v.className = 'v';
  v.textContent = c.percent[i].toFixed(2) + '% (' + c.counts[i].toLocaleString() + ')';
  const k = document.createElement('div'); k.className = 'k';
  k.textContent = fmt(c.edges[i]) + ' to ' + fmt(c.edges[i + 1]);
  tooltip.append(v, k);
  tooltip.style.left = Math.min(ev.clientX + 14, innerWidth - 170) + 'px';
  tooltip.style.top = (ev.clientY + 14) + 'px';
}
function hideTip() { tooltip.style.display = 'none'; }
function render(c) {
  const card = document.createElement('div'); card.className = 'card';
  const h3 = document.createElement('h3'); h3.textContent = c.title;
  const meta = document.createElement('p'); meta.className = 'meta';
  meta.textContent = 'n = ' + c.n.toLocaleString() + ' \\u00b7 ' + c.xlabel;
  const svg = el('svg', {viewBox: '0 0 ' + W + ' ' + H,
                         role: 'img', 'aria-label': c.title});
  const x0 = PAD.l, x1 = W - PAD.r, y0 = H - PAD.b, y1 = PAD.t;
  const lo = c.edges[0], hi = c.edges[c.edges.length - 1];
  const pmax = Math.max(...c.percent, 1e-9);
  const sx = v => x0 + (v - lo) / (hi - lo || 1) * (x1 - x0);
  const sy = p => y0 - p / pmax * (y0 - y1);
  for (const t of niceTicks(0, pmax, 4)) {
    svg.appendChild(el('line', {x1: x0, x2: x1, y1: sy(t), y2: sy(t), class: 'gridline'}));
    const lbl = el('text', {x: x0 - 6, y: sy(t) + 3, 'text-anchor': 'end', class: 'axis-text'});
    lbl.textContent = t + '%'; svg.appendChild(lbl);
  }
  for (const t of niceTicks(lo, hi, 6)) {
    const lbl = el('text', {x: sx(t), y: y0 + 14, 'text-anchor': 'middle', class: 'axis-text'});
    lbl.textContent = fmt(t); svg.appendChild(lbl);
  }
  svg.appendChild(el('line', {x1: x0, x2: x1, y1: y0, y2: y0, class: 'gridline'}));
  const nb = c.counts.length;
  for (let i = 0; i < nb; i++) {
    if (!c.counts[i]) continue;
    const bx0 = sx(c.edges[i]) + 1, bx1 = sx(c.edges[i + 1]) - 1;  // 2px surface gap
    const bw = Math.max(bx1 - bx0, 1), by = sy(c.percent[i]);
    const bh = y0 - by;
    const r = Math.min(4, bw / 2, bh);  // 4px rounded data-end, square baseline
    const d = 'M' + bx0 + ',' + y0 + ' V' + (by + r) +
              ' Q' + bx0 + ',' + by + ' ' + (bx0 + r) + ',' + by +
              ' H' + (bx1 - r) + ' Q' + bx1 + ',' + by + ' ' + bx1 + ',' + (by + r) +
              ' V' + y0 + ' Z';
    const hit = el('rect', {x: bx0 - 1, y: y1, width: bw + 2, height: y0 - y1,
                            class: 'hit', tabindex: '0'});
    const bar = el('path', {d: d, class: 'bar'});
    hit.addEventListener('pointermove', ev => showTip(ev, c, i));
    hit.addEventListener('pointerleave', hideTip);
    hit.addEventListener('focus', ev => {
      const r2 = hit.getBoundingClientRect();
      showTip({clientX: r2.left + r2.width / 2, clientY: r2.top}, c, i);
    });
    hit.addEventListener('blur', hideTip);
    svg.append(hit, bar);
  }
  const det = document.createElement('details');
  const sum = document.createElement('summary'); sum.textContent = 'Table view';
  const tbl = document.createElement('table');
  const hr = document.createElement('tr');
  for (const h of ['bin start', 'bin end', 'count', 'percent']) {
    const th = document.createElement('th'); th.textContent = h; hr.appendChild(th);
  }
  tbl.appendChild(hr);
  for (let i = 0; i < nb; i++) {
    if (!c.counts[i]) continue;
    const tr = document.createElement('tr');
    for (const v of [fmt(c.edges[i]), fmt(c.edges[i + 1]),
                     c.counts[i].toLocaleString(), c.percent[i].toFixed(3) + '%']) {
      const td = document.createElement('td'); td.textContent = v; tr.appendChild(td);
    }
    tbl.appendChild(tr);
  }
  det.append(sum, tbl);
  card.append(h3, meta, svg, det);
  return card;
}
const cards = document.getElementById('cards');
for (const c of CHARTS) cards.appendChild(render(c));
document.getElementById('themetoggle').onclick = () => {
  const r = document.documentElement;
  const dark = r.getAttribute('data-theme') === 'dark' ||
    (!r.getAttribute('data-theme') &&
     matchMedia('(prefers-color-scheme: dark)').matches);
  r.setAttribute('data-theme', dark ? 'light' : 'dark');
};
</script></div></body></html>
"""


def build_sparsity_dashboard_html(charts: Sequence[dict], title: str,
                                  subtitle: str = "") -> str:
    """Assemble the standalone page from ``histogram_payload`` dicts."""
    charts = [c for c in charts if c is not None]
    return (_PAGE
            .replace("__TITLE__", title.replace("<", "&lt;"))
            .replace("__SUBTITLE__", subtitle.replace("<", "&lt;"))
            .replace("__DATA__", json.dumps(charts)))


def interactive_sparsity_dashboard(cfg, log_freq_tokens, log_freq_images,
                                   conditions: Sequence[np.ndarray],
                                   condition_texts: Sequence[str],
                                   name: str, sparse_autoencoder,
                                   bins: int = 80) -> Dict[str, str]:
    """Interactive analogue of ``visualize_sparsities`` (evals.py:752-801):
    one HTML file with every histogram as a hover-enabled chart + table
    view.  Returns {"html": path}."""
    log_freq_tokens = np.asarray(log_freq_tokens)
    log_freq_images = np.asarray(log_freq_images)
    charts = [
        histogram_payload(log_freq_tokens, bins,
                          title="Log frequency of features by token",
                          xlabel="log10(freq)"),
        histogram_payload(log_freq_images, bins,
                          title="Log frequency of features by image",
                          xlabel="log10(freq)"),
    ]
    W_enc = sparse_autoencoder.params["W_enc"] \
        if hasattr(sparse_autoencoder, "params") else sparse_autoencoder
    n_feat = max(log_freq_tokens.shape[0], 1)
    for condition, text in zip(conditions, condition_texts):
        condition = np.asarray(condition)
        pct = 100.0 * condition.sum() / n_feat
        if pct == 0:
            continue
        sims = rare_direction_cosine_sims(W_enc, condition)
        charts.append(histogram_payload(
            sims, bins,
            title=f"Cosine similarity of {text} encoder directions "
                  f"({int(round(pct))}% of features)",
            xlabel="cosine similarity"))
    html = build_sparsity_dashboard_html(
        charts, title=f"{name} — SAE sparsity dashboard",
        subtitle="Hover a bar for the bin range and share; each chart has "
                 "a table view. Theme follows the OS (toggle above).")
    path = os.path.join(_save_dir(cfg), f"{name}_sparsity_dashboard.html")
    with open(path, "w") as f:
        f.write(html)
    return {"html": path}
