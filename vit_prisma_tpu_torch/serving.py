"""Serving (PyTorch port of ``vit_prisma_tpu/serving.py``).

:class:`CompiledForward` keeps the JAX class's contract: a fixed batch size,
requests of any size cut into batches, the short last batch zero-padded and
its padding rows dropped, and the results concatenated.  It runs the eager
forward (the name is kept so that callers port unchanged); capturing it as a
CUDA graph is later work.  ``export_forward``/``load_forward`` are not
ported yet (ROADMAP queue A, item 15).
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_prisma_tpu_torch.models.vit import vit_forward
from vit_prisma_tpu_torch.prisma.hooks import NULL_HOOKS, HookRuntime


class CompiledForward:
    """Fixed-batch forward for serving.

    ``model``: a HookedViT.  With ``names_filter`` each call returns
    ``(out, cache)``; without, ``out``.  Requests are cast to the
    parameters' dtype and device."""

    def __init__(self, model, batch_size: int,
                 names_filter=None, stop_at_layer: Optional[int] = None):
        self.model = model
        self.cfg = model.cfg
        self.batch_size = batch_size
        self.names_filter = names_filter
        self.stop_at_layer = stop_at_layer
        p = next(model.parameters())
        self._in_dtype, self._device = p.dtype, p.device

    def _run(self, images):
        if self.names_filter is None:
            return vit_forward(self.model, self.cfg, images, NULL_HOOKS,
                               self.stop_at_layer)
        rt = HookRuntime(names_filter=self.names_filter)
        out = vit_forward(self.model, self.cfg, images, rt, self.stop_at_layer)
        return out, dict(rt.cache)

    @torch.inference_mode()
    def __call__(self, images):
        images = torch.as_tensor(images).to(self._device, self._in_dtype)
        n, bs = images.shape[0], self.batch_size
        outs = []
        for i in range(0, n, bs):
            chunk = images[i:i + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad,) + chunk.shape[1:])])
            out = self._run(chunk)
            if pad:
                out = _map(lambda a: a[:bs - pad], out)
            outs.append(out)
        if len(outs) == 1:
            return outs[0]
        if self.names_filter is None:
            return torch.cat(outs)
        cache = {k: torch.cat([c[k] for _, c in outs]) for k in outs[0][1]}
        return torch.cat([o for o, _ in outs]), cache


def _map(fn, out):
    if isinstance(out, tuple):
        o, cache = out
        return fn(o), {k: fn(v) for k, v in cache.items()}
    return fn(out)


def export_forward(*args, **kwargs):
    raise NotImplementedError(
        "export_forward is not ported yet (ROADMAP queue A, item 15)")


def load_forward(*args, **kwargs):
    raise NotImplementedError(
        "load_forward is not ported yet (ROADMAP queue A, item 15)")
