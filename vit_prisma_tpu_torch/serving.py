"""Serving (PyTorch port of ``vit_prisma_tpu/serving.py``).

:class:`CompiledForward` keeps the JAX class's contract: a fixed batch size,
requests of any size cut into batches, the short last batch zero-padded and
its padding rows dropped, and the results concatenated.  On a CUDA device it
is the counterpart of the JAX class's ahead-of-time executable: one CUDA
graph of the forward at its batch size, captured at the first call, so that
a batch costs one graph launch and no Python per kernel.  On the CPU it runs
the eager forward.

:func:`export_forward` / :func:`load_forward` serialize the (optionally
cached) forward through ``torch.export`` with the parameters inside the
artifact, and load it back as a callable that needs no model code.  The
artifact takes the plain routes (the einsum attention, the unfused
LayerNorm), as the JAX package's exporter takes the einsum path: a launch
of the port's kernels goes through ctypes, which ``torch.export`` cannot
trace.
"""

from __future__ import annotations

import io
from typing import Callable, Dict, Optional

import torch
from torch import nn

from vit_prisma_tpu_torch.models.vit import vit_forward
from vit_prisma_tpu_torch.ops import counted_kernels
from vit_prisma_tpu_torch.prisma.hooks import NULL_HOOKS, HookRuntime


def _forward(model, cfg, images, names_filter, stop_at_layer):
    if names_filter is None:
        return vit_forward(model, cfg, images, NULL_HOOKS, stop_at_layer)
    rt = HookRuntime(names_filter=names_filter)
    out = vit_forward(model, cfg, images, rt, stop_at_layer)
    return out, dict(rt.cache)


class CompiledForward:
    """Fixed-batch forward for serving.

    ``model``: a HookedViT.  With ``names_filter`` each call returns
    ``(out, cache)``; without, ``out``.  Requests are cast to the
    parameters' dtype and device; they are images,
    ``[n, n_channels, image_size, image_size]``, as the JAX class's input.

    On a CUDA device the first call captures the graph: a warm-up forward
    on a side stream (which also builds the kernels), then the forward on
    a static input buffer under ``torch.cuda.graph``.  A failed capture
    raises.  Each batch is copied into the buffer (a short last batch
    zero-padded there), the graph is replayed, and the outputs are copied
    out of its static buffers.  The kernels' launch counters move only at
    the warm-up and the capture (whose launches are recorded, not run):
    ``launches_per_replay`` (every counted wrapper's name -> launches the
    graph makes each replay) and ``replays`` count the graph's launches,
    and ``launches`` sums what the server launched on the card."""

    def __init__(self, model, batch_size: int,
                 names_filter=None, stop_at_layer: Optional[int] = None):
        self.model = model
        self.cfg = model.cfg
        self.batch_size = batch_size
        self.names_filter = names_filter
        self.stop_at_layer = stop_at_layer
        p = next(model.parameters())
        self._in_dtype, self._device = p.dtype, p.device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.warmup_launches: Dict[str, int] = {}
        self.launches_per_replay: Dict[str, int] = {}
        self.replays = 0

    def _run(self, images):
        return _forward(self.model, self.cfg, images, self.names_filter, self.stop_at_layer)

    def _capture(self):
        c, dev = self.cfg, self._device
        self._static_in = torch.zeros(
            (self.batch_size, c.n_channels, c.image_size, c.image_size),
            dtype=self._in_dtype, device=dev)
        kernels = counted_kernels()
        counts = lambda: {k: f.launches for k, f in kernels.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = counts()
        with torch.cuda.stream(side):
            self._run(self._static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._static_out = self._run(self._static_in)
        self.warmup_launches = {k: warm[k] - before[k] for k in warm}
        self.launches_per_replay = {k: f.launches - warm[k]
                                    for k, f in kernels.items()}
        self.graph = graph

    @property
    def launches(self) -> Dict[str, int]:
        """Kernel launches this server made on the card: the warm-up
        forward's and ``replays`` × ``launches_per_replay``."""
        return {k: self.warmup_launches[k] + self.replays * n
                for k, n in self.launches_per_replay.items()}

    def _replay(self, chunk):
        if self.graph is None:
            self._capture()
        n = chunk.shape[0]
        self._static_in[:n].copy_(chunk)
        if n < self.batch_size:
            self._static_in[n:].zero_()
        self.graph.replay()
        self.replays += 1
        return _map(lambda a: a[:n].clone(), self._static_out)

    @torch.inference_mode()
    def __call__(self, images):
        images = torch.as_tensor(images).to(self._device, self._in_dtype)
        n, bs = images.shape[0], self.batch_size
        graphed = self._device.type == "cuda"
        outs = []
        for i in range(0, n, bs):
            chunk = images[i:i + bs]
            if graphed:
                outs.append(self._replay(chunk))
                continue
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


class _Exported(nn.Module):
    """The forward ``torch.export`` traces: the model as a submodule (its
    parameters become the artifact's), the plain routes' config and the
    hook set fixed."""

    def __init__(self, model, names_filter, stop_at_layer):
        super().__init__()
        self.model = model
        self.names_filter = names_filter
        self.stop_at_layer = stop_at_layer

    def forward(self, images):
        return _forward(self.model, self.model.cfg, images, self.names_filter,
                        self.stop_at_layer)


def export_forward(model, batch_size: Optional[int] = None,
                   names_filter=None, stop_at_layer: Optional[int] = None,
                   path: Optional[str] = None) -> bytes:
    """Serialize the (optionally cached) forward of ``model`` through
    ``torch.export``, with its parameters inside the artifact.

    ``batch_size=None`` exports a batch-polymorphic artifact (a
    ``torch.export.Dim`` leading axis, any batch from 1); an int fixes it.
    ``names_filter`` bakes the hook set in, so the artifact returns ``(out,
    cache)``.  The artifact takes the plain routes (see the module
    docstring).  Returns the serialized bytes, also written to ``path``
    when one is given."""
    c = model.cfg
    p = next(model.parameters())
    plain = model.with_cfg(use_fused_attention=False, use_fused_ln_gemm=False)
    module = _Exported(plain, names_filter, stop_at_layer).eval()
    # an example batch of 2: torch.export specializes an axis of size 0 or 1
    n = 2 if batch_size is None else batch_size
    example = torch.zeros((n, c.n_channels, c.image_size, c.image_size),
                          dtype=p.dtype, device=p.device)
    dynamic = None
    if batch_size is None:
        dynamic = ({0: torch.export.Dim("batch", min=1)},)
    with torch.no_grad():
        program = torch.export.export(module, (example,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    data = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def load_forward(source) -> Callable:
    """Load an :func:`export_forward` artifact (bytes or a path) and return
    the callable ``images -> outputs``; it needs no model code.  Inputs
    take the exported dtype and device."""
    if isinstance(source, (bytes, bytearray)):
        source = io.BytesIO(bytes(source))
    module = torch.export.load(source).module()
    module.requires_grad_(False)  # a served forward records no autograd graph
    return module
