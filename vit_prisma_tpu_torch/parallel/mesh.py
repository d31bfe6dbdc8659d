"""Device meshes and sharded training and inference (PyTorch port of
``vit_prisma_tpu/parallel/mesh.py``).

The JAX package shards through GSPMD over a ``jax.sharding.Mesh``.  The port
runs one process a rank (``torchrun``, or :func:`distributed_init` with an
``init_method``) over a ``torch.distributed.device_mesh.DeviceMesh`` with
the dims ``("data", "model")`` (:func:`make_mesh`), keeps each shard as plain
local tensors and writes the collectives out
(``parallel/collectives.py``), so the hand-written kernels run on each
rank's shard: B1, B2, B13 and B14 on its heads and columns, B3 on its rows,
B4-B12 on its layers and rows, B7 on its parameters.

The layout is the JAX package's.  A plan (``*_shardings``) gives for each
leaf a :class:`Placement`, the mesh and the axis name each tensor dimension
is split on (None: whole), as JAX's ``NamedSharding(mesh, P(...))``:

- the ViT (:func:`vit_param_shardings`): attention heads (``W_Q``, ``W_K``,
  ``W_V``, ``b_Q``, ``b_K``, ``b_V``, ``W_O``) and ``d_mlp`` (``W_in``
  columns, ``b_in``, ``W_out`` rows) over ``model``; heads that do not
  divide the axis keep attention whole, as GSPMD snaps a misaligned split to
  replicated (and an MLP whose activation normalizes over ``d_mlp`` stays
  whole);
- a single SAE (:func:`sae_param_shardings`): ``W_enc`` columns, ``W_dec``
  rows, ``b_enc``/``b_gate``/``r_mag``/``b_mag`` and the per-feature
  counters over ``model``; ``b_dec``, ``b_dec_out`` and ``W_skip`` whole;
  the Adam moments mirror their parameters;
- the sweep (:func:`sweep_state_shardings`): the layer axis of every leaf
  over ``model``;
- batches: rows over ``data`` (:func:`batch_sharding`), a sweep batch's
  layers over ``model`` too (:func:`sweep_batch_sharding`).

The builders return functions of this rank's shards: ``place_state`` cuts a
whole state to this rank's shard (:func:`shard_tree`), :func:`gather_tree`
puts the shards back together, and :func:`data_rows` cuts a global batch to
this rank's rows.  Every rank calls every builder and step in the same
order, as one SPMD program.  In a world of one every collective is the
identity and the steps are the unsharded ones to the bit.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vit_prisma_tpu_torch.parallel.collectives import SINGLE, Axis, ShardAxes

MESH_DIMS = ("data", "model")


# ---------------------------------------------------------------------------
# The process group and the mesh
# ---------------------------------------------------------------------------

def distributed_init(backend: Optional[str] = None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout: Optional[timedelta] = None) -> bool:
    """Initialize ``torch.distributed`` for a multi-process run: from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) or from ``init_method`` with ``rank`` and
    ``world_size``.  ``backend`` defaults to NCCL on a card and gloo on the
    CPU.  A no-op when a group is already up or when the process is alone
    (no ``init_method`` and no ``WORLD_SIZE`` above 1).  Returns True when a
    multi-process group is active."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and env_world <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {} if timeout is None else {"timeout": timeout}
    if init_method is None:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, **kwargs)
    if backend == "nccl" and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank()))
                              % torch.cuda.device_count())
    return dist.get_world_size() > 1


def _ensure_group(device_type: str):
    """A process group for the mesh: the one up, or, for a world of one, a
    group of this process alone (NCCL on a card, gloo on the CPU)."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _device_type(device) -> str:
    if device is None:
        from vit_prisma_tpu_torch.utils.device import resolve_device
        device = resolve_device()
    return torch.device(device).type


def make_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` ``DeviceMesh`` over the world's ranks, ranks
    row-major (a model group is ``model`` consecutive ranks, as JAX's
    ``reshape(data, model)``), on the CUDA card unless ``device`` says
    ``"cpu"``.  A world of one (``make_mesh(1, 1)``) needs no
    :func:`distributed_init`: its group is made here."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = _device_type(device)
    _ensure_group(device_type)
    n = dist.get_world_size()
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks; the world "
                         f"has {n}")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=MESH_DIMS)


# ---------------------------------------------------------------------------
# Multi-host meshes
# ---------------------------------------------------------------------------

def _host_id(rank_info) -> Any:
    """The host of a rank: its ``host`` attribute (a stand-in's), else its
    ``node``, else 0."""
    for attr in ("host", "node"):
        h = getattr(rank_info, attr, None)
        if h is not None:
            return h
    return 0


def multislice_device_array(devices, model: int) -> np.ndarray:
    """Order ranks (objects with a ``host``, the JAX package's slice) into a
    ``(data, model)`` array whose ``model`` rows never cross a host: the
    tensor-parallel collectives of every layer stay inside a host, and only
    the data axis (one gradient reduction a step) crosses hosts, its ranks
    host-major.  Raises ``ValueError`` for uneven hosts or a ``model`` that
    does not divide one host's ranks."""
    groups: Dict[Any, list] = {}
    for d in devices:
        groups.setdefault(_host_id(d), []).append(d)
    hosts = [groups[k] for k in sorted(groups)]
    per = len(hosts[0])
    if any(len(h) != per for h in hosts):
        raise ValueError(f"uneven hosts: {[len(h) for h in hosts]} ranks per host")
    if per % model:
        raise ValueError(f"model={model} must divide the {per} ranks of one host "
                         "(the model axis may not cross a host)")
    arr = np.empty(len(hosts) * per, dtype=object)
    for i, d in enumerate(d for h in hosts for d in h):  # items may be tuples
        arr[i] = d
    return arr.reshape(len(hosts) * (per // model), model)


class _Rank(NamedTuple):
    rank: int
    host: str


def make_multislice_mesh(model: int = 1, device=None):
    """A host-aware ``(data, model)`` mesh over the world: each rank's host
    name is gathered and :func:`multislice_device_array` orders the ranks.
    On one host it is :func:`make_mesh` ``(world // model, model)``."""
    from torch.distributed.device_mesh import DeviceMesh
    device_type = _device_type(device)
    _ensure_group(device_type)
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    arr = multislice_device_array([_Rank(r, h) for r, h in enumerate(hosts)], model)
    ranks = torch.tensor([[r.rank for r in row] for row in arr], dtype=torch.int64)
    return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_DIMS)


def axis(mesh, name: str) -> Axis:
    """The mesh axis ``name`` as this rank sees it (:class:`Axis`)."""
    if mesh is None:
        return SINGLE
    size = mesh.size(MESH_DIMS.index(name))
    if size == 1:
        return SINGLE
    return Axis(mesh.get_group(name), size, mesh.get_local_rank(name))


# ---------------------------------------------------------------------------
# Placements and plans
# ---------------------------------------------------------------------------

class Placement(NamedTuple):
    """A tensor's layout on a mesh: ``spec[i]`` names the mesh axis tensor
    dimension ``i`` is split on (None: whole; dimensions past the spec are
    whole), as JAX's ``NamedSharding(mesh, P(*spec))``."""
    mesh: Any
    spec: Tuple[Optional[str], ...] = ()


def replicated(mesh) -> Placement:
    return Placement(mesh, ())


def batch_sharding(mesh) -> Placement:
    """Rows over ``data``."""
    return Placement(mesh, ("data",))


def sweep_batch_sharding(mesh) -> Placement:
    """``[B, L, d_in]``: rows over ``data``, layers over ``model``."""
    return Placement(mesh, ("data", "model"))


def shard_tensor(t: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` (a new contiguous tensor
    where it is cut)."""
    out = t
    for dim, name in enumerate(placement.spec):
        if name is not None:
            out = axis(placement.mesh, name).slice(out, dim)
    return out if out is t else out.contiguous().clone()


def unshard_tensor(t: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The whole tensor from every rank's shard (a collective)."""
    for dim, name in reversed(list(enumerate(placement.spec))):
        if name is not None:
            t = axis(placement.mesh, name).all_gather(t, dim)
    return t


def _map_tree(fn, tree, plan):
    if isinstance(tree, torch.Tensor):
        return fn(tree, plan)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, plan[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v, p) for v, p in zip(tree, plan)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v, p) for v, p in zip(tree, plan))
    return tree


def shard_tree(tree, plan):
    """Every tensor of a whole tree (a train state) cut to this rank's
    shard by the plan of the same structure."""
    return _map_tree(shard_tensor, tree, plan)


def gather_tree(tree, plan):
    """The whole tree from this rank's shards (a collective on every
    rank)."""
    return _map_tree(unshard_tensor, tree, plan)


def vit_param_shardings(mesh, model) -> Dict[str, Placement]:
    """The tensor-parallel plan of a ``HookedViT`` by parameter name:
    attention heads over ``model`` where they divide it, ``d_mlp`` over
    ``model`` where it divides and the activation is elementwise, the rest
    whole."""
    cfg = model.cfg
    mp = mesh.size(MESH_DIMS.index("model"))
    heads = cfg.n_heads % mp == 0
    mlp = cfg.d_mlp % mp == 0 and not cfg.activation_name.endswith("_ln")
    plan = {}
    for name, _ in model.named_parameters():
        leaf = name.split(".")[-1]
        spec: Tuple[Optional[str], ...] = ()
        if ".attn." in name and heads and leaf in ("W_Q", "W_K", "W_V", "W_O", "b_Q",
                                                   "b_K", "b_V"):
            spec = ("model",)
        elif ".mlp." in name and mlp and ".mlp.ln." not in name:
            if leaf == "W_in":
                spec = (None, "model")
            elif leaf in ("b_in", "W_out"):
                spec = ("model",)
        plan[name] = Placement(mesh, spec)
    return plan


def shard_vit_(model, mesh):
    """Cut a ``HookedViT``'s parameters to this rank's heads and ``d_mlp``
    columns in place (:func:`vit_param_shardings`) and give each sharded
    block's ``attn`` and ``mlp`` the ``model`` axis (``.tp``), which the
    layer functions read."""
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is already sharded")
    plan = vit_param_shardings(mesh, model)
    tp = axis(mesh, "model")
    for name, p in model.named_parameters():
        p.data = shard_tensor(p.data, plan[name])
    for b in model.blocks:
        b.attn.tp = tp if plan[f"blocks.0.attn.W_Q"].spec else None
        if hasattr(b, "mlp"):
            b.mlp.tp = tp if plan["blocks.0.mlp.W_in"].spec else None
    model.mesh = mesh
    return model


def data_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch (rows over ``data``, in rank
    order)."""
    return shard_tensor(x, batch_sharding(mesh))


def shard_vit_forward(model, mesh, names_filter=None, stop_at_layer: Optional[int] = None):
    """The ViT forward with this rank's rows of the batch and the model
    tensor-parallel over ``model`` (the model is sharded in place by
    ``HookedViT.shard`` first when it is not).  Returns ``fn(images)``:
    the output for ``images`` (this rank's rows, :func:`data_rows`), and
    with ``names_filter`` also the cache dict, whose head- and
    ``d_mlp``-indexed entries are whole."""
    if getattr(model, "mesh", None) is None:
        model.shard(mesh)
    elif model.mesh is not mesh:
        raise ValueError("the model is sharded on another mesh")

    def fn(images):
        if names_filter is None:
            return model(images, stop_at_layer=stop_at_layer)
        return model.run_with_cache(images, names_filter=names_filter,
                                    stop_at_layer=stop_at_layer, return_cache_object=False)

    return fn


# -- SAE plans -----------------------------------------------------------------

def sae_param_shardings(mesh, params: Dict[str, Any]) -> Dict[str, Placement]:
    """The feature-parallel plan of a single SAE: ``W_enc`` columns,
    ``W_dec`` rows and the feature biases over ``model``; ``b_dec``,
    ``b_dec_out`` and ``W_skip`` whole."""
    spec = {}
    for k in params:
        if k == "W_enc":
            spec[k] = Placement(mesh, (None, "model"))
        elif k in ("W_dec", "b_enc", "b_gate", "r_mag", "b_mag"):
            spec[k] = Placement(mesh, ("model",))
        else:
            spec[k] = replicated(mesh)
    return spec


def sae_state_shardings(mesh, state):
    """The plan of a single SAE's train state: parameters and both Adam
    moments by :func:`sae_param_shardings`, the per-feature counters over
    ``model``, the scalars whole."""
    from vit_prisma_tpu_torch.ops.opt_step import ScaleByAdamState, ScaleByScheduleState
    from vit_prisma_tpu_torch.sae.train import SAETrainState
    p = sae_param_shardings(mesh, state.params)
    rep, feat = replicated(mesh), Placement(mesh, ("model",))
    return SAETrainState(
        params=p, opt_state=(ScaleByAdamState(count=rep, mu=dict(p), nu=dict(p)),
                             ScaleByScheduleState(count=rep)),
        act_freq_scores=feat, n_forward_passes_since_fired=feat,
        n_frac_active_tokens=rep, step=rep, n_training_tokens=rep)


def sweep_state_shardings(mesh, state):
    """The plan of a stacked sweep state: every leaf's layer axis over
    ``model`` (the SAEs are independent: the layer axis needs no
    collective)."""
    from vit_prisma_tpu_torch.sae.train import _map_state
    lay = Placement(mesh, ("model",))
    return _map_state(lambda _: lay, state)


# ---------------------------------------------------------------------------
# Sharded SAE steps
# ---------------------------------------------------------------------------

def _single_fused(cfg, mesh, n_rows: int) -> bool:
    """The single SAE takes the fused kernels per shard (TopK and gated,
    as unsharded) when its features are whole on each rank."""
    from vit_prisma_tpu_torch.sae.train import _fused_single_ok
    return axis(mesh, "model").size == 1 and _fused_single_ok(cfg, n_rows)


def _check_rows(cfg, mesh):
    dp = axis(mesh, "data").size
    if cfg.train_batch_size % dp:
        raise ValueError(f"train_batch_size({cfg.train_batch_size}) must divide over "
                         f"data={dp}")
    return cfg.train_batch_size // dp


def shard_sae_train_step(cfg, mesh, state):
    """The single-SAE step, rows over ``data`` and features over ``model``
    (dp x tp).  Returns ``(place_state, step_fn)``: ``place_state`` cuts a
    whole train state to this rank's shard (:func:`sae_state_shardings`);
    ``step_fn(local_state, local_batch[, target])`` takes this rank's rows
    (:func:`data_rows`) and returns its new shard and the global metrics.

    The generic step inserts the collectives every reduction over features
    or rows needs (``sae/sae.py``, ``sae/train.py``), TopK selects the
    global k-th value with B10 over the gathered candidates, and the clip's
    sum of squares is summed over ``model`` before B7.  A TopK or gated SAE
    whose features stay whole (``model`` = 1) takes the fused kernels on
    its rows (B8/B9, B11/B12 with B7), as unsharded: the kernels stay on
    under the mesh."""
    from vit_prisma_tpu_torch.sae.train import (_map_state, _sae_train_step_fused,
                                                _sae_train_step_impl, StepMetrics)
    plan = sae_state_shardings(mesh, state)
    local_rows = _check_rows(cfg, mesh)
    axes = ShardAxes(axis(mesh, "data"), axis(mesh, "model"))
    fused = _single_fused(cfg, mesh, local_rows)

    def step(local_state, batch, target=None):
        if fused and target is None:
            new1, m1 = _sae_train_step_fused(_map_state(lambda a: a[None], local_state),
                                             batch[None], cfg, axes.data)
            return _map_state(lambda a: a[0], new1), StepMetrics(*(f[0] for f in m1))
        return _sae_train_step_impl(local_state, batch, cfg, target, axes)

    return (lambda s: shard_tree(s, plan)), step


def shard_sae_train_multistep(cfg, mesh, state):
    """K steps of :func:`shard_sae_train_step` over ``batches`` ``[K, b,
    d_in]`` (this rank's rows of each batch), the window resets after each;
    metrics stacked ``[K]``."""
    from vit_prisma_tpu_torch.sae.train import _apply_window_reset, _stack_metrics
    _, step = shard_sae_train_step(cfg, mesh, state)

    def steps(local_state, batches, targets=None):
        per = []
        for i, b in enumerate(batches):
            local_state, m = step(local_state, b, None if targets is None else targets[i])
            local_state = _apply_window_reset(local_state, cfg)
            per.append(m)
        return local_state, _stack_metrics(per)

    return steps


def _sweep_fused(cfg, mesh, state) -> bool:
    """The JAX package's ``_sweep_fused_shard_map`` gate: the fused kernels
    per shard when the layers and rows divide and the per-shard shapes pass
    :func:`_fused_step_ok` (a single layer a shard allowed)."""
    from vit_prisma_tpu_torch.sae.train import _fused_step_ok
    dp, mp = axis(mesh, "data").size, axis(mesh, "model").size
    L = int(state.step.shape[0])
    B = cfg.train_batch_size
    if L % mp or B % dp:
        return False
    return _fused_step_ok(cfg, B // dp, L // mp, allow_single_layer=True)


def shard_sae_sweep_step(cfg, mesh, state):
    """The all-layer sweep step, layers over ``model`` and rows over
    ``data``.  Returns ``(place_state, step_fn)``; ``step_fn(local_state,
    batch)`` takes this rank's ``[b, L / model, d_in]`` block
    (:func:`sweep_batch_sharding`) and returns its new shard and the
    metrics of all layers ``[L]`` (gathered over ``model``).  The fused
    kernels (B4 and B6 or B5; TopK B8 and B6 or B9; gated B11 and B12; B7)
    run on each shard where :func:`_sweep_fused` admits it, else the generic
    step per layer with the same collectives over ``data``."""
    from vit_prisma_tpu_torch.sae.train import (StepMetrics, _map_state, _sae_train_step_fused,
                                                _sae_train_step_impl, _stack_metrics)
    plan = sweep_state_shardings(mesh, state)
    L = int(state.step.shape[0])
    if L % axis(mesh, "model").size:
        raise ValueError(f"{L} sweep layers do not divide over model="
                         f"{axis(mesh, 'model').size}")
    _check_rows(cfg, mesh)
    data, model = axis(mesh, "data"), axis(mesh, "model")
    fused = _sweep_fused(cfg, mesh, state)
    axes = ShardAxes(data, SINGLE)

    def local_step(local_state, x):  # x [L_local, b, d]
        if fused:
            return _sae_train_step_fused(local_state, x.contiguous(), cfg, data)
        outs = [_sae_train_step_impl(_map_state(lambda a, l=l: a[l], local_state), x[l], cfg,
                                     axes=axes) for l in range(x.shape[0])]
        return (_map_state(lambda *xs: torch.stack(xs), *(s for s, _ in outs)),
                _stack_metrics(m for _, m in outs))

    def gather_metrics(m):
        stacked = torch.stack([f.float() for f in m])  # [fields, L_local]
        whole = model.all_gather(stacked, dim=1)
        return StepMetrics(*(whole[i].to(f.dtype) for i, f in enumerate(m)))

    def step(local_state, batch):
        new, m = local_step(local_state, batch.transpose(0, 1))
        return new, gather_metrics(m)

    step.local_step = local_step
    return (lambda s: shard_tree(s, plan)), step


def shard_sae_sweep_multistep(cfg, mesh, state):
    """K steps of :func:`shard_sae_sweep_step` over ``batches`` ``[K, b,
    L / model, d_in]``, the ``[K, b, L, d] -> [K, L, b, d]`` transpose made
    once for the K steps and the window resets after each; metrics ``[K,
    L]``."""
    from vit_prisma_tpu_torch.sae.train import _apply_window_reset, _stack_metrics
    _, step = shard_sae_sweep_step(cfg, mesh, state)

    def steps(local_state, batches):
        xs = batches.transpose(1, 2).contiguous()
        per = []
        for x in xs:
            local_state, m = step.local_step(local_state, x)
            local_state = _apply_window_reset(local_state, cfg)
            per.append(m)
        stacked = _stack_metrics(per)  # [K, L_local] fields
        return local_state, type(stacked)(*(
            axis(mesh, "model").all_gather(f, dim=1) for f in stacked))

    return steps
