"""Spawned gloo worlds for the port's parallel tests.

``run_world(tmp_path, world, fn_name, payload)`` starts ``world`` processes
(``spawn``), each of which sets one torch thread, joins a gloo group through
a ``file://`` init method under ``tmp_path`` (xdist workers run side by side,
so no TCP port) with a timeout, and runs ``fn_name(rank, world, payload)``
from this module.  The parent waits with its own limit and kills a world
that hangs, so a fault fails its test instead of the suite's time limit.

This module and the bodies below import torch, numpy and the port, never
JAX or a test module that does.  Not collected by pytest (no ``test_``
prefix)."""

import os
import queue
import traceback
from datetime import timedelta

import torch

WORLD_TIMEOUT_S = 240


def run_world(tmp_path, world, fn_name, payload, timeout=WORLD_TIMEOUT_S):
    """Rank-ordered list of ``fn_name``'s return values, one a rank."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = os.path.join(str(tmp_path), f"init_{fn_name}_{world}")
    procs = [ctx.Process(target=_child, args=(r, world, init, fn_name, payload, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, ok, value = q.get(timeout=timeout)
            (results.__setitem__(rank, value) if ok else errors.append(f"rank {rank}:\n{value}"))
            if errors:
                break
    except queue.Empty:
        errors.append(f"the world of {world} did not finish within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


def _child(rank, world, init, fn_name, payload, q):
    try:
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=120))
        try:
            value = globals()[fn_name](rank, world, payload)
        finally:
            dist.destroy_process_group()
        q.put((rank, True, value))
    except BaseException:  # noqa: BLE001 - reported to the parent
        q.put((rank, False, traceback.format_exc()))


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_np_tree(v) for v in tree]
    return _np(tree)


# ---------------------------------------------------------------------------
# The tensor-parallel ViT
# ---------------------------------------------------------------------------

def vit_model(cfg_dict, state_dict):
    from vit_prisma_tpu_torch import HookedViT, ViTConfig
    m = HookedViT(ViTConfig.from_dict(cfg_dict), device="cpu")
    m.load_state_dict(state_dict)
    return m


HEAD_HOOKS = ("hook_q", "hook_k", "hook_v", "hook_z", "hook_attn_scores", "hook_pattern",
              "mlp.hook_pre", "mlp.hook_post", "hook_resid_post")


def vit_cases(model, images, data_axis=None):
    """The ViT cases of one model (sharded or whole) on ``images`` (this
    rank's rows); every output whole over ``data_axis``."""
    gather = (lambda t: t) if data_axis is None else (lambda t: data_axis.all_gather(t, 0))
    out = {}
    x = torch.from_numpy(images)
    out["logits"] = gather(model(x))
    out["stop1"] = gather(model(x, stop_at_layer=1))
    _, cache = model.run_with_cache(x, names_filter=lambda n: n.endswith(HEAD_HOOKS),
                                    return_cache_object=False)
    out["cache"] = {k: gather(v) for k, v in cache.items()}
    _, gcache = model.run_with_cache(
        x, names_filter=lambda n: n.endswith(("hook_resid_post", "hook_pattern", "hook_q",
                                              "mlp.hook_post")),
        incl_bwd=True, return_cache_object=False)
    out["grad_cache"] = {k: gather(v) for k, v in gcache.items()}

    def ablate_head1(v, hook):
        v = v.clone()
        v[:, 1] = 0.0
        return v

    out["edited"] = gather(model.run_with_hooks(
        x, fwd_hooks=[("blocks.0.attn.hook_pattern", ablate_head1),
                      ("blocks.1.mlp.hook_post", lambda v, hook: v * 0.5)]))
    return {k: _np_tree(v) for k, v in out.items()}


def vit_world(rank, world, payload):
    """Every mesh shape of the payload over this world: each model case
    sharded with ``HookedViT.shard`` (and through ``shard_vit_forward``)."""
    from vit_prisma_tpu_torch.parallel import data_rows, make_mesh, shard_vit_forward
    from vit_prisma_tpu_torch.parallel.mesh import axis
    res = {}
    for shape in payload["meshes"]:
        mesh = make_mesh(*shape, device="cpu")
        for name, (cfg, sd) in payload["models"].items():
            m = vit_model(cfg, sd).shard(mesh)
            x = data_rows(torch.from_numpy(payload["images"]), mesh).numpy()
            res[(shape, name)] = vit_cases(m, x, axis(mesh, "data"))
            res[(shape, name)]["n_heads_local"] = int(m.blocks[0].attn.W_Q.shape[0])
            res[(shape, name)]["d_mlp_local"] = int(m.blocks[0].mlp.W_in.shape[1])
        # shard_vit_forward on an unsharded model, plain and cached
        cfg, sd = payload["models"]["base"]
        fwd = shard_vit_forward(vit_model(cfg, sd), mesh,
                                names_filter="blocks.1.hook_resid_post")
        out, cache = fwd(data_rows(torch.from_numpy(payload["images"]), mesh))
        d = axis(mesh, "data")
        res[(shape, "shard_vit_forward")] = {
            "logits": _np(d.all_gather(out, 0)),
            "cache": {k: _np(d.all_gather(v, 0)) for k, v in cache.items()}}
    return res if rank == 0 else None


# ---------------------------------------------------------------------------
# Sharded SAE steps
# ---------------------------------------------------------------------------

def _state_from_np(flat):
    """A port train state from its ``_flatten_state`` dict of tensors."""
    from vit_prisma_tpu_torch.sae.train import _unflatten_state
    return _unflatten_state(flat)


def _flat_state(state):
    from vit_prisma_tpu_torch.sae.convert import train_state_to_numpy
    return train_state_to_numpy(state)


def sae_step_world(rank, world, payload):
    """Sharded single-SAE and sweep steps from whole numpy states on whole
    batches: each case names its mesh, config, state, batches and builder;
    returns the gathered state and metrics (rank 0)."""
    from vit_prisma_tpu_torch.parallel import mesh as M
    from vit_prisma_tpu_torch.sae.config import SAERunnerConfig
    res = {}
    for case in payload["cases"]:
        mesh = M.make_mesh(*case["mesh"], device="cpu")
        cfg = SAERunnerConfig(**case["cfg"])
        state = _state_from_np(case["state"])
        sweep = case["kind"].startswith("sweep")
        plan = (M.sweep_state_shardings if sweep else M.sae_state_shardings)(mesh, state)
        batches = torch.from_numpy(case["batches"])
        bplace = M.sweep_batch_sharding(mesh) if sweep else M.batch_sharding(mesh)
        if case["kind"].endswith("multistep"):
            steps = (M.shard_sae_sweep_multistep if sweep else M.shard_sae_train_multistep)(
                cfg, mesh, state)
            local = M.shard_tree(state, plan)
            xs = torch.stack([M.shard_tensor(b, bplace) for b in batches])
            local, metrics = steps(local, xs)
        else:
            place, step = (M.shard_sae_sweep_step if sweep else M.shard_sae_train_step)(
                cfg, mesh, state)
            local = place(state)
            for b in batches:
                local, metrics = step(local, M.shard_tensor(b, bplace))
        whole = M.gather_tree(local, plan)
        res[case["name"]] = {"state": _flat_state(whole),
                             "metrics": {f: _np(v) for f, v in metrics._asdict().items()},
                             "local_W_enc": tuple(local.params["W_enc"].shape)}
    return res if rank == 0 else None


# ---------------------------------------------------------------------------
# Store + trainer through the public mesh= arguments
# ---------------------------------------------------------------------------

def public_run(vit_cfg, vit_sd, sae_fields, images, mesh, steps, sweep=False, cycles=0,
               multistep_k=0):
    """A store and a trainer through the public ``mesh=`` arguments (or
    none): the trainer's whole state after ``run(max_steps=steps)`` (then
    ``train_steps`` and ``train_cycles`` when asked), the first batch each
    rank served, and the store's peek."""
    from vit_prisma_tpu_torch.sae import (SAERunnerConfig, SAESweepTrainer,
                                          VisionActivationsStore, VisionSAETrainer)
    cfg = SAERunnerConfig(**sae_fields)
    model = vit_model(vit_cfg, vit_sd)
    store = VisionActivationsStore(cfg, model, images, mesh=mesh)
    first = store.peek_tokens(cfg.train_batch_size)
    trainer = (SAESweepTrainer if sweep else VisionSAETrainer)(cfg, model=model, store=store)
    trainer.run(max_steps=steps)
    if multistep_k:
        trainer.train_steps(store.next_batches(multistep_k))
    if cycles:
        trainer.train_cycles(cycles)
    whole = trainer.whole_state()
    return {"state": _flat_state(whole), "peek": _np(first),
            "step": int(whole.step.reshape(-1)[0]), "buffer_local": tuple(store.buffer.shape)}


def public_world(rank, world, payload):
    from vit_prisma_tpu_torch.parallel import make_mesh
    res = {}
    for case in payload["cases"]:
        mesh = make_mesh(*case["mesh"], device="cpu")
        res[case["name"]] = public_run(payload["vit_cfg"], payload["vit_sd"], case["sae"],
                                       payload["images"], mesh, case["steps"],
                                       sweep=case.get("sweep", False),
                                       cycles=case.get("cycles", 0),
                                       multistep_k=case.get("multistep_k", 0))
    return res if rank == 0 else None


# ---------------------------------------------------------------------------
# Sharded train-state checkpoints
# ---------------------------------------------------------------------------

def checkpoint_world(rank, world, payload):
    """Save a sharded state at each of the payload's meshes (round trip to
    the bit), and load earlier saves into this world's meshes."""
    from vit_prisma_tpu_torch.parallel import mesh as M
    from vit_prisma_tpu_torch.sae.config import SAERunnerConfig
    from vit_prisma_tpu_torch.sae.train import (load_train_state_sharded,
                                                save_train_state_sharded)
    res = {}
    for case in payload.get("save", []):
        mesh = M.make_mesh(*case["mesh"], device="cpu")
        cfg = SAERunnerConfig(**case["cfg"])
        state = _state_from_np(case["state"])
        plan = (M.sweep_state_shardings if cfg.sweep_layers else M.sae_state_shardings)(
            mesh, state)
        local = M.shard_tree(state, plan)
        save_train_state_sharded(case["path"], local, cfg, mesh=mesh)
        back, cfg2 = load_train_state_sharded(case["path"], mesh=mesh)
        same = all(torch.equal(a, b) and a.dtype == b.dtype for a, b in
                   zip(_leaves(back), _leaves(local)))
        res[("roundtrip", case["name"])] = (same, cfg2.to_dict() == cfg.to_dict())
    for case in payload.get("load", []):
        mesh = M.make_mesh(*case["mesh"], device="cpu")
        local, cfg = load_train_state_sharded(case["path"], mesh=mesh)
        plan = (M.sweep_state_shardings if cfg.sweep_layers else M.sae_state_shardings)(
            mesh, local)
        res[("load", case["name"])] = _flat_state(M.gather_tree(local, plan))
    return res if rank == 0 else None


def _leaves(state):
    from vit_prisma_tpu_torch.sae.train import _flatten_state
    return [v for _, v in sorted(_flatten_state(state).items())]


def multi_world(rank, world, payload):
    """Several bodies in one world, in order: ``payload`` is a list of
    ``(fn_name, sub_payload)``; returns ``{fn_name: result}``, the results
    of a body named twice merged."""
    out = {}
    for name, sub in payload:
        value = globals()[name](rank, world, sub)
        if value is not None:
            out.setdefault(name, {}).update(value)
    return out if rank == 0 else None
