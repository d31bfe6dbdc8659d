"""The port's supervised trainer against the JAX package's: train steps
(AdamW and SGD, float32, dropout 0), both schedules, the batch order,
``train()`` end to end with checkpoints and resume, dropout by its
statistics, and the numpy-only dataset copy.  The same numpy inputs and
weights go through both.

Tolerances: losses and parameters after 3 steps within 1e-5 (float32
gradients differ in summation order only; AdamW's update divides them by
their running scale, which keeps those differences relative); schedules
within 1e-6 (JAX's float32 against Python floats)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, jax_and_port, seeded
from vit_prisma_tpu.dataloaders import imagenet as jax_imagenet
from vit_prisma_tpu.dataloaders import synthetic as jax_synth
from vit_prisma_tpu.training import trainer as jax_trainer
from vit_prisma_tpu_torch import HookedViT, ViTConfig, vit_forward
from vit_prisma_tpu_torch.dataloaders import synthetic as port_synth
from vit_prisma_tpu_torch.models.layers import dropout
from vit_prisma_tpu_torch.models.loading.state_dict import params_from_jax, port_state_dict
from vit_prisma_tpu_torch.training import trainer as port_trainer

CFG = dict(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64,
           patch_size=8, image_size=16, n_classes=7, return_type="logits")
TOL = 1e-5


def _batch(i):
    return (seeded(10 + i, (4, 3, 16, 16)),
            np.random.default_rng(i).integers(0, 7, 4).astype(np.int64))


@pytest.mark.parametrize("optimizer", ["AdamW", "SGD"])
def test_train_steps_match_jax(optimizer):
    jax_model, port = jax_and_port(**CFG)
    fields = dict(optimizer_name=optimizer, lr=1e-3, weight_decay=0.05, warmup_steps=2)
    jt, pt = jax_trainer.TrainerConfig(**fields), port_trainer.TrainerConfig(**fields)
    jopt = jax_trainer._make_optimizer(jt, 100)
    jstate = jax_trainer.TrainState(jax_model.params, jopt.init(jax_model.params),
                                    jnp.zeros((), jnp.int32))
    jstep = jax_trainer.make_train_step(jax_model.cfg, jopt, "CrossEntropy")
    popt, psched = port_trainer._make_optimizer(pt, 100, port.parameters())
    pstate = port_trainer.TrainState(port, popt, psched)
    pstep = port_trainer.make_train_step(port.cfg, "CrossEntropy")
    for i in range(3):
        x, y = _batch(i)
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        pstate, ploss = pstep(pstate, torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(jloss) - float(ploss)) <= TOL, i
    assert pstate.step == int(jstate.step) == 3
    want = port_state_dict(params_from_jax(jax.tree.map(np.asarray, jstate.params)), port.cfg)
    got = port.state_dict()
    assert set(got) == set(want)
    moved = 0.0
    for k, v in got.items():
        if optimizer == "AdamW" and k.endswith("attn.b_K"):
            # b_K shifts each row of scores by a constant, which the softmax
            # ignores: its exact gradient is 0, so the float one is rounding
            # noise, which Adam scales up to +-lr per step on either side.
            assert (v - port_init(k)).abs().max().item() <= 3 * fields["lr"]
            continue
        assert_close(want[k].numpy(), v, TOL, k)
        moved = max(moved, (v - port_init(k)).abs().max().item())
    assert moved > 1e-4  # the steps did move the parameters


_INIT = {}


def port_init(key):
    """The port's parameters before training, from the same JAX init."""
    if not _INIT:
        _, fresh = jax_and_port(**CFG)
        _INIT.update(fresh.state_dict())
    return _INIT[key]


@pytest.mark.parametrize("kind", ["WarmupThenStep", "CosineAnnealing"])
def test_schedules_match_jax(kind):
    if kind == "WarmupThenStep":
        want = jax_trainer.warmup_then_step_schedule(5, 7, 0.8)
        got = port_trainer.warmup_then_step_schedule(5, 7, 0.8)
    else:
        want = jax_trainer.warmup_cosine_schedule(5, 30)
        got = port_trainer.warmup_cosine_schedule(5, 30)
    for step in range(41):
        assert abs(float(want(jnp.asarray(step))) - got(step)) <= 1e-6, step
    # the optimizer's learning rate follows lr * schedule(t), t from 0
    tcfg = port_trainer.TrainerConfig(lr=0.1, warmup_steps=5, scheduler_step=7,
                                      scheduler_gamma=0.8, scheduler_type=kind)
    opt, sched = port_trainer._make_optimizer(tcfg, 30, [torch.zeros(2, requires_grad=True)])
    for step in range(41):
        assert abs(opt.param_groups[0]["lr"] - 0.1 * got(step)) <= 1e-9, step
        opt.step()
        sched.step()


def test_batches_order_matches_jax():
    ds = port_synth.CircleDataset(p=5, im_size=16, radius=6)
    for shuffle in (True, False):
        want = list(jax_trainer._batches(ds, 4, np.random.default_rng(3), shuffle))
        got = list(port_trainer._batches(ds, 4, np.random.default_rng(3), shuffle))
        assert len(got) == len(want) == 25 // 4
        for (wi, wl), (gi, gl) in zip(want, got):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


class _Steps(port_trainer.PrismaCallback):
    def __init__(self):
        self.steps, self.epochs = [], []

    def on_step_end(self, step, model, metrics):
        self.steps.append(step)

    def on_epoch_end(self, epoch, model, metrics):
        self.epochs.append(epoch)


def test_train_learns_circle_checkpoints_and_resumes(tmp_path):
    ds = port_synth.CircleDataset(p=5, im_size=16, radius=6, n_channels=1)
    splits = port_synth.train_test_dataset(ds, test_split=0.2)
    cfg = ViTConfig(n_layers=2, d_model=32, d_head=8, n_heads=4, d_mlp=64,
                    patch_size=4, image_size=16, n_channels=1, n_classes=5,
                    return_type="logits")
    tcfg = port_trainer.TrainerConfig(
        lr=1e-3, batch_size=8, num_epochs=30, warmup_steps=5,
        scheduler_type="CosineAnnealing", log_frequency=10_000, max_steps=60,
        save_checkpoints=True, save_cp_frequency=30, parent_dir=str(tmp_path))
    build = lambda c: HookedViT(c, device="cpu", generator=torch.Generator().manual_seed(0))
    calls = _Steps()
    model = port_trainer.train(build, cfg, splits["train"], splits["test"],
                               tcfg=tcfg, callbacks=[calls])
    assert calls.steps == list(range(1, 61))
    images, labels = next(port_synth.numpy_batches(splits["train"], 16))

    def ce(m):
        return float(port_trainer.cross_entropy_loss(m(torch.from_numpy(images)),
                                                     torch.from_numpy(labels)))
    assert ce(model) < ce(build(cfg))
    path = tmp_path / "Checkpoints" / "model_480.ckpt"
    assert sorted(p.name for p in path.parent.iterdir()) == ["model_240.ckpt", "model_480.ckpt"]
    ckpt = port_trainer.load_checkpoint(str(path))
    assert set(ckpt) == {"params", "opt_state", "step", "epoch"} and ckpt["step"] == 60
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(ckpt["params"][k], v.numpy())

    # resume: the step count and the parameters carry over
    resumed_calls = _Steps()
    resumed = port_trainer.train(
        build, cfg, splits["train"], splits["test"],
        tcfg=dataclasses.replace(tcfg, num_epochs=40, max_steps=70, save_checkpoints=False),
        checkpoint_path=str(path), callbacks=[resumed_calls])
    assert resumed_calls.steps == list(range(61, 71))
    assert resumed_calls.epochs[0] == ckpt["epoch"] + 1
    moved = max((v - torch.from_numpy(ckpt["params"][k])).abs().max().item()
                for k, v in resumed.state_dict().items())
    assert 0 < moved < 0.1


def test_dropout_statistics_and_eval_mode():
    x = torch.ones(200_000)
    y = dropout(x, 0.25, torch.Generator().manual_seed(0))
    dropped = (y == 0).float().mean().item()
    assert abs(dropped - 0.25) < 0.005
    assert torch.all((y == 0) | (y == torch.tensor(1 / 0.75)))
    assert abs(y.mean().item() - 1.0) < 0.01
    assert dropout(x, 0.25, None) is x and dropout(x, 0.0, torch.Generator()) is x

    cfg = ViTConfig(**CFG, attn_dropout_rate=0.5, mlp_dropout_rate=0.5)
    model = HookedViT(cfg, device="cpu")
    images = torch.from_numpy(seeded(3, (2, 3, 16, 16)))
    with torch.no_grad():
        eval_out = vit_forward(model, cfg, images)
        run = lambda seed: vit_forward(model, cfg, images,
                                       dropout_key=torch.Generator().manual_seed(seed))
        assert torch.equal(eval_out, model(images))
        assert torch.equal(run(1), run(1)) and not torch.allclose(run(1), run(2))
        assert not torch.allclose(run(1), eval_out)
    # a train step draws its masks from (seed, step): reproducible
    losses = []
    for _ in range(2):
        m = HookedViT(cfg, device="cpu")
        opt, sched = port_trainer._make_optimizer(port_trainer.TrainerConfig(), 10,
                                                  m.parameters())
        state = port_trainer.TrainState(m, opt, sched)
        step = port_trainer.make_train_step(cfg, "CrossEntropy", seed=4)
        state, loss = step(state, images, torch.tensor([1, 2]))
        losses.append(float(loss))
    assert losses[0] == losses[1] and np.isfinite(losses[0])


def test_synthetic_copy_matches_jax():
    want, got = jax_synth.CircleDataset(p=7), port_synth.CircleDataset(p=7)
    np.testing.assert_array_equal(got.imgs, want.imgs)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.data_points, want.data_points)
    for name, kw in (("generate_induction_arrays", dict(padding=12)),
                     ("generate_polygenic_induction_arrays", dict(stride=16))):
        for w, g in zip(getattr(jax_synth, name)(**kw), getattr(port_synth, name)(**kw)):
            np.testing.assert_array_equal(g, w)
    jsplit = jax_synth.train_test_dataset(want, test_split=0.3, seed=2)
    psplit = port_synth.train_test_dataset(got, test_split=0.3, seed=2)
    for part in ("train", "test"):
        assert len(psplit[part]) == len(jsplit[part])
        wb = list(jax_imagenet.numpy_batches(jsplit[part], 5, shuffle=True, seed=1,
                                             with_indices=True))
        gb = list(port_synth.numpy_batches(psplit[part], 5, shuffle=True, seed=1,
                                           with_indices=True))
        assert len(gb) == len(wb)
        for w, g in zip(wb, gb):
            for a, b in zip(w, g):
                np.testing.assert_array_equal(b, a)
    image, label, idx = port_synth.IndexedDataset(got)[3]
    np.testing.assert_array_equal(image, want[3][0])
    assert (label, idx) == (want[3][1], 3)
