"""Sparse autoencoders (PyTorch port of ``vit_prisma_tpu/sae/sae.py``).

The standard SAE with a ReLU, tanh-ReLU or TopK activation: ``encode``,
``decode`` and ``sae_forward`` with the normalized MSE and the Lp sparsity
loss (none for TopK), the decoder unit-norm projection and the removal of
the gradient parallel to the decoder rows, over a plain dict of tensors
(``W_enc`` ``[d_in, d_sae]``, ``W_dec`` ``[d_sae, d_in]``, ``b_enc``,
``b_dec``), with the JAX package's layouts and cast points.

The gated SAE (``architecture="gated"``) adds ``b_gate``, ``r_mag`` and
``b_mag`` (its ``b_enc`` is kept, as in the JAX package, and read by no
loss): the gate ``sae_in W_enc + b_gate`` picks the active features, the
magnitude ``sae_in (W_enc exp(r_mag)) + b_mag`` sets their values, and the
loss adds the decoder-norm-weighted gate L1 and the aux reconstruction of
the gate path to the MSE.  :class:`SparseAutoencoder` is an ``nn.Module``
holding the parameters.

TopK keeps each row's k largest pre-activations (ReLU'd): with
``cfg.fused_topk`` (the default) through the threshold mask of
``ops/topk.py`` (kernel B10 on the card; ties at the k-th value keep every
tied entry), else through :func:`topk_activation` (exactly k).
``topk_use_approx`` takes :func:`topk_activation` too: the JAX package's
approximate select (``lax.approx_max_k``) runs on the TPU alone, and off the
TPU it returns the exact top k, as here.

The transcoder (``architecture="transcoder"``) maps the input hook's rows
to the output hook's: ``W_dec`` is ``[d_sae, d_out]``, its bias
``b_dec_out``, and ``W_skip`` ``[d_in, d_in]`` (with
``transcoder_with_skip_connection``) adds ``x W_skip^T`` to the output; the
MSE is taken against the target ``y``.  ``normalize_activations``
(``constant_norm_rescale``: rows scaled to norm sqrt(d_in);
``layer_norm``: centred and divided by their std + 1e-5) normalizes the
input before the encoder and undoes it on the output.  Ghost grads
(``use_ghost_grads``) add, in training, the reference's resurrection loss
for the features that ``dead_neuron_mask`` marks, as a multiplicative mask.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from vit_prisma_tpu_torch.ops.topk import topk_mask_activation
from vit_prisma_tpu_torch.prisma.hooks import NULL_HOOKS, HookRuntime
from vit_prisma_tpu_torch.sae.config import SAERunnerConfig
from vit_prisma_tpu_torch.utils.device import resolve_device

Params = Dict[str, torch.Tensor]


class SAEOutput(NamedTuple):
    sae_out: torch.Tensor
    feature_acts: torch.Tensor
    loss: torch.Tensor
    mse_loss: torch.Tensor
    l1_loss: Optional[torch.Tensor]
    ghost_grad_loss: torch.Tensor
    aux_reconstruction_loss: torch.Tensor


def topk_activation(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest entries of each row (ReLU'd), zero elsewhere:
    exactly k, as the JAX package's ``lax.top_k`` + scatter."""
    vals, idx = torch.topk(x, k, dim=-1)
    return torch.zeros_like(x).scatter(-1, idx, torch.relu(vals))


def get_activation_fn(cfg: SAERunnerConfig):
    name = cfg.activation_fn_str
    if name == "relu":
        return torch.relu
    if name == "tanh-relu":
        return lambda x: torch.tanh(torch.relu(x))
    if name == "topk":
        k = cfg.topk_k
        if cfg.fused_topk and not cfg.topk_use_approx:
            return lambda x: topk_mask_activation(x, k)
        return lambda x: topk_activation(x, k)
    raise ValueError(f"Unknown activation function: {name}")


# ---------------------------------------------------------------------------
# Runtime activation normalization
# ---------------------------------------------------------------------------

def norm_in(cfg: SAERunnerConfig, x: torch.Tensor):
    """Returns (normalized x, the context that :func:`norm_out` undoes)."""
    if cfg.normalize_activations == "constant_norm_rescale":
        coeff = (cfg.d_in ** 0.5) / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x * coeff, ("rescale", coeff)
    if cfg.normalize_activations == "layer_norm":
        mu = x.mean(dim=-1, keepdim=True)
        xc = x - mu
        std = xc.std(dim=-1, keepdim=True, correction=1)
        return xc / (std + 1e-5), ("ln", (mu, std))
    return x, ("none", None)


def norm_out(ctx, y: torch.Tensor) -> torch.Tensor:
    kind, data = ctx
    if kind == "rescale":
        return y / data
    if kind == "ln":
        mu, std = data
        return y * std + mu
    return y


# ---------------------------------------------------------------------------
# Initialization (Kaiming-uniform + unit rows)
# ---------------------------------------------------------------------------

def _kaiming_uniform(generator, shape, dtype):
    # torch kaiming_uniform_(a=sqrt(5)): gain sqrt(1/3), bound gain*sqrt(3/fan_in)
    bound = math.sqrt(1.0 / 3.0) * math.sqrt(3.0 / shape[-1])
    return (torch.rand(shape, generator=generator) * (2 * bound) - bound).to(dtype)


def _unit_rows(W: torch.Tensor) -> torch.Tensor:
    return W / torch.linalg.norm(W, dim=-1, keepdim=True)


def init_sae_params(cfg: SAERunnerConfig,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> Params:
    """The JAX package's init scheme, drawn from ``generator`` on the CPU
    (seeded with ``cfg.seed`` when None) and moved to ``device`` (the CUDA
    card when None); the numbers differ from the JAX init's.  Standard: a
    unit-row Kaiming-uniform decoder, the encoder independent or tied to the
    decoder's transpose, zero biases.  Gated: Kaiming-uniform ``W_enc`` and
    ``W_dec`` without unit rows, zero ``b_gate``, ``r_mag``, ``b_mag``,
    ``b_enc`` and ``b_dec``.  Transcoder: the standard SAE's unit rows with
    ``W_dec`` ``[d_sae, d_out]``, zero ``b_dec_out`` and, with the skip
    connection, a unit-row Kaiming-uniform ``W_skip`` ``[d_in, d_in]``."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
    dt = cfg.torch_dtype
    d_in, d_sae = cfg.d_in, cfg.d_sae
    W_enc_draw = _kaiming_uniform(g, (d_in, d_sae), dt)
    if cfg.architecture == "gated":
        zeros = lambda n: torch.zeros(n, dtype=dt)
        params = {"W_enc": W_enc_draw, "W_dec": _kaiming_uniform(g, (d_sae, d_in), dt),
                  "b_gate": zeros(d_sae), "r_mag": zeros(d_sae), "b_mag": zeros(d_sae),
                  "b_enc": zeros(d_sae), "b_dec": zeros(d_in)}
        return {k: v.to(device) for k, v in params.items()}
    if cfg.architecture == "transcoder":
        params = {"W_enc": _unit_rows(W_enc_draw.T).T.contiguous(),
                  "W_dec": _unit_rows(_kaiming_uniform(g, (d_sae, cfg.d_out), dt)),
                  "b_enc": torch.zeros(d_sae, dtype=dt), "b_dec": torch.zeros(d_in, dtype=dt),
                  "b_dec_out": torch.zeros(cfg.d_out, dtype=dt)}
        if cfg.transcoder_with_skip_connection:
            params["W_skip"] = _unit_rows(_kaiming_uniform(g, (d_in, d_in), dt))
        return {k: v.to(device) for k, v in params.items()}
    W_dec = _unit_rows(_kaiming_uniform(g, (d_sae, d_in), dt))
    if cfg.initialization_method == "encoder_transpose_decoder":
        W_enc = W_dec.T.contiguous()
    elif cfg.initialization_method == "independent":
        W_enc = _unit_rows(W_enc_draw.T).T.contiguous()
    else:
        raise ValueError(f"Unknown initialization method: {cfg.initialization_method}")
    params = {"W_enc": W_enc, "W_dec": W_dec,
              "b_enc": torch.zeros(d_sae, dtype=dt),
              "b_dec": torch.zeros(d_in, dtype=dt)}
    return {k: v.to(device) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _mse_loss(x: torch.Tensor, sae_out: torch.Tensor) -> torch.Tensor:
    """Normalized MSE: elementwise MSE scaled by 1/||x - x̄||₂ per row.
    Reductions accumulate in float32; under a bf16 compute dtype the
    elementwise ops stay bf16, as in the JAX package."""
    x = x.detach()
    x_centred = x - x.mean(dim=0, keepdim=True)
    mse = torch.square(sae_out - x)
    norm_factor = torch.sqrt(torch.square(x_centred).sum(
        dim=-1, keepdim=True, dtype=torch.float32)).to(x.dtype)
    return (mse / norm_factor).mean(dtype=torch.float32)


def _ghost_residual_loss(params: Params, x: torch.Tensor, sae_out: torch.Tensor,
                         hidden_pre: torch.Tensor, dead_neuron_mask: torch.Tensor
                         ) -> torch.Tensor:
    """The ghost-grads resurrection loss: the dead features' ``exp`` of
    their pre-activations, decoded and scaled to half the residual's norm,
    fit to the residual, rescaled to the MSE.  The reference gathers the
    dead columns; the JAX package multiplies by the mask (the same math,
    static shapes), and so does this."""
    residual = x - sae_out
    residual_centred = residual - residual.mean(dim=0, keepdim=True)
    l2_norm_residual = torch.linalg.vector_norm(residual, dim=-1)
    mask = dead_neuron_mask.to(hidden_pre.dtype)
    ghost_out = (torch.exp(hidden_pre) * mask) @ params["W_dec"]
    l2_norm_ghost_out = torch.linalg.vector_norm(ghost_out, dim=-1)
    norm_scaling = l2_norm_residual / (1e-6 + l2_norm_ghost_out * 2)
    ghost_out = ghost_out * norm_scaling.detach()[:, None]
    mse_ghost = torch.square(ghost_out - residual.detach()) / torch.sqrt(
        torch.sum(residual_centred.detach() ** 2, dim=-1, keepdim=True))
    rescale = (_mse_loss(x, sae_out) / (mse_ghost + 1e-6)).detach()
    return (rescale * mse_ghost).mean()


# ---------------------------------------------------------------------------
# Encode / decode / forward
# ---------------------------------------------------------------------------

def encode(params: Params, cfg: SAERunnerConfig, x: torch.Tensor,
           hooks: HookRuntime = NULL_HOOKS, prefix: str = ""):
    """Returns (sae_in, feature_acts, hidden_pre, norm_ctx).  Compute
    follows the parameters' dtype; ``x`` is normalized first
    (:func:`norm_in`).  Gated: two products, the gate's and the
    magnitude's (as the reference computes them), ``hook_hidden_pre`` is not
    fired, and the gate pre-activation takes ``hidden_pre``'s place."""
    x = x.to(params["W_enc"].dtype)
    act_fn = get_activation_fn(cfg)
    xn, ctx = norm_in(cfg, x)
    sae_in = hooks(f"{prefix}hook_sae_in", xn - params["b_dec"])
    if cfg.architecture == "gated":
        gate_pre = sae_in @ params["W_enc"] + params["b_gate"]
        active = (gate_pre > 0).to(gate_pre.dtype)
        mag_pre = sae_in @ (params["W_enc"] * torch.exp(params["r_mag"])) + params["b_mag"]
        feature_acts = hooks(f"{prefix}hook_hidden_post", active * act_fn(mag_pre))
        return sae_in, feature_acts, gate_pre, ctx
    hidden_pre = hooks(f"{prefix}hook_hidden_pre",
                       sae_in @ params["W_enc"] + params["b_enc"])
    feature_acts = hooks(f"{prefix}hook_hidden_post", act_fn(hidden_pre))
    return sae_in, feature_acts, hidden_pre, ctx


def decode(params: Params, cfg: SAERunnerConfig, feature_acts: torch.Tensor,
           ctx=("none", None), hooks: HookRuntime = NULL_HOOKS,
           prefix: str = "") -> torch.Tensor:
    """The decoder, then :func:`norm_out`; a transcoder's output takes
    ``b_dec_out`` and is left for :func:`sae_forward` to finish (the skip,
    then the de-normalization)."""
    if cfg.architecture == "transcoder":
        return hooks(f"{prefix}hook_sae_out",
                     feature_acts @ params["W_dec"] + params["b_dec_out"])
    sae_out = hooks(f"{prefix}hook_sae_out",
                    feature_acts @ params["W_dec"] + params["b_dec"])
    return norm_out(ctx, sae_out)


def sae_forward(params: Params, cfg: SAERunnerConfig, x: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                dead_neuron_mask: Optional[torch.Tensor] = None,
                hooks: HookRuntime = NULL_HOOKS,
                training: bool = True, prefix: str = "") -> SAEOutput:
    """The SAE's forward with its losses.  Standard: ``loss = mse + l1``;
    TopK has no sparsity loss (``l1_loss`` is None, ``loss = mse``).  Gated:
    ``loss = mse + l1 + aux``, with the gate path's activations (ReLU, or
    the TopK activation) weighted by the decoder row norms in the L1 (0 for
    TopK) and decoded against ``sae_in`` in the aux loss, as the reference
    computes it (``aux_reconstruction_loss``).  Transcoder: the skip
    ``x W_skip^T`` is added to the decoder's output, which is then
    de-normalized and held to ``y`` (``x`` when None) in the MSE.  With
    ``cfg.use_ghost_grads``, in training and given ``dead_neuron_mask``, the
    standard SAE and the transcoder add the ghost loss
    (``ghost_grad_loss``)."""
    x = x.to(params["W_enc"].dtype)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    sae_in, feature_acts, hidden_pre, ctx = encode(params, cfg, x, hooks, prefix)
    sae_out = decode(params, cfg, feature_acts, ctx, hooks, prefix)
    if cfg.architecture == "transcoder":
        if cfg.transcoder_with_skip_connection:
            sae_out = sae_out + x @ params["W_skip"].T
        sae_out = norm_out(ctx, sae_out)
        mse_loss = _mse_loss(y if y is not None else x, sae_out)
    else:
        mse_loss = _mse_loss(x, sae_out)
    ghost_loss = zero
    if (cfg.use_ghost_grads and training and dead_neuron_mask is not None
            and cfg.architecture in ("standard", "transcoder")):
        ghost_loss = _ghost_residual_loss(params, x, sae_out, hidden_pre, dead_neuron_mask)
    if cfg.architecture == "gated":
        topk = cfg.activation_fn_str == "topk"
        pi_gate_act = get_activation_fn(cfg)(hidden_pre) if topk else torch.relu(hidden_pre)
        l1_loss = zero if topk else cfg.l1_coefficient * (
            pi_gate_act * torch.linalg.norm(params["W_dec"], dim=1)).sum(
                dim=-1, dtype=torch.float32).mean()
        via_gate = pi_gate_act @ params["W_dec"] + params["b_dec"]
        aux_loss = torch.square(via_gate - sae_in).sum(dim=-1, dtype=torch.float32).mean()
        return SAEOutput(sae_out, feature_acts, mse_loss + l1_loss + aux_loss, mse_loss,
                         l1_loss, zero, aux_loss)
    if cfg.activation_fn_str == "topk":
        return SAEOutput(sae_out, feature_acts, mse_loss + ghost_loss, mse_loss, None,
                         ghost_loss, zero)
    if cfg.lp_norm == 1.0:
        sparsity = feature_acts.abs().sum(dim=1, dtype=torch.float32).mean()
    else:
        sparsity = torch.linalg.vector_norm(
            feature_acts, ord=cfg.lp_norm, dim=1).mean(dtype=torch.float32)
    l1_loss = cfg.l1_coefficient * sparsity
    loss = mse_loss + l1_loss + ghost_loss
    return SAEOutput(sae_out, feature_acts, loss, mse_loss, l1_loss, ghost_loss, zero)


# ---------------------------------------------------------------------------
# Constraint transforms
# ---------------------------------------------------------------------------

def set_decoder_norm_to_unit_norm(params: Params) -> Params:
    """Unit-norm decoder rows (last axis, so a stacked ``[L, d_sae, d_in]``
    decoder works unchanged).  Returns a new dict."""
    out = dict(params)
    out["W_dec"] = params["W_dec"] / torch.linalg.norm(
        params["W_dec"], dim=-1, keepdim=True)
    return out


def remove_gradient_parallel_to_decoder_directions(grads: Params,
                                                   params: Params) -> Params:
    """Project the W_dec gradient off each (unit-norm) decoder row."""
    g = dict(grads)
    parallel = torch.sum(grads["W_dec"] * params["W_dec"], dim=-1, keepdim=True)
    g["W_dec"] = grads["W_dec"] - parallel * params["W_dec"]
    return g


# ---------------------------------------------------------------------------
# Module wrapper
# ---------------------------------------------------------------------------

class SparseAutoencoder(nn.Module):
    """The parameters (four; seven for gated; five or six for a transcoder)
    as an ``nn.Module``, with the
    JAX class's surface: ``__call__`` (the forward with losses),
    ``encode``, ``decode``, ``reconstruct`` and ``get_name``.  Drawn parameters go to ``device``
    (the CUDA card when None); given ``params`` stay on their device unless
    ``device`` names another.  :meth:`save_model` and
    :meth:`load_from_pretrained` read and write the JAX package's ``.npz``
    format."""

    def __init__(self, cfg: SAERunnerConfig, params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            device = resolve_device(device)
            params = init_sae_params(cfg, generator, device)
        for k, v in params.items():
            self.register_parameter(
                k, nn.Parameter(torch.as_tensor(v).detach().to(device),
                                requires_grad=False))

    @property
    def params(self) -> Params:
        return {k: p for k, p in self.named_parameters()}

    def forward(self, x, dead_neuron_mask=None) -> SAEOutput:
        return sae_forward(self.params, self.cfg, x, training=False)

    def encode(self, x):
        return encode(self.params, self.cfg, x)[1]

    def decode(self, feats):
        return decode(self.params, self.cfg, feats)

    def reconstruct(self, x):
        return self(x).sae_out

    def get_name(self) -> str:
        return (f"sparse_autoencoder_{self.cfg.model_name}_"
                f"{self.cfg.hook_point}_{self.cfg.d_sae}").replace("/", "_")

    # -- persistence ------------------------------------------------------
    def save_model(self, path: str):
        """Write the JAX package's format: one ``.npz`` (the suffix is added
        when missing) holding ``__config__``, the config's JSON, and one
        array per parameter.  bfloat16 parameters are written as their raw
        two-byte words (numpy's ``|V2``), the bytes the JAX package writes
        for an ``ml_dtypes`` bfloat16 array."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays = {k: tensor_to_numpy(v) for k, v in self.params.items()}
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 __config__=json.dumps(self.cfg.to_dict()), **arrays)

    @classmethod
    def load_from_pretrained(cls, path: str, device=None) -> "SparseAutoencoder":
        """Load a file written by :meth:`save_model` or by the JAX package's
        ``save_model``, onto ``device`` (the CUDA card when None).  Two-byte
        void arrays are read as bfloat16 words."""
        if not path.endswith(".npz") and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path, allow_pickle=False) as z:
            cfg = SAERunnerConfig.from_dict(json.loads(str(z["__config__"])))
            params = {k: numpy_to_tensor(z[k]) for k in z.files if k != "__config__"}
        return cls(cfg, params=params, device=resolve_device(device))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 as ``|V2`` words,
    which numpy has no float type for."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def numpy_to_tensor(a: np.ndarray) -> torch.Tensor:
    """The inverse of :func:`tensor_to_numpy`: ``|V2`` words (or an
    ``ml_dtypes`` bfloat16 array) as a bfloat16 tensor, to the bit."""
    if a.dtype.itemsize == 2 and a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def build_sae(cfg: SAERunnerConfig, generator: Optional[torch.Generator] = None,
              device=None) -> SparseAutoencoder:
    return SparseAutoencoder(cfg, generator=generator, device=device)
