"""Sparse autoencoders (PyTorch port of ``vit_prisma_tpu/sae/sae.py``).

The standard SAE with a ReLU (or tanh-ReLU) activation: ``encode``,
``decode`` and ``sae_forward`` with the normalized MSE and the Lp sparsity
loss, the decoder unit-norm projection and the removal of the gradient
parallel to the decoder rows, over a plain dict of tensors (``W_enc``
``[d_in, d_sae]``, ``W_dec`` ``[d_sae, d_in]``, ``b_enc``, ``b_dec``), with
the JAX package's layouts and cast points.  :class:`SparseAutoencoder` is an
``nn.Module`` holding those four parameters.

Not ported yet, and raising ``NotImplementedError``: the gated, TopK and
transcoder SAEs (ROADMAP queue A, item 10), ghost grads and the activation
normalization modes (item 5).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from vit_prisma_tpu_torch.prisma.hooks import NULL_HOOKS, HookRuntime
from vit_prisma_tpu_torch.sae.config import SAERunnerConfig

Params = Dict[str, torch.Tensor]


class SAEOutput(NamedTuple):
    sae_out: torch.Tensor
    feature_acts: torch.Tensor
    loss: torch.Tensor
    mse_loss: torch.Tensor
    l1_loss: Optional[torch.Tensor]
    ghost_grad_loss: torch.Tensor
    aux_reconstruction_loss: torch.Tensor


def check_ported(cfg: SAERunnerConfig) -> None:
    """Raise ``NotImplementedError`` for the SAE variants not ported yet."""
    if cfg.architecture != "standard" or cfg.is_transcoder:
        raise NotImplementedError(
            f"architecture={cfg.architecture!r} (is_transcoder="
            f"{cfg.is_transcoder}) is not ported yet: gated SAEs and "
            "transcoders are ROADMAP queue A, item 10")
    if cfg.activation_fn_str == "topk":
        raise NotImplementedError(
            "TopK SAEs are not ported yet (ROADMAP queue A, item 10)")
    if cfg.normalize_activations != "none":
        raise NotImplementedError(
            f"normalize_activations={cfg.normalize_activations!r} is not "
            "ported yet (ROADMAP queue A, item 5)")
    if cfg.use_ghost_grads:
        raise NotImplementedError(
            "ghost grads are not ported yet (ROADMAP queue A, item 5)")


def get_activation_fn(cfg: SAERunnerConfig):
    name = cfg.activation_fn_str
    if name == "relu":
        return torch.relu
    if name == "tanh-relu":
        return lambda x: torch.tanh(torch.relu(x))
    if name == "topk":
        raise NotImplementedError(
            "TopK SAEs are not ported yet (ROADMAP queue A, item 10)")
    raise ValueError(f"Unknown activation function: {name}")


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
    """The standard SAE's init in the JAX package's scheme (unit-row
    Kaiming-uniform decoder, encoder independent or tied to the decoder's
    transpose, zero biases), drawn from ``generator`` on the CPU (seeded
    with ``cfg.seed`` when None).  The numbers differ from the JAX init's."""
    check_ported(cfg)
    g = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
    dt = cfg.torch_dtype
    d_in, d_sae = cfg.d_in, cfg.d_sae
    W_enc_draw = _kaiming_uniform(g, (d_in, d_sae), dt)
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


# ---------------------------------------------------------------------------
# Encode / decode / forward
# ---------------------------------------------------------------------------

def encode(params: Params, cfg: SAERunnerConfig, x: torch.Tensor,
           hooks: HookRuntime = NULL_HOOKS, prefix: str = ""):
    """Returns (sae_in, feature_acts, hidden_pre, norm_ctx).  Compute
    follows the parameters' dtype."""
    check_ported(cfg)
    x = x.to(params["W_enc"].dtype)
    act_fn = get_activation_fn(cfg)
    sae_in = hooks(f"{prefix}hook_sae_in", x - params["b_dec"])
    hidden_pre = hooks(f"{prefix}hook_hidden_pre",
                       sae_in @ params["W_enc"] + params["b_enc"])
    feature_acts = hooks(f"{prefix}hook_hidden_post", act_fn(hidden_pre))
    return sae_in, feature_acts, hidden_pre, ("none", None)


def decode(params: Params, cfg: SAERunnerConfig, feature_acts: torch.Tensor,
           ctx=("none", None), hooks: HookRuntime = NULL_HOOKS,
           prefix: str = "") -> torch.Tensor:
    check_ported(cfg)
    return hooks(f"{prefix}hook_sae_out",
                 feature_acts @ params["W_dec"] + params["b_dec"])


def sae_forward(params: Params, cfg: SAERunnerConfig, x: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                dead_neuron_mask: Optional[torch.Tensor] = None,
                hooks: HookRuntime = NULL_HOOKS,
                training: bool = True, prefix: str = "") -> SAEOutput:
    """The standard SAE's forward with its losses: ``loss = mse + l1``."""
    check_ported(cfg)
    x = x.to(params["W_enc"].dtype)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    _, feature_acts, _, ctx = encode(params, cfg, x, hooks, prefix)
    sae_out = decode(params, cfg, feature_acts, ctx, hooks, prefix)
    mse_loss = _mse_loss(x, sae_out)
    if cfg.lp_norm == 1.0:
        sparsity = feature_acts.abs().sum(dim=1, dtype=torch.float32).mean()
    else:
        sparsity = torch.linalg.vector_norm(
            feature_acts, ord=cfg.lp_norm, dim=1).mean(dtype=torch.float32)
    l1_loss = cfg.l1_coefficient * sparsity
    loss = mse_loss + l1_loss
    return SAEOutput(sae_out, feature_acts, loss, mse_loss, l1_loss, zero, zero)


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
    """The four parameters as an ``nn.Module``, with the JAX class's
    surface: ``__call__`` (the forward with losses), ``encode``, ``decode``,
    ``reconstruct`` and ``get_name``.  Saving and loading are ROADMAP
    queue A, item 15."""

    def __init__(self, cfg: SAERunnerConfig, params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        if params is None:
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

    def save_model(self, path: str):
        raise NotImplementedError(
            "saving SAEs is not ported yet (ROADMAP queue A, item 15)")

    @classmethod
    def load_from_pretrained(cls, path: str, device=None) -> "SparseAutoencoder":
        raise NotImplementedError(
            "loading SAEs is not ported yet (ROADMAP queue A, item 15)")


def build_sae(cfg: SAERunnerConfig, generator: Optional[torch.Generator] = None,
              device=None) -> SparseAutoencoder:
    return SparseAutoencoder(cfg, generator=generator, device=device)
