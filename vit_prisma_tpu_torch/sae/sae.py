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

Not ported yet, and raising ``NotImplementedError``: transcoders (ROADMAP
queue A, item 10), the approximate TopK (``topk_use_approx``, item 10),
ghost grads and the activation normalization modes (item 5).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

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


def check_ported(cfg: SAERunnerConfig) -> None:
    """Raise ``NotImplementedError`` for the SAE variants not ported yet."""
    if cfg.architecture not in ("standard", "gated") or cfg.is_transcoder:
        raise NotImplementedError(
            f"architecture={cfg.architecture!r} (is_transcoder="
            f"{cfg.is_transcoder}) is not ported yet: transcoders are "
            "ROADMAP queue A, item 10")
    if cfg.activation_fn_str == "topk" and cfg.topk_use_approx:
        raise NotImplementedError(
            "topk_use_approx (the approximate TopK, an XLA op of the TPU) is not "
            "ported yet (ROADMAP queue A, item 10)")
    if cfg.normalize_activations != "none":
        raise NotImplementedError(
            f"normalize_activations={cfg.normalize_activations!r} is not "
            "ported yet (ROADMAP queue A, item 5)")
    if cfg.use_ghost_grads:
        raise NotImplementedError(
            "ghost grads are not ported yet (ROADMAP queue A, item 5)")


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
        if cfg.topk_use_approx:
            raise NotImplementedError(
                "topk_use_approx (the approximate TopK, an XLA op of the TPU) is "
                "not ported yet (ROADMAP queue A, item 10)")
        if cfg.fused_topk:
            return lambda x: topk_mask_activation(x, k)
        return lambda x: topk_activation(x, k)
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
    """The JAX package's init scheme, drawn from ``generator`` on the CPU
    (seeded with ``cfg.seed`` when None) and moved to ``device`` (the CUDA
    card when None); the numbers differ from the JAX init's.  Standard: a
    unit-row Kaiming-uniform decoder, the encoder independent or tied to the
    decoder's transpose, zero biases.  Gated: Kaiming-uniform ``W_enc`` and
    ``W_dec`` without unit rows, zero ``b_gate``, ``r_mag``, ``b_mag``,
    ``b_enc`` and ``b_dec``."""
    check_ported(cfg)
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
    follows the parameters' dtype.  Gated: two products, the gate's and the
    magnitude's (as the reference computes them), ``hook_hidden_pre`` is not
    fired, and the gate pre-activation takes ``hidden_pre``'s place."""
    check_ported(cfg)
    x = x.to(params["W_enc"].dtype)
    act_fn = get_activation_fn(cfg)
    sae_in = hooks(f"{prefix}hook_sae_in", x - params["b_dec"])
    if cfg.architecture == "gated":
        gate_pre = sae_in @ params["W_enc"] + params["b_gate"]
        active = (gate_pre > 0).to(gate_pre.dtype)
        mag_pre = sae_in @ (params["W_enc"] * torch.exp(params["r_mag"])) + params["b_mag"]
        feature_acts = hooks(f"{prefix}hook_hidden_post", active * act_fn(mag_pre))
        return sae_in, feature_acts, gate_pre, ("none", None)
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
    """The SAE's forward with its losses.  Standard: ``loss = mse + l1``;
    TopK has no sparsity loss (``l1_loss`` is None, ``loss = mse``).  Gated:
    ``loss = mse + l1 + aux``, with the gate path's activations (ReLU, or
    the TopK activation) weighted by the decoder row norms in the L1 (0 for
    TopK) and decoded against ``sae_in`` in the aux loss, as the reference
    computes it (``aux_reconstruction_loss``)."""
    check_ported(cfg)
    x = x.to(params["W_enc"].dtype)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    sae_in, feature_acts, hidden_pre, ctx = encode(params, cfg, x, hooks, prefix)
    sae_out = decode(params, cfg, feature_acts, ctx, hooks, prefix)
    mse_loss = _mse_loss(x, sae_out)
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
        return SAEOutput(sae_out, feature_acts, mse_loss, mse_loss, None, zero, zero)
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
    """The parameters (four; seven for gated) as an ``nn.Module``, with the
    JAX class's surface: ``__call__`` (the forward with losses),
    ``encode``, ``decode``, ``reconstruct`` and ``get_name``.  Drawn parameters go to ``device``
    (the CUDA card when None); given ``params`` stay on their device unless
    ``device`` names another.  Saving and loading are ROADMAP queue A,
    item 15."""

    def __init__(self, cfg: SAERunnerConfig, params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        check_ported(cfg)
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
