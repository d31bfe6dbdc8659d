"""HookedSAEViT (PyTorch port of ``vit_prisma_tpu/models/sae_vit.py``): a
HookedViT that splices SAEs into its forward.

Splicing an SAE at hook ``X`` replaces the activation at ``X`` with the
SAE's reconstruction.  It is an intervention hook that runs ``sae_forward``
on the value and fires the SAE's own hook points through the same runtime,
as ``{X}.hook_sae_in``, ``{X}.hook_hidden_pre``, ``{X}.hook_hidden_post`` and
``{X}.hook_sae_out``.  ``use_error_term=True`` gives the SAELens semantics:
the spliced value is ``recon + (value - recon).detach()``, so the forward
is the clean model's while gradients flow through the SAE.  Gradients
(``incl_bwd``, ``bwd_hooks``) go through ``sae_forward``'s plain ops and
autograd, never through the fused SAE kernels, whose x cotangent is zero.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from typing import Dict, List, Optional, Union

import torch

from vit_prisma_tpu_torch.models.vit import HookedViT, hook_names, vit_forward
from vit_prisma_tpu_torch.prisma.cache import ActivationCache
from vit_prisma_tpu_torch.prisma.hooks import (HookRuntime, grad_cached_traced,
                                               resolve_names_filter)
from vit_prisma_tpu_torch.sae.sae import SparseAutoencoder, sae_forward


class HookedSAEViT(HookedViT):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.acts_to_saes: Dict[str, SparseAutoencoder] = {}

    # -- attachment -------------------------------------------------------
    def add_sae(self, sae: SparseAutoencoder,
                use_error_term: Optional[bool] = None):
        """Attach ``sae`` at its configured hook point."""
        act_name = sae.cfg.hook_point
        if act_name not in self.acts_to_saes and act_name not in hook_names(self.cfg):
            logging.warning(f"No hook found for {act_name}. Skipping.")
            return
        if use_error_term is not None:
            if not hasattr(sae, "_original_use_error_term"):
                sae._original_use_error_term = getattr(sae, "use_error_term", False)
            sae.use_error_term = use_error_term
        self.acts_to_saes[act_name] = sae

    def _reset_sae(self, act_name: str,
                   prev_sae: Optional[SparseAutoencoder] = None):
        if act_name not in self.acts_to_saes:
            logging.warning(f"No SAE is attached to {act_name}. "
                            "There's nothing to reset.")
            return
        current = self.acts_to_saes[act_name]
        if hasattr(current, "_original_use_error_term"):
            current.use_error_term = current._original_use_error_term
            delattr(current, "_original_use_error_term")
        if prev_sae is not None:
            self.acts_to_saes[act_name] = prev_sae
        else:
            del self.acts_to_saes[act_name]

    def reset_saes(self, act_names: Optional[Union[str, List[str]]] = None,
                   prev_saes: Optional[List[Optional[SparseAutoencoder]]] = None):
        if isinstance(act_names, str):
            act_names = [act_names]
        elif act_names is None:
            act_names = list(self.acts_to_saes.keys())
        if prev_saes:
            if len(act_names) != len(prev_saes):
                raise ValueError("act_names and prev_saes must have the same length")
        else:
            prev_saes = [None] * len(act_names)
        for act_name, prev in zip(act_names, prev_saes):
            self._reset_sae(act_name, prev)

    @contextmanager
    def saes(self, saes: Union[SparseAutoencoder, List[SparseAutoencoder]] = (),
             reset_saes_end: bool = True,
             use_error_term: Optional[bool] = None):
        """Temporarily attach SAEs."""
        if isinstance(saes, SparseAutoencoder):
            saes = [saes]
        act_names_to_reset, prev_saes = [], []
        try:
            for sae in saes:
                act_names_to_reset.append(sae.cfg.hook_point)
                prev_saes.append(self.acts_to_saes.get(sae.cfg.hook_point))
                self.add_sae(sae, use_error_term=use_error_term)
            yield self
        finally:
            if reset_saes_end:
                self.reset_saes(act_names_to_reset, prev_saes)

    # -- spliced execution ------------------------------------------------
    def _sae_hook_names(self, act_name: str) -> List[str]:
        """Cache keys contributed by an SAE spliced at ``act_name``."""
        scfg = self.acts_to_saes[act_name].cfg
        names = [f"{act_name}.hook_sae_in"]
        if scfg.architecture != "gated":
            names.append(f"{act_name}.hook_hidden_pre")
        names += [f"{act_name}.hook_hidden_post", f"{act_name}.hook_sae_out"]
        return names

    def _spliced_forward(self, x, rt: HookRuntime, stop_at_layer):
        """The forward with a splice editor, ahead of the user's editors,
        at each attached SAE's hook point."""
        splices = []
        for name, sae in sorted(self.acts_to_saes.items()):
            err = bool(getattr(sae, "use_error_term", False))

            def splice(value, hook, sae=sae, err=err, name=name):
                recon = sae_forward(sae.params, sae.cfg, value, hooks=rt,
                                    training=False, prefix=f"{name}.").sae_out
                recon = recon.to(value.dtype)
                if err:
                    recon = recon + (value - recon).detach()
                return recon
            splices.append((resolve_names_filter(name), splice))
        rt._editors = splices + rt._editors
        return vit_forward(self, self.cfg, x, rt, stop_at_layer)

    def forward(self, x, stop_at_layer: Optional[int] = None):
        if not self.acts_to_saes:
            return super().forward(x, stop_at_layer=stop_at_layer)
        with torch.inference_mode():
            return self._spliced_forward(x, HookRuntime(record=False), stop_at_layer)

    def run_with_cache(self, x, names_filter=None, return_cache_object=True,
                       stop_at_layer=None, fwd_hooks=(), remove_batch_dim=False,
                       incl_bwd=False, bwd_hooks=(), loss_fn=None):
        """Spliced cached forward.  Each spliced hook point's key is replaced
        by the SAE's own hook points; with ``incl_bwd=True`` (or
        ``bwd_hooks``) the gradient flows through the attached SAEs and is
        cached for every cached point, the SAEs' included.  With
        ``use_error_term=True`` attachments the forward is the clean model's
        and gradients route through the SAE: SAE-feature attribution."""
        if not self.acts_to_saes:
            return super().run_with_cache(
                x, names_filter=names_filter,
                return_cache_object=return_cache_object,
                stop_at_layer=stop_at_layer, fwd_hooks=fwd_hooks,
                remove_batch_dim=remove_batch_dim, incl_bwd=incl_bwd,
                bwd_hooks=bwd_hooks, loss_fn=loss_fn)
        pred = resolve_names_filter(names_filter)
        expanded: List[str] = []
        for n in self._resolve_names(None, stop_at_layer):
            expanded += self._sae_hook_names(n) if n in self.acts_to_saes else [n]
        names = tuple(n for n in expanded if pred(n))
        traced = grad_cached_traced(
            lambda p, x, rt: p._spliced_forward(x, rt, stop_at_layer), names,
            fwd_hooks=tuple(fwd_hooks), bwd_hooks=tuple(bwd_hooks),
            loss_fn=loss_fn, incl_bwd=incl_bwd)
        out, cache = traced(self, x)
        if remove_batch_dim:
            cache = {k: v[0] for k, v in cache.items()}
        if return_cache_object:
            cache = ActivationCache(cache, self, has_batch_dim=not remove_batch_dim)
        return out, cache

    def run_with_hooks(self, x, fwd_hooks=(), stop_at_layer=None, **kw):
        if not self.acts_to_saes:
            return super().run_with_hooks(x, fwd_hooks=fwd_hooks,
                                          stop_at_layer=stop_at_layer)
        with torch.inference_mode():
            return self._spliced_forward(
                x, HookRuntime(fwd_hooks=tuple(fwd_hooks), record=False), stop_at_layer)

    # -- one-shot wrappers ------------------------------------------------
    def run_with_saes(self, x, saes=(), reset_saes_end: bool = True,
                      use_error_term: Optional[bool] = None, **kw):
        with self.saes(saes=saes, reset_saes_end=reset_saes_end,
                       use_error_term=use_error_term):
            return self(x, **kw)

    def run_with_cache_with_saes(self, x, saes=(), reset_saes_end: bool = True,
                                 use_error_term: Optional[bool] = None,
                                 return_cache_object: bool = True,
                                 remove_batch_dim: bool = False, **kw):
        with self.saes(saes=saes, reset_saes_end=reset_saes_end,
                       use_error_term=use_error_term):
            return self.run_with_cache(
                x, return_cache_object=return_cache_object,
                remove_batch_dim=remove_batch_dim, **kw)

    def run_with_hooks_with_saes(self, x, saes=(), reset_saes_end: bool = True,
                                 fwd_hooks=(), **kw):
        with self.saes(saes=saes, reset_saes_end=reset_saes_end):
            return self.run_with_hooks(x, fwd_hooks=fwd_hooks, **kw)
