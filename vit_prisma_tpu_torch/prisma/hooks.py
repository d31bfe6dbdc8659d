"""Hook runtime (PyTorch port of ``vit_prisma_tpu/prisma/hooks.py``).

A :class:`HookRuntime` is passed through the forward; ``hooks(name, value)``
applies the user's intervention functions (``f(value, hook) -> value``) and
records the value.  No ``register_forward_hook`` is involved: the forward
asks the runtime, through :meth:`HookRuntime.wants`, whether a hook point is
needed at all, and that answer decides whether attention may run through the
fused kernel (models/layers.py).

``names_filter`` is ``None`` (everything), an exact name, a list/tuple/set of
names, or a predicate.

Gradients (the reference's ``dir="bwd"`` hooks and ``incl_bwd``) go through
autograd: :func:`grad_tap` applies a backward editor ``f(grad, hook) ->
grad`` to the gradient flowing upstream through a hook point, and
:func:`grad_cached_traced` runs the forward with a zeros tensor added at
every cached hook point, then takes the gradient of the loss with respect
to those tensors: the gradient arriving at each point.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import torch

NamesFilter = Union[None, str, Sequence[str], Callable[[str], bool]]
# An intervention hook: (value, HookInfo) -> new value.
HookFn = Callable[..., Any]


class HookInfo:
    """Metadata passed to intervention hooks (``hook.name``/``hook.layer()``)."""

    __slots__ = ("name", "ctx")

    def __init__(self, name: str):
        self.name = name
        self.ctx: Dict[str, Any] = {}

    def layer(self) -> int:
        parts = self.name.split(".")
        if parts[0] == "blocks":
            return int(parts[1])
        raise ValueError(f"Hook name {self.name!r} has no layer")

    def __repr__(self):
        return f"HookInfo({self.name!r})"


def resolve_names_filter(names_filter: NamesFilter) -> Callable[[str], bool]:
    if names_filter is None:
        return lambda name: True
    if isinstance(names_filter, str):
        name = names_filter
        return lambda n: n == name
    if isinstance(names_filter, (list, tuple, set, frozenset)):
        allowed = frozenset(names_filter)
        return lambda n: n in allowed
    if callable(names_filter):
        return names_filter
    raise ValueError(f"Bad names_filter: {names_filter!r}")


class _GradTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, value):
        ctx.fn = fn
        return value.view_as(value)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.fn(grad)


def grad_tap(fn, value):
    """Identity in the forward; applies ``fn`` to the gradient in the
    backward, so that ``fn(grad)`` flows upstream of this point."""
    return _GradTap.apply(fn, value)


class HookRuntime:
    """Collects activations and applies interventions during one forward.
    Created fresh for each call; ``cache`` holds the recorded tensors in
    firing order.

    Gradient mode (any of ``bwd_hooks``, ``grad_eps``, ``grad_sites``):
    ``bwd_hooks`` are editors ``f(grad, hook) -> grad`` applied through
    :func:`grad_tap` to the stream a hook point returns; ``grad_eps``, a
    dict, receives at each cached point a zeros tensor that requires grad
    and is added to the returned stream (one tensor per name, added at every
    firing), so that the loss's gradient with respect to it is the gradient
    of the live stream there; ``grad_sites``, a set, collects the names of
    the cached points that fired.  The eps tensor is added after the
    editors, nearer the loss: the gradient cached for a point is the one
    arriving there, and the edited one flows upstream.  Points whose
    edited value the forward discards (``editable=False``) tap the live
    stream."""

    __slots__ = ("_should_cache", "_editors", "_bwd_editors", "cache", "record",
                 "grad_eps", "grad_sites", "grad_mode")

    def __init__(
        self,
        names_filter: NamesFilter = None,
        fwd_hooks: Sequence[Tuple[Union[str, Callable[[str], bool]], HookFn]] = (),
        record: bool = True,
        bwd_hooks: Sequence[Tuple[Union[str, Callable[[str], bool]], HookFn]] = (),
        grad_eps: Optional[Dict[str, torch.Tensor]] = None,
        grad_sites: Optional[Set[str]] = None,
    ):
        self._should_cache = resolve_names_filter(names_filter) if record else None
        self.record = record
        self._editors: List[Tuple[Callable[[str], bool], HookFn]] = [
            (resolve_names_filter(pat), fn) for pat, fn in fwd_hooks
        ]
        self._bwd_editors: List[Tuple[Callable[[str], bool], HookFn]] = [
            (resolve_names_filter(pat), fn) for pat, fn in bwd_hooks
        ]
        self.grad_eps = grad_eps
        self.grad_sites = grad_sites
        self.grad_mode = (bool(bwd_hooks) or grad_eps is not None
                          or grad_sites is not None)
        self.cache: Dict[str, Any] = {}

    def __call__(self, name: str, value, *, editable: bool = True):
        """Fire the hook point ``name``.

        ``editable=False`` marks call sites whose hook return value the
        reference discards (e.g. ``hook_full_embed``): the edited value is
        cached, but the stream carries on with the unedited one.
        """
        out = value
        for matches, fn in self._editors:
            if matches(name):
                out = fn(out, HookInfo(name))
        ret = out if editable else value
        cached = self.record and self._should_cache(name)
        if self.grad_mode:
            if self.grad_eps is not None and ret.is_inference():
                ret = ret.clone()  # e.g. a cached activation patched in
            if self.grad_sites is not None and cached:
                self.grad_sites.add(name)
            for matches, fn in self._bwd_editors:
                if matches(name):
                    info = HookInfo(name)
                    ret = grad_tap(lambda g, _fn=fn, _i=info: _fn(g, _i), ret)
            if self.grad_eps is not None and cached:
                eps = self.grad_eps.get(name)
                if eps is None:
                    eps = self.grad_eps[name] = torch.zeros_like(ret, requires_grad=True)
                ret = ret + eps
        if cached:
            self.cache[name] = ret if editable else out
        return ret

    def wants(self, name: str) -> bool:
        """True if this hook point needs to fire at all (cached, edited or
        with a backward editor)."""
        if self.record and self._should_cache(name):
            return True
        if any(matches(name) for matches, _ in self._bwd_editors):
            return True
        return any(matches(name) for matches, _ in self._editors)


class NullHooks:
    """No-op runtime for plain forwards."""

    cache: Dict[str, Any] = {}

    def __call__(self, name: str, value, *, editable: bool = True):
        return value

    def wants(self, name: str) -> bool:
        return False


NULL_HOOKS = NullHooks()


def grad_cached_traced(forward, names: Tuple[str, ...],
                       fwd_hooks: Sequence[Tuple] = (),
                       bwd_hooks: Sequence[Tuple] = (),
                       loss_fn: Optional[Callable] = None,
                       incl_bwd: bool = True):
    """Build ``traced(params, x) -> (out, cache)``: the forward
    ``forward(params, x, rt)`` caching the hook points ``names`` and, with
    ``incl_bwd``, for every cached point that fired, the gradient of the
    loss there under ``{name}_grad``.  ``loss_fn(out) -> scalar`` picks the
    loss; None means ``out.sum()``.  A point the loss does not reach gets
    zeros.  The activations come in firing order, then the gradient keys
    in reverse firing order, as the gradient reaches them.

    With ``incl_bwd`` the forward records an autograd graph (outside
    inference mode); only the gradients of the eps tensors are taken, not
    the parameters', and the returned output and cache are detached.
    Without it the backward editors cannot change anything returned, so no
    backward runs and the forward runs in inference mode: with no
    backward editors either, this is the plain cached forward."""
    def traced(params, x):
        if not incl_bwd:
            with torch.inference_mode():
                rt = HookRuntime(names_filter=names, fwd_hooks=fwd_hooks,
                                 bwd_hooks=bwd_hooks)
                out = forward(params, x, rt)
            return out, dict(rt.cache)
        eps: Dict[str, torch.Tensor] = {}
        with torch.inference_mode(False), torch.enable_grad():
            if x.is_inference():
                x = x.clone()
            rt = HookRuntime(names_filter=names, fwd_hooks=fwd_hooks,
                             bwd_hooks=bwd_hooks, grad_eps=eps)
            out = forward(params, x, rt)
            loss = loss_fn(out) if loss_fn is not None else out.sum()
            grad_names = [n for n in names if n in eps]
            grads = torch.autograd.grad(loss, [eps[n] for n in grad_names],
                                        allow_unused=True) if grad_names else ()
        cache = {k: v.detach() for k, v in rt.cache.items()}
        for n, g in reversed(list(zip(grad_names, grads))):
            cache[n + "_grad"] = torch.zeros_like(eps[n]) if g is None else g
        return out.detach(), cache

    return traced


def hook_key(fwd_hooks) -> Tuple:
    """A hashable key for a list of ``(pattern, fn)`` hooks: functions by
    identity, patterns by value when hashable, identity otherwise."""
    key = []
    for pat, fn in fwd_hooks:
        try:
            hash(pat)
            pkey = ("v", pat)
        except TypeError:
            pkey = ("id", id(pat))
        key.append((pkey, id(fn)))
    return tuple(key)
