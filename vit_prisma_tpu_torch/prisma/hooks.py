"""Hook runtime (PyTorch port of ``vit_prisma_tpu/prisma/hooks.py``).

A :class:`HookRuntime` is passed through the forward; ``hooks(name, value)``
applies the user's intervention functions (``f(value, hook) -> value``) and
records the value.  No ``register_forward_hook`` is involved: the forward
asks the runtime, through :meth:`HookRuntime.wants`, whether a hook point is
needed at all, and that answer decides whether attention may run through the
fused kernel (models/layers.py).

``names_filter`` is ``None`` (everything), an exact name, a list/tuple/set of
names, or a predicate.

Backward hooks (``bwd_hooks``, ``incl_bwd``) are not ported yet: they need
the attention kernel's backward (ROADMAP queue B, B2).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

NamesFilter = Union[None, str, Sequence[str], Callable[[str], bool]]
# An intervention hook: (value, HookInfo) -> new value.
HookFn = Callable[..., Any]

_BACKWARD_HOOKS = ("backward hooks are not ported yet (ROADMAP queue A, "
                   "item 11; they need kernel B2, the attention backward)")


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


class HookRuntime:
    """Collects activations and applies interventions during one forward.
    Created fresh for each call; ``cache`` holds the recorded tensors in
    firing order."""

    __slots__ = ("_should_cache", "_editors", "cache", "record")

    def __init__(
        self,
        names_filter: NamesFilter = None,
        fwd_hooks: Sequence[Tuple[Union[str, Callable[[str], bool]], HookFn]] = (),
        record: bool = True,
    ):
        self._should_cache = resolve_names_filter(names_filter) if record else None
        self.record = record
        self._editors: List[Tuple[Callable[[str], bool], HookFn]] = [
            (resolve_names_filter(pat), fn) for pat, fn in fwd_hooks
        ]
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
        if self.record and self._should_cache(name):
            self.cache[name] = out
        return out if editable else value

    def wants(self, name: str) -> bool:
        """True if this hook point needs to fire at all (cached or edited)."""
        if self.record and self._should_cache(name):
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


def grad_tap(fn, value):
    """Identity forward with ``fn`` applied to the gradient; not ported yet."""
    raise NotImplementedError(f"grad_tap: {_BACKWARD_HOOKS}")


def grad_cached_traced(*args, **kwargs):
    """Forward plus the gradient at every cached site; not ported yet."""
    raise NotImplementedError(f"grad_cached_traced: {_BACKWARD_HOOKS}")


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
