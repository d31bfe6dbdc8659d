"""Dataclass <-> dict helpers for wandb sweeps (a copy of
``vit_prisma_tpu/utils/wandb_utils.py`` for the PyTorch port)."""

import dataclasses


def dataclass_to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    return dict(vars(obj))


def update_dataclass_from_dict(obj, d):
    """In-place update of mutable dataclasses; returns a replaced copy for
    frozen ones."""
    fields = {f.name for f in dataclasses.fields(obj)} \
        if dataclasses.is_dataclass(obj) else set(vars(obj))
    updates = {k: v for k, v in d.items() if k in fields}
    if dataclasses.is_dataclass(obj) and obj.__dataclass_params__.frozen:
        return dataclasses.replace(obj, **updates)
    for k, v in updates.items():
        setattr(obj, k, v)
    return obj
