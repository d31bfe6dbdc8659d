"""Profiling and device-time measurement (PyTorch port of
``vit_prisma_tpu/utils/profiling.py``).

:func:`profile_trace` records a ``torch.profiler`` trace (CPU and CUDA
activities) and exports it as a Chrome trace; :func:`device_time` times a
call with CUDA events on a card (warm-up and iterations as in the JAX
function), with the host clock on the CPU; :func:`memory_stats` reads
``torch.cuda.memory_stats`` and returns None where there is no card, as the
JAX function does where the backend keeps no statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


@contextlib.contextmanager
def profile_trace(logdir: str = "torch_trace", create_perfetto_link: bool = False):
    """Record a ``torch.profiler`` trace of the block and write it to
    ``{logdir}/trace.json`` (Chrome trace format, which Perfetto opens)::

        with profile_trace("trace") as prof:
            model(x)
        prof.key_averages()

    ``create_perfetto_link`` is accepted for the JAX signature and ignored."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_time(fn: Callable, *args, iters: int = 20, warmup: int = 2,
                **kwargs) -> float:
    """Average seconds a call of ``fn(*args, **kwargs)``: ``warmup`` calls,
    then ``iters`` calls timed as one unit.  On a card (the first tensor of
    the output lies there) the time is read from CUDA events around the
    loop; otherwise from the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    return (time.perf_counter() - t0) / iters


def flops_per_second(fn: Callable, flops_per_call: float, *args,
                     iters: int = 20, **kwargs) -> float:
    return flops_per_call / device_time(fn, *args, iters=iters, **kwargs)


def memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats(device)`` (the current card when None),
    or None on a host without a card or for a CPU ``device``."""
    if not torch.cuda.is_available():
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    return dict(torch.cuda.memory_stats(device))
