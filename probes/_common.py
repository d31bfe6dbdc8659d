"""Shared helpers of the chip probes: paths, an nvcc build of one source
into a shared library with a plain C interface, CUDA-event timing, and the
card's name and power limit."""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from vit_prisma_tpu_torch.ops._build import BUILD_ROOT, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

BUILD = BUILD_ROOT / "probes"  # gitignored


def start_build(src: Path, name: str) -> subprocess.Popen:
    """Start nvcc on one source (csrc on the include path, the package's
    flags) into BUILD/<name>.so; ptxas's report lands in BUILD/<name>.log."""
    BUILD.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(CSRC),
                             "-o", str(BUILD / f"{name}.so"), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(proc: subprocess.Popen, name: str):
    """Wait for a build; the loaded library, or None with nvcc's output
    printed."""
    log = proc.communicate()[0]
    (BUILD / f"{name}.log").write_text(log)
    if proc.returncode:
        print(log[-3000:])
        return None
    return ctypes.CDLL(str(BUILD / f"{name}.so"))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def ms(fn, iters=50, warmup=5) -> float:
    """Mean device time of fn in milliseconds, from CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
