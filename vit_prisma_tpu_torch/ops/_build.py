"""Build and load the package's CUDA kernels.

Every ``*.cu`` file under ``vit_prisma_tpu_torch/csrc`` is compiled by its
own ``nvcc`` process, all started together, with ``csrc`` on the include
path, and the objects are linked into one shared library with a plain C
interface, which the kernel wrappers call through ``ctypes``.  The library is
built at first use into ``csrc/build/<hash of the sources, headers and
flags>/``, so an edited source or shared header (``*.cuh``) builds anew, and
an ``fcntl`` lock keeps concurrent processes from building the same library
twice.  Nothing is compiled when the package is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
LIB_NAME = "libvpt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if not os.path.exists(candidate):
            raise RuntimeError(
                "nvcc not found on PATH or under CUDA_HOME "
                f"({cuda_home}); the CUDA kernels cannot be built")
        nvcc = candidate
    return nvcc


def build_dir() -> Path:
    """The directory the current sources build into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once; wait for all.  Returns (returncode,
    stdout + stderr) per command, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def build() -> Path:
    """Compile the library if the current sources have not been built yet;
    return its path.  The compilers' output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept in ``nvcc.log`` beside it.
    Raises ``RuntimeError`` with nvcc's output when a build step fails."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # built by another process while we waited
                return lib
            nvcc = _nvcc()
            objs = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in _sources()]
            cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(src)]
                    for src, o in zip(_sources(), objs)]
            tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            results = _run_all(cmds)
            if all(rc == 0 for rc, _ in results):
                results += _run_all([link])
            log = "".join(f"$ {' '.join(c)}\n{out}" for c, (_, out)
                          in zip(cmds + [link], results))
            (out_dir / "nvcc.log").write_text(log)
            for o in objs:
                o.unlink(missing_ok=True)
            failed = [(c, rc) for c, (rc, _) in zip(cmds + [link], results) if rc]
            if failed or len(results) != len(cmds) + 1:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.attention_mix_tnh_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.attention_mix_tnh_fwd.restype = i
    lib.attention_mix_fwd.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.attention_mix_fwd.restype = i
    lib.attention_block_fwd.argtypes = [p] * 6 + [i] * 4 + [f, i, i, p]
    lib.attention_block_fwd.restype = i
    lib.attention_mix_tnh_bwd.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.attention_mix_tnh_bwd.restype = i
    lib.take_rows.argtypes = [p, p, p, ll, ll, i, i, i, p]
    lib.take_rows.restype = i
    lib.adam_update.argtypes = [p, p, p, p, p, p, p, p, i, ll, ll,
                                f, f, f, f, f, i, i, i, p]
    lib.adam_update.restype = i
    lib.sae_fused_fwd.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.sae_fused_fwd.restype = i
    lib.sae_fused_bwd.argtypes = [p] * 14 + [i] * 7 + [p]
    lib.sae_fused_bwd.restype = i
    lib.sae_fused_fwd_tc.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.sae_fused_fwd_tc.restype = i
    lib.sae_fused_bwd_stored_tc.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.sae_fused_bwd_stored_tc.restype = i
    lib.sae_fused_bwd_remat_tc.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.sae_fused_bwd_remat_tc.restype = i
    lib.sae_fused_fwd_topk_tc.argtypes = [p] * 11 + [i] * 6 + [p]
    lib.sae_fused_fwd_topk_tc.restype = i
    lib.sae_fused_bwd_topk_tc.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.sae_fused_bwd_topk_tc.restype = i
    lib.sae_fused_fwd_tf32.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.sae_fused_fwd_tf32.restype = i
    lib.sae_fused_bwd_stored_tf32.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.sae_fused_bwd_stored_tf32.restype = i
    lib.sae_fused_bwd_remat_tf32.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.sae_fused_bwd_remat_tf32.restype = i
    lib.sae_fused_fwd_topk_tf32.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.sae_fused_fwd_topk_tf32.restype = i
    lib.sae_fused_bwd_topk_tf32.argtypes = [p] * 15 + [i] * 5 + [p]
    lib.sae_fused_bwd_topk_tf32.restype = i
    lib.sae_fused_fwd_topk.argtypes = [p] * 11 + [i] * 7 + [p]
    lib.sae_fused_fwd_topk.restype = i
    lib.sae_fused_fwd_gated.argtypes = [p] * 13 + [i] * 6 + [p]
    lib.sae_fused_fwd_gated.restype = i
    lib.sae_fused_bwd_gated.argtypes = [p] * 19 + [i] * 6 + [p]
    lib.sae_fused_bwd_gated.restype = i
    lib.sae_gated_fwd_tc.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.sae_gated_fwd_tc.restype = i
    lib.sae_gated_bwd_tc.argtypes = [p] * 19 + [i] * 5 + [p]
    lib.sae_gated_bwd_tc.restype = i
    lib.sae_gated_fwd_tf32.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.sae_gated_fwd_tf32.restype = i
    lib.sae_gated_bwd_tf32.argtypes = [p] * 20 + [i] * 5 + [p]
    lib.sae_gated_bwd_tf32.restype = i
    lib.kth_value.argtypes = [p, p, ll, i, i, i, i, p]
    lib.kth_value.restype = i
    lib.kth_value_plan.argtypes = [i, i, p]
    lib.kth_value_plan.restype = i
    lib.ln_matmul_fwd.argtypes = [p] * 5 + [i] * 4 + [f, i, i, p]
    lib.ln_matmul_fwd.restype = i
    lib.flash_attention_fwd.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.flash_attention_bwd.restype = i
    lib.vpt_cuda_error_string.argtypes = [i]
    lib.vpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.vpt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
