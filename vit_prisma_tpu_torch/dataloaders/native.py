"""The native C++ image pipeline through ctypes (the port of
``vit_prisma_tpu/dataloaders/native.py``).

The library is built from the port's own byte-equal copies of the JAX
package's sources (``vit_prisma_tpu_torch/csrc/host/image_pipeline.cpp`` and
``batch_loader.cpp``): fused JPEG decode (libjpeg) + antialiased bicubic
resize of the shorter side + center crop + normalize + NCHW pack, and a C++
worker pool that does it ahead of the consumer.  The ctypes signatures are
the JAX module's.

The build runs with ``g++`` at the first call that needs the library, never
at import, into ``csrc/build/host-<hash of the sources, compiler and
flags>/``; an ``fcntl`` lock keeps concurrent processes from building the
same library twice, and the library is written under a temporary name and
moved into place with ``os.replace``, so no process loads a half-written
file.  A host needs ``g++`` and the libjpeg headers (``jpeglib.h``).

Unlike the JAX module, nothing falls back: when the library cannot be built
the caller gets a ``RuntimeError`` carrying the compiler's output, not a
PIL decode or a Python thread.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from vit_prisma_tpu_torch.dataloaders.transforms import CLIP_MEAN, CLIP_STD

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
SOURCES = ("image_pipeline.cpp", "batch_loader.cpp")
BUILD_ROOT = HOST_SRC.parent / "build"
LIB_NAME = "libimage_pipeline.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LD_FLAGS = ("-ljpeg", "-lpthread")

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _command(out: Path):
    return [CXX, *CXX_FLAGS, *(str(HOST_SRC / s) for s in SOURCES), "-o", str(out),
            *LD_FLAGS]


def build_dir(root: Optional[Path] = None) -> Path:
    """The directory the current sources, compiler and flags build into."""
    h = hashlib.sha256(" ".join(_command(Path(LIB_NAME))).encode())
    for name in SOURCES:
        h.update((HOST_SRC / name).read_bytes())
    return Path(root or BUILD_ROOT) / f"host-{h.hexdigest()[:16]}"


def build_library(root: Optional[Path] = None) -> Tuple[Path, bool]:
    """Compile the library unless the current sources are built; return its
    path and whether this call compiled it.  The compiler's output is kept
    in ``build.log`` beside it.  Raises ``RuntimeError`` with that output
    when the compiler is missing or fails."""
    out_dir = build_dir(root)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, False
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # built by another process while we waited
                return lib, False
            tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
            cmd = _command(tmp)
            try:
                proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, timeout=300)
                rc, log = proc.returncode, proc.stdout
            except (OSError, subprocess.TimeoutExpired) as e:
                rc, log = -1, f"{type(e).__name__}: {e}\n"
            (out_dir / "build.log").write_text(f"$ {' '.join(cmd)}\n{log}")
            if rc != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building the native image pipeline failed (exit {rc}); it needs "
                    f"{CXX} and the libjpeg headers:\n$ {' '.join(cmd)}\n{log}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib, True


@functools.cache
def get_lib() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures."""
    lib = ctypes.CDLL(str(build_library()[0]))
    lib.ip_preprocess_rgb.restype = ctypes.c_int
    lib.ip_preprocess_rgb.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _f32p, _f32p, _f32p]
    lib.ip_decode_jpeg.restype = ctypes.c_int
    lib.ip_decode_jpeg.argtypes = [
        _u8p, ctypes.c_long, ctypes.POINTER(_u8p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ip_decode_preprocess.restype = ctypes.c_int
    lib.ip_decode_preprocess.argtypes = [
        _u8p, ctypes.c_long, ctypes.c_int, _f32p, _f32p, _f32p]
    lib.ip_preprocess_batch.restype = ctypes.c_int
    lib.ip_preprocess_batch.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _f32p, _f32p, _f32p, ctypes.c_int]
    lib.ip_free.restype = None
    lib.ip_free.argtypes = [ctypes.c_void_p]
    lib.ip_loader_create.restype = ctypes.c_void_p
    lib.ip_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, _f32p, _f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_ulonglong, ctypes.c_int]
    lib.ip_loader_next.restype = ctypes.c_int
    lib.ip_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ip_loader_destroy.restype = None
    lib.ip_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.ip_loader_failures.restype = ctypes.c_long
    lib.ip_loader_failures.argtypes = [ctypes.c_void_p]
    return lib


def _as_f32p(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _as_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img


def preprocess_rgb(image: np.ndarray, out_size: int = 224,
                   mean: Sequence[float] = CLIP_MEAN,
                   std: Sequence[float] = CLIP_STD) -> np.ndarray:
    """uint8 HWC (or HW; floats in [0, 1] are scaled to bytes) -> float32
    CHW [3, out, out]."""
    lib = get_lib()
    img = np.ascontiguousarray(_as_uint8(np.asarray(image)))
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    out = np.empty((3, out_size, out_size), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    rc = lib.ip_preprocess_rgb(img.ctypes.data_as(_u8p), h, w, c, out_size,
                               _as_f32p(m), _as_f32p(s), _as_f32p(out))
    if rc != 0:
        raise RuntimeError(f"ip_preprocess_rgb failed: {rc}")
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 HWC RGB."""
    lib = get_lib()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = _u8p()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.ip_decode_jpeg(ctypes.cast(buf, _u8p), len(data),
                            ctypes.byref(out), ctypes.byref(h),
                            ctypes.byref(w))
    if rc != 0:
        raise RuntimeError(f"ip_decode_jpeg failed: {rc}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.ip_free(out)
    return arr


def decode_and_preprocess(data: bytes, out_size: int = 224,
                          mean: Sequence[float] = CLIP_MEAN,
                          std: Sequence[float] = CLIP_STD) -> np.ndarray:
    """JPEG bytes -> float32 CHW, fused decode+resize+normalize."""
    lib = get_lib()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = np.empty((3, out_size, out_size), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    rc = lib.ip_decode_preprocess(ctypes.cast(buf, _u8p), len(data), out_size,
                                  _as_f32p(m), _as_f32p(s), _as_f32p(out))
    if rc != 0:
        raise RuntimeError(f"ip_decode_preprocess failed: {rc}")
    return out


def preprocess_batch(images: np.ndarray, out_size: int = 224,
                     mean: Sequence[float] = CLIP_MEAN,
                     std: Sequence[float] = CLIP_STD,
                     n_threads: Optional[int] = None) -> np.ndarray:
    """uint8 NHWC -> float32 NCHW, threaded in native code."""
    lib = get_lib()
    imgs = np.ascontiguousarray(_as_uint8(np.asarray(images)))
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    n, h, w, c = imgs.shape
    out = np.empty((n, 3, out_size, out_size), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    rc = lib.ip_preprocess_batch(imgs.ctypes.data_as(_u8p), n, h, w, c,
                                 out_size, _as_f32p(m), _as_f32p(s),
                                 _as_f32p(out), n_threads)
    if rc != 0:
        raise RuntimeError(f"ip_preprocess_batch failed: {rc}")
    return out


def make_native_transform(out_size: int = 224, mean=CLIP_MEAN, std=CLIP_STD):
    """Drop-in for ``transforms.make_transform`` using the native pipeline."""
    def transform(image):
        if isinstance(image, (bytes, bytearray)):
            return decode_and_preprocess(bytes(image), out_size, mean, std)
        arr = np.asarray(image)
        if arr.ndim == 3 and arr.shape[0] in (1, 3):  # CHW -> HWC
            arr = arr.transpose(1, 2, 0)
        return preprocess_rgb(arr, out_size, mean, std)
    return transform


class NativeBatchLoader:
    """Asynchronous prefetching image-batch loader (``batch_loader.cpp``).

    A C++ worker pool reads, JPEG-decodes and preprocesses files ahead of
    the consumer into a bounded ring of ``queue_depth`` host batches;
    ``next()`` only copies a finished batch out (ctypes releases the GIL
    while it waits).  Yields float32 NCHW (normalized) or, with
    ``uint8_wire=True``, uint8 NCHW resized pixels for the activation
    store's uint8 wire (``sae/store.py``), which normalizes on the device.

    Epoch shuffling is deterministic from ``seed``; with ``n_workers > 1``
    batches are delivered in the order the workers finish them.  A file
    that cannot be read or decoded arrives as a zero image and counts in
    :meth:`decode_failures`.

    Pass an instance as the ``dataset`` of ``VisionActivationsStore``: the
    store takes the iterator protocol and keys its wire on ``dtype``.
    """

    def __init__(self, paths: Sequence[str], batch_size: int,
                 out_size: int = 224, mean: Sequence[float] = CLIP_MEAN,
                 std: Sequence[float] = CLIP_STD, n_workers: int = 4,
                 queue_depth: int = 4, seed: int = 0,
                 uint8_wire: bool = False):
        self._handle = None
        if len(paths) < batch_size:
            raise ValueError("need at least one full batch of paths")
        self.paths = [os.fspath(p) for p in paths]
        self.batch_size = batch_size
        self.out_size = out_size
        self.mean, self.std = mean, std
        self.uint8_wire = uint8_wire
        self.dtype = np.uint8 if uint8_wire else np.float32
        self._shape = (batch_size, 3, out_size, out_size)
        self._lib = get_lib()
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        m = np.asarray(mean, np.float32)
        s = np.asarray(std, np.float32)
        self._handle = self._lib.ip_loader_create(
            arr, len(self.paths), batch_size, out_size, _as_f32p(m),
            _as_f32p(s), n_workers, queue_depth, seed, 1 if uint8_wire else 0)
        if not self._handle:
            raise ValueError(
                f"ip_loader_create refused batch_size={batch_size}, out_size={out_size}, "
                f"n_workers={n_workers}, queue_depth={queue_depth}")

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise RuntimeError("NativeBatchLoader is closed")
        out = np.empty(self._shape, self.dtype)
        rc = self._lib.ip_loader_next(self._handle, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"ip_loader_next failed: {rc}")
        return out

    def decode_failures(self) -> int:
        """Files the native workers could not read/decode so far (each is
        also logged to stderr and delivered as a zero image)."""
        if self._handle is None:
            return 0
        return int(self._lib.ip_loader_failures(self._handle))

    def close(self):
        if self._handle is not None:
            self._lib.ip_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
