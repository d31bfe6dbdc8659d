"""B4, B5 and B6's float32 route as the package builds it (3xTF32 on tf32
wgmma, ``sae_fused_tf32.cu``) against other versions: each directory given
holds a copy of ``vit_prisma_tpu_torch/csrc`` (a parent commit's, unpacked
with ``git archive`` into the gitignored ``archive_run/``, whose float32
route is the FFMA tiles of ``sae_fused_fwd.cu`` and ``sae_fused_bwd.cu``; or
edited copies), each version's sources built alone.  At the all-layer
sweep's shape (24 x 4096 rows, 1024 -> 8192), two of its layers and the
TopK slice's (4096, 768 -> 12,288), with chip_smoke.py's inputs: each
version's errors against the plain versions (y and hc relative to max(1,
absmax), the grads to their absmax; B6 on the plain hc), the first 128 rows
and layer 0 alone against the whole call (to the bit), then CUDA-event
times in turns (package, others, others reversed, package) of B4, B6, B5,
B4 + B6 (the kernels of ``sae_fused_apply``'s forward and stored-acts
backward) and, at the TopK slice, B6 on the TopK h (B8's h from the plain
version, k 64), with the cuBLAS float32 products beside, the bound at
chip_smoke.py's peaks, the kernel names ``torch.profiler`` sees and each
version's ptxas registers and spills.  ``--check`` stops after the errors
and the ptxas records.  ``--bf16`` instead builds each version's bf16 routes
(``sae_fused_tc.cu``; ``sae_fused_fwd.cu`` and ``sae_fused_bwd.cu``'s
mma.sync tiles) and holds every version's B4, B6 and B5 outputs to the
package's, bit for bit, at the sweep's shape (the Hopper route) and a ViT-S
width (384 -> 6144, two layers: mma.sync), with their times in turns.
``--only topk`` instead times B8 and B9 (the TopK forward, k 64, and its
remat backward) as each version builds them (3xTF32 from
``sae_fused_tf32.cu``'s ``sae_fused_fwd_topk_tf32`` and
``sae_fused_bwd_topk_tf32`` where the version has them; else B8's FFMA tiles
of ``sae_fused_fwd_topk.cu`` and B9's FFMA recompute
``sae_fused_topk_remat_h`` of ``sae_fused_bwd.cu`` followed by
``sae_fused_tf32.cu``'s B6) at the TopK slice and the sweep's widths: each
version's errors against the plain versions (y on the rows whose mask
agrees, mask flips, t against the bitwise search on the version's own h,
-0 entries in h, B9 from t against B6 on h to the bit), then times in turns
with the cuBLAS float32 products and the bound beside; ``--only topk
--bf16`` holds every version's bf16 B8 and B9 (``sae_fused_tc.cu`` at the
TopK slice, the mma.sync files at a ViT-S width) to the package's, bit for
bit, with their times in turns.  ``--only gated`` does the same for B11
and B12 (the gated forward and its remat backward: 3xTF32 from
``sae_gated_fwd_tf32`` and ``sae_gated_bwd_tf32`` where the version's
``sae_fused_tf32.cu`` has them, else the FFMA tiles of
``sae_fused_fwd_gated.cu`` and ``sae_fused_bwd_gated.cu``) at the gated
slice (4096, 768 -> 12,288) and two layers of the sweep's widths: errors
against the plain versions (y and via on the rows whose masks agree, gate
and magnitude flips, nact against the version's own mask, the grads outside
the flipped features), B12's h and hga against B11's and two calls, to the
bit, then times in turns with the cuBLAS float32 products and the bound
beside (``--check``: the errors and ptxas only); ``--only gated --bf16``
holds every version's bf16 B11 and B12 (``sae_fused_tc.cu`` at the gated
slice, the mma.sync files at a ViT-S width) to the package's, bit for bit.
Prints JSON lines.  Run from the repository root on a CUDA card:
``python3 probes/sae_f32_versions.py [--check | --bf16 | --only topk|gated [--bf16]] [DIR ...]``."""

import ctypes
import json
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import BUILD, card, finish_build, ms, start_build  # noqa: E402

import chip_smoke  # noqa: E402  (on the path through _common)

PACKAGE = Path(__file__).resolve().parent.parent / "vit_prisma_tpu_torch" / "csrc"
# name: L, B, d_in, d_sae
SHAPES = {"sweep": (24, 4096, 1024, 8192), "two_layers": (2, 4096, 1024, 8192),
          "topk_slice": (1, 4096, 768, 12288)}
P, I = ctypes.c_void_p, ctypes.c_int


class Version:
    """One version's float32 B4, B6 and B5 through its C entries: the
    3xTF32 file where the version has one, else the FFMA files."""

    def __init__(self, name, d, j):
        self.name, self.tf32 = name, (d / "sae_fused_tf32.cu").exists()
        srcs = ["sae_fused_tf32.cu"] if self.tf32 else ["sae_fused_fwd.cu", "sae_fused_bwd.cu"]
        self.tags = [f"sae_f32_{j}_{k}" for k in range(len(srcs))]
        self.procs = [start_build(d / s, t) for s, t in zip(srcs, self.tags)]

    def finish(self):
        libs = [finish_build(p, t) for p, t in zip(self.procs, self.tags)]
        if any(lib is None for lib in libs):
            return False
        if self.tf32:
            self.lib = libs[0]
            self.lib.sae_fused_fwd_tf32.argtypes = [P] * 11 + [I] * 5 + [P]
            self.lib.sae_fused_bwd_stored_tf32.argtypes = [P] * 11 + [I] * 5 + [P]
            self.lib.sae_fused_bwd_remat_tf32.argtypes = [P] * 14 + [I] * 5 + [P]
        else:
            self.fwd, self.bwd = libs
            self.fwd.sae_fused_fwd.argtypes = [P] * 10 + [I] * 6 + [P]
            self.bwd.sae_fused_bwd.argtypes = [P] * 14 + [I] * 7 + [P]
        return True

    def ptxas(self):
        """Registers and spill bytes of the float32 kernels (the 3xTF32
        kernel's modes, or the FFMA tiles' float instantiations)."""
        out, fn = {}, None
        pat = r"Function properties for \S*?(sae_tf32_kernelILi\d|\w+_kernelIfL?i?\d*E?\w*)"
        for tag in self.tags:
            text = (BUILD / f"{tag}.log").read_text()
            for line in text.splitlines():
                if "Function properties for" in line:
                    m = re.search(pat, line)
                    fn = m.group(1)[:40] if m else None
                elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                            line)):
                    out[fn] = {"spill_bytes": int(m.group(1)) + int(m.group(2))}
                elif fn and fn in out and (m := re.search(r"Used (\d+) registers", line)):
                    out[fn]["registers"] = int(m.group(1))
            out.setdefault("wgmma_serialized", []).extend(
                l.strip()[:160] for l in text.splitlines() if "wgmma" in l and "serialized" in l)
        return out

    def _call(self, lib, fn, *args):
        rc = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.name} {fn}: CUDA error {rc}")

    def forward(self, x, We, be, Wd, bd):
        """B4: (y, l1, nact, hc)."""
        from vit_prisma_tpu_torch.ops.sae_step import _tf32_scratch_floats
        L, B, D = x.shape
        S = We.shape[-1]
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device="cuda")
        xc, hc, y = new(L, B, D), new(L, B, S), new(L, B, D)
        nact, l1 = new(L, B // 128, S), new(L, B // 128, S // 128)
        ptrs = [t.data_ptr() for t in (x, We, be, Wd, bd, xc, hc, y, nact, l1)]
        if self.tf32:
            split = new(_tf32_scratch_floats(False, L, B, D, S))
            self._call(self.lib, "sae_fused_fwd_tf32", *ptrs, split.data_ptr(), L, B, D, S, 0)
        else:
            self._call(self.fwd, "sae_fused_fwd", *ptrs, L, B, D, S, 0, 0)
        return y, l1.sum(dim=(1, 2)), nact.sum(dim=1), hc

    def backward(self, x, Wd, bd, dy, dl1, hc=None, We=None, be=None):
        """B6 from the stored ``hc``, or B5 (``We``, ``be`` given)."""
        from vit_prisma_tpu_torch.ops.sae_step import _tf32_scratch_floats
        L, B, D = x.shape
        S = Wd.shape[1]
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device="cuda")
        remat = hc is None
        hc = new(L, B, S) if remat else hc
        xc, dhc = new(L, B, D), new(L, B, S)
        dWe, dWd, dbe = new(L, D, S), new(L, S, D), new(L, B // 128, S)
        outs = [t.data_ptr() for t in (dWe, dWd, dbe)]
        if self.tf32:
            split = new(_tf32_scratch_floats(True, L, B, D, S))  # held until the call returns
            if remat:
                self._call(self.lib, "sae_fused_bwd_remat_tf32",
                           *(t.data_ptr() for t in (x, We, be, Wd, bd, dy, dl1, xc, hc, dhc)),
                           split.data_ptr(), *outs, L, B, D, S, 0)
            else:
                self._call(self.lib, "sae_fused_bwd_stored_tf32",
                           *(t.data_ptr() for t in (x, hc, Wd, bd, dy, dl1, dhc)),
                           split.data_ptr(), *outs, L, B, D, S, 0)
        else:
            w = (We, be) if remat else (hc, hc)
            self._call(self.bwd, "sae_fused_bwd",
                       *(t.data_ptr() for t in (x, *w, Wd, bd, dy, dl1)), 0,
                       *(t.data_ptr() for t in (hc, xc, dhc)), *outs, L, B, D, S, 0,
                       1 if remat else 0, 0)
        return dWe, dWd, dbe.sum(dim=1)


class Bf16Version:
    """One version's bf16 B4, B6 and B5 through its C entries: the Hopper
    route's file and the mma.sync files."""

    def __init__(self, name, d, j):
        self.name = name
        self.tags = [f"sae_bf16_{j}_{k}" for k in range(3)]
        self.procs = [start_build(d / s, t) for s, t in
                      zip(("sae_fused_tc.cu", "sae_fused_fwd.cu", "sae_fused_bwd.cu"), self.tags)]

    def finish(self):
        libs = [finish_build(p, t) for p, t in zip(self.procs, self.tags)]
        if any(lib is None for lib in libs):
            return False
        self.tc, self.fwd, self.bwd = libs
        self.tc.sae_fused_fwd_tc.argtypes = [P] * 10 + [I] * 5 + [P]
        self.tc.sae_fused_bwd_stored_tc.argtypes = [P] * 11 + [I] * 5 + [P]
        self.tc.sae_fused_bwd_remat_tc.argtypes = [P] * 13 + [I] * 5 + [P]
        self.fwd.sae_fused_fwd.argtypes = [P] * 10 + [I] * 6 + [P]
        self.bwd.sae_fused_bwd.argtypes = [P] * 14 + [I] * 7 + [P]
        return True

    _call = Version._call

    def forward(self, x, We, be, Wd, bd, tc):
        L, B, D = x.shape
        S = We.shape[-1]
        new = lambda *shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt, device="cuda")
        xc, hc, y = new(L, B, D), new(L, B, S), new(L, B, D)
        nact = new(L, B // 128, S, dt=torch.float32)
        l1 = new(L, B // 128, S // (256 if tc else 128), dt=torch.float32)
        ptrs = [t.data_ptr() for t in (x, We, be, Wd, bd, xc, hc, y, nact, l1)]
        if tc:
            self._call(self.tc, "sae_fused_fwd_tc", *ptrs, L, B, D, S, 0)
        else:
            self._call(self.fwd, "sae_fused_fwd", *ptrs, L, B, D, S, 1, 0)
        return y, l1, nact, hc

    def backward(self, x, Wd, bd, dy, dl1, tc, hc=None, We=None, be=None):
        L, B, D = x.shape
        S = Wd.shape[1]
        new = lambda *shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt, device="cuda")
        remat = hc is None
        hc = new(L, B, S) if remat else hc
        xc, dhc = new(L, B, D), new(L, B, S)
        outs = [new(L, D, S, dt=torch.float32), new(L, S, D, dt=torch.float32),
                new(L, B // 128, S, dt=torch.float32)]
        o = [t.data_ptr() for t in outs]
        if tc and remat:
            self._call(self.tc, "sae_fused_bwd_remat_tc", *(t.data_ptr() for t in (
                x, We, be, Wd, bd, dy, dl1, xc, hc, dhc)), *o, L, B, D, S, 0)
        elif tc:
            self._call(self.tc, "sae_fused_bwd_stored_tc", *(t.data_ptr() for t in (
                x, hc, Wd, bd, dy, dl1, xc, dhc)), *o, L, B, D, S, 0)
        else:
            w = (We, be) if remat else (hc, hc)
            self._call(self.bwd, "sae_fused_bwd",
                       *(t.data_ptr() for t in (x, *w, Wd, bd, dy, dl1)), 0,
                       *(t.data_ptr() for t in (hc, xc, dhc)), *o, L, B, D, S, 1,
                       1 if remat else 0, 0)
        return outs


class TopkVersion(Version):
    """One version's float32 B8 and B9 through its C entries: the 3xTF32
    entries where the version's sae_fused_tf32.cu has them, else B8's FFMA
    file, and B9's FFMA recompute then the 3xTF32 B6."""

    def __init__(self, name, d, j):
        self.name = name
        self.tf32 = "sae_fused_fwd_topk_tf32" in (d / "sae_fused_tf32.cu").read_text()
        srcs = (["sae_fused_tf32.cu"] if self.tf32
                else ["sae_fused_tf32.cu", "sae_fused_fwd_topk.cu", "sae_fused_bwd.cu"])
        self.tags = [f"sae_topk_{j}_{k}" for k in range(len(srcs))]
        self.procs = [start_build(d / s, t) for s, t in zip(srcs, self.tags)]

    def finish(self):
        libs = [finish_build(p, t) for p, t in zip(self.procs, self.tags)]
        if any(lib is None for lib in libs):
            return False
        self.lib = libs[0]
        self.lib.sae_fused_bwd_stored_tf32.argtypes = [P] * 11 + [I] * 5 + [P]
        if self.tf32:
            self.lib.sae_fused_fwd_topk_tf32.argtypes = [P] * 12 + [I] * 6 + [P]
            self.lib.sae_fused_bwd_topk_tf32.argtypes = [P] * 15 + [I] * 5 + [P]
        else:
            self.fwd, self.bwd = libs[1:]
            self.fwd.sae_fused_fwd_topk.argtypes = [P] * 11 + [I] * 7 + [P]
            self.bwd.sae_fused_topk_remat_h.argtypes = [P] * 7 + [I] * 5 + [P]
        return True

    def forward(self, x, We, be, Wd, bd, k):
        """B8: (y, l1, nact, t, h)."""
        from vit_prisma_tpu_torch.ops.sae_step import _tf32_scratch_floats
        L, B, D = x.shape
        S = We.shape[-1]
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device="cuda")
        xc, h, y, t = new(L, B, D), new(L, B, S), new(L, B, D), new(L, B, 1)
        nact, l1 = new(L, B // 128, S), new(L, B // 128, S // 128)
        ptrs = [v.data_ptr() for v in (x, We, be, Wd, bd, xc, h, y, t, nact, l1)]
        if self.tf32:
            split = new(_tf32_scratch_floats(False, L, B, D, S))
            self._call(self.lib, "sae_fused_fwd_topk_tf32", *ptrs, split.data_ptr(), L, B, D, S,
                       k, 0)
        else:
            self._call(self.fwd, "sae_fused_fwd_topk", *ptrs, L, B, D, S, k, 0, 0)
        return y, l1.sum(dim=(1, 2)), nact.sum(dim=1), t, h

    def backward(self, x, Wd, bd, dy, dl1, h=None, We=None, be=None, t=None):
        """B6 from the stored ``h``, or B9 (``We``, ``be`` and ``t`` given)."""
        from vit_prisma_tpu_torch.ops.sae_step import _tf32_scratch_floats
        L, B, D = x.shape
        S = Wd.shape[1]
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device="cuda")
        xc, dhc = new(L, B, D), new(L, B, S)
        dWe, dWd, dbe = new(L, D, S), new(L, S, D), new(L, B // 128, S)
        outs = [v.data_ptr() for v in (dWe, dWd, dbe)]
        split = new(_tf32_scratch_floats(True, L, B, D, S))  # held until the calls return
        if h is None and self.tf32:
            h = new(L, B, S)
            self._call(self.lib, "sae_fused_bwd_topk_tf32", *(v.data_ptr() for v in (
                x, We, be, Wd, bd, dy, dl1, t, xc, h, dhc, split)), *outs, L, B, D, S, 0)
            return dWe, dWd, dbe.sum(dim=1)
        if h is None:  # the FFMA recompute of B8's h, then B6
            h = new(L, B, S)
            self._call(self.bwd, "sae_fused_topk_remat_h", *(v.data_ptr() for v in (
                x, We, be, bd, t, xc, h)), L, B, D, S, 0)
        self._call(self.lib, "sae_fused_bwd_stored_tf32",
                   *(v.data_ptr() for v in (x, h, Wd, bd, dy, dl1, dhc, split)), *outs,
                   L, B, D, S, 0)
        return dWe, dWd, dbe.sum(dim=1)


class Bf16TopkVersion:
    """One version's bf16 B8 and B9 through its C entries: the Hopper
    route's file and the mma.sync files."""

    def __init__(self, name, d, j):
        self.name = name
        self.tags = [f"sae_topk_bf16_{j}_{k}" for k in range(3)]
        self.procs = [start_build(d / s, t) for s, t in zip(
            ("sae_fused_tc.cu", "sae_fused_fwd_topk.cu", "sae_fused_bwd.cu"), self.tags)]

    def finish(self):
        libs = [finish_build(p, t) for p, t in zip(self.procs, self.tags)]
        if any(lib is None for lib in libs):
            return False
        self.tc, self.fwd, self.bwd = libs
        self.tc.sae_fused_fwd_topk_tc.argtypes = [P] * 11 + [I] * 6 + [P]
        self.tc.sae_fused_bwd_topk_tc.argtypes = [P] * 14 + [I] * 5 + [P]
        self.fwd.sae_fused_fwd_topk.argtypes = [P] * 11 + [I] * 7 + [P]
        self.bwd.sae_fused_bwd.argtypes = [P] * 14 + [I] * 7 + [P]
        return True

    _call = Version._call

    def forward(self, x, We, be, Wd, bd, k, tc):
        """B8: (y, h, t, nact_part, l1_part)."""
        L, B, D = x.shape
        S = We.shape[-1]
        new = lambda *shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt, device="cuda")
        xc, h, y = new(L, B, D), new(L, B, S), new(L, B, D)
        t = new(L, B, 1, dt=torch.float32)
        nact, l1 = new(L, B // 128, S, dt=torch.float32), new(L, B // 128, S // 128,
                                                              dt=torch.float32)
        ptrs = [v.data_ptr() for v in (x, We, be, Wd, bd, xc, h, y, t, nact, l1)]
        if tc:
            self._call(self.tc, "sae_fused_fwd_topk_tc", *ptrs, L, B, D, S, k, 0)
        else:
            self._call(self.fwd, "sae_fused_fwd_topk", *ptrs, L, B, D, S, k, 1, 0)
        return y, h, t, nact, l1

    def backward(self, x, We, be, Wd, bd, dy, dl1, t, tc):
        """B9 from t: (dW_enc, dW_dec, db_enc partials)."""
        L, B, D = x.shape
        S = We.shape[-1]
        new = lambda *shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt, device="cuda")
        xc, h, dhc = new(L, B, D), new(L, B, S), new(L, B, S)
        outs = [new(L, D, S, dt=torch.float32), new(L, S, D, dt=torch.float32),
                new(L, B // 128, S, dt=torch.float32)]
        o = [v.data_ptr() for v in outs]
        if tc:
            self._call(self.tc, "sae_fused_bwd_topk_tc", *(v.data_ptr() for v in (
                x, We, be, Wd, bd, dy, dl1, t, xc, h, dhc)), *o, L, B, D, S, 0)
        else:
            self._call(self.bwd, "sae_fused_bwd", *(v.data_ptr() for v in (
                x, We, be, Wd, bd, dy, dl1, t, h, xc, dhc)), *o, L, B, D, S, 1, 2, 0)
        return outs


class GatedVersion(Version):
    """One version's float32 B11 and B12 through its C entries: the 3xTF32
    entries where the version's sae_fused_tf32.cu has them, else the FFMA
    files (dtype 0)."""

    def __init__(self, name, d, j):
        self.name = name
        self.tf32 = "sae_gated_fwd_tf32" in (d / "sae_fused_tf32.cu").read_text()
        srcs = (["sae_fused_tf32.cu"] if self.tf32
                else ["sae_fused_fwd_gated.cu", "sae_fused_bwd_gated.cu"])
        self.tags = [f"sae_gated_{j}_{k}" for k in range(len(srcs))]
        self.procs = [start_build(d / s, t) for s, t in zip(srcs, self.tags)]

    def finish(self):
        libs = [finish_build(p, t) for p, t in zip(self.procs, self.tags)]
        if any(lib is None for lib in libs):
            return False
        if self.tf32:
            self.fwd = self.bwd = libs[0]
            self.fwd.sae_gated_fwd_tf32.argtypes = [P] * 14 + [I] * 5 + [P]
            self.bwd.sae_gated_bwd_tf32.argtypes = [P] * 20 + [I] * 5 + [P]
        else:
            self.fwd, self.bwd = libs
            self.fwd.sae_fused_fwd_gated.argtypes = [P] * 13 + [I] * 6 + [P]
            self.bwd.sae_fused_bwd_gated.argtypes = [P] * 19 + [I] * 6 + [P]
        return True

    def forward(self, x, We, bg, rmag, bm, Wd, bd):
        """B11: (y, via, l1, nact, h, hga)."""
        from vit_prisma_tpu_torch.ops import sae_step as S
        L, B, D = x.shape
        Sd = We.shape[-1]
        e, wdn = S._gated_hoisted_card(rmag, Wd)
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device="cuda")
        xc, h, y = new(L, B, D), new(L, 2 * B, Sd), new(L, 2 * B, D)
        nact, l1 = new(L, B // 128, Sd), new(L, B // 128, Sd // 128)
        ptrs = [v.data_ptr() for v in (x, We, bg, e, bm, Wd, bd, wdn, xc, h, y, nact, l1)]
        if self.tf32:
            split = new(S._tf32_scratch_floats(False, L, B, D, Sd, "gated"))
            self._call(self.fwd, "sae_gated_fwd_tf32", *ptrs, split.data_ptr(), L, B, D, Sd, 0)
        else:
            self._call(self.fwd, "sae_fused_fwd_gated", *ptrs, L, B, D, Sd, 0, 0)
        return y[:, :B], y[:, B:], l1.sum(dim=(1, 2)), nact.sum(dim=1), h[:, :B], h[:, B:]

    def backward(self, x, We, bg, rmag, bm, Wd, bd, dy, dvia, dl1):
        """B12: the five grads, then h and hga as it recomputed them."""
        from vit_prisma_tpu_torch.ops import sae_step as S
        L, B, D = x.shape
        Sd = We.shape[-1]
        e, wdn = S._gated_hoisted_card(rmag, Wd)
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device="cuda")
        xc, dg = new(L, B, D), new(L, B, Sd)
        part, sums = new(4, L, B // 128, Sd), new(4, L, Sd)
        dWe, dWd = new(L, D, Sd), new(L, Sd, D)
        ins = [v.data_ptr() for v in (x, We, bg, e, bm, Wd, bd, wdn, dy, dvia, dl1, xc)]
        outs = [v.data_ptr() for v in (dg, part, sums, dWe, dWd)]
        if self.tf32:
            h, g = new(L, 2 * B, Sd), new(L, B, Sd)
            split = new(S._tf32_scratch_floats(True, L, B, D, Sd, "gated"))  # held to the end
            self._call(self.bwd, "sae_gated_bwd_tf32", *ins, h.data_ptr(), g.data_ptr(), *outs,
                       split.data_ptr(), L, B, D, Sd, 0)
            hc, hga = h[:, :B], h[:, B:]
        else:
            hc, hga = new(L, B, Sd), new(L, B, Sd)
            self._call(self.bwd, "sae_fused_bwd_gated", *ins, hc.data_ptr(), hga.data_ptr(),
                       *outs, L, B, D, Sd, 0, 0)
        return (dWe, dWd, sums[1], sums[2], sums[3] * e), (hc, hga)


class Bf16GatedVersion:
    """One version's bf16 B11 and B12 through its C entries: the Hopper
    route's file and the mma.sync files."""

    def __init__(self, name, d, j):
        self.name = name
        self.tags = [f"sae_gated_bf16_{j}_{k}" for k in range(3)]
        self.procs = [start_build(d / s, t) for s, t in zip(
            ("sae_fused_tc.cu", "sae_fused_fwd_gated.cu", "sae_fused_bwd_gated.cu"), self.tags)]

    def finish(self):
        libs = [finish_build(p, t) for p, t in zip(self.procs, self.tags)]
        if any(lib is None for lib in libs):
            return False
        self.tc, self.fwd, self.bwd = libs
        self.tc.sae_gated_fwd_tc.argtypes = [P] * 13 + [I] * 5 + [P]
        self.tc.sae_gated_bwd_tc.argtypes = [P] * 19 + [I] * 5 + [P]
        self.fwd.sae_fused_fwd_gated.argtypes = [P] * 13 + [I] * 6 + [P]
        self.bwd.sae_fused_bwd_gated.argtypes = [P] * 19 + [I] * 6 + [P]
        return True

    _call = Version._call

    def forward(self, x, We, bg, e, bm, Wd, bd, wdn, tc):
        """B11: (y and via stacked, h and hga stacked, nact_part, l1_part)."""
        L, B, D = x.shape
        Sd = We.shape[-1]
        new = lambda *shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt, device="cuda")
        xc, h, y = new(L, B, D), new(L, 2 * B, Sd), new(L, 2 * B, D)
        nact = new(L, B // 128, Sd, dt=torch.float32)
        l1 = new(L, B // 128, Sd // (256 if tc else 128), dt=torch.float32)
        ptrs = [v.data_ptr() for v in (x, We, bg, e, bm, Wd, bd, wdn, xc, h, y, nact, l1)]
        if tc:
            self._call(self.tc, "sae_gated_fwd_tc", *ptrs, L, B, D, Sd, 0)
        else:
            self._call(self.fwd, "sae_fused_fwd_gated", *ptrs, L, B, D, Sd, 1, 0)
        return y, h, nact, l1

    def backward(self, x, We, bg, e, bm, Wd, bd, wdn, dy, dvia, dl1, tc):
        """B12: dW_enc, dW_dec, the sums and the recomputed activations."""
        L, B, D = x.shape
        Sd = We.shape[-1]
        new = lambda *shape, dt=torch.bfloat16: torch.empty(shape, dtype=dt, device="cuda")
        f32 = torch.float32
        xc, dgc = new(L, B, D), new(L, B, Sd)
        part, sums = new(4, L, B // 128, Sd, dt=f32), new(4, L, Sd, dt=f32)
        dWe, dWd = new(L, D, Sd, dt=f32), new(L, Sd, D, dt=f32)
        ins = [v.data_ptr() for v in (x, We, bg, e, bm, Wd, bd, wdn, dy, dvia, dl1, xc)]
        outs = [v.data_ptr() for v in (dgc, part, sums, dWe, dWd)]
        if tc:
            h, g = new(L, 2 * B, Sd), new(L, B, Sd, dt=f32)
            self._call(self.tc, "sae_gated_bwd_tc", *ins, h.data_ptr(), g.data_ptr(), *outs,
                       L, B, D, Sd, 0)
            acts = (h,)
        else:
            hc, hga = new(L, B, Sd), new(L, B, Sd)
            self._call(self.bwd, "sae_fused_bwd_gated", *ins, hc.data_ptr(), hga.data_ptr(),
                       *outs, L, B, D, Sd, 1, 0)
            acts = (hc, hga)
        return (dWe, dWd, sums, dgc, *acts)


def _gated_inputs(g, L, B, D, Sd, dtype):
    """chip_smoke.py's gated kernel phase inputs: _sae_inputs, then r_mag,
    b_mag and dvia."""
    x, We, bg, Wd, bd, dy, dl1 = chip_smoke._sae_inputs(g, L, B, D, Sd, dtype)
    r = lambda *shape, sc: (torch.randn(*shape, generator=g, device="cuda") * sc).to(dtype)
    rmag, bm, dvia = r(L, Sd, sc=0.1), r(L, Sd, sc=0.01), r(L, B, D, sc=1e-3)
    return (x, We, bg, rmag, bm, Wd, bd), (dy, dvia, dl1)


GATED_SHAPES = {"gated_slice": (1, 4096, 768, 12288), "sweep_widths": (2, 4096, 1024, 8192)}


def gated_bf16_main(dirs):
    """Every version's bf16 B11 and B12 against the package's, bit for bit,
    and their times in turns."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    versions = {n: Bf16GatedVersion(n, d, j) for j, (n, d) in enumerate(dirs.items())}
    for n in list(versions):
        ok = versions[n].finish()
        print(json.dumps({"version": n, "built": ok}), flush=True)
        if not ok:
            del versions[n]
    print(json.dumps({"card": card(), "versions": list(versions)}), flush=True)
    names = list(versions)
    g = torch.Generator(device="cuda").manual_seed(4)
    for shape, (L, B, D, Sd), tc in (("gated_slice_bf16", GATED_SHAPES["gated_slice"], True),
                                     ("vit_s_bf16", (1, 4096, 384, 6144), False)):
        args, (dy, dvia, dl1) = _gated_inputs(g, L, B, D, Sd, torch.bfloat16)
        x, We, bg, rmag, bm, Wd, bd = args
        e, wdn = S._gated_hoisted_card(rmag, Wd)
        calls = {"B11": lambda v: v.forward(x, We, bg, e, bm, Wd, bd, wdn, tc),
                 "B12": lambda v: v.backward(x, We, bg, e, bm, Wd, bd, wdn, dy, dvia, dl1, tc)}
        rec = {"shape": shape, "L": L, "B": B, "d_in": D, "d_sae": Sd,
               "route": "wgmma" if tc else "mma_sync", "equal_to_package": {}, "ms": {}}
        for kernel, fn in calls.items():
            want = fn(versions["package"])
            rec["equal_to_package"][kernel] = {
                n: all(torch.equal(a, b) for a, b in zip(fn(v), want)) for n, v in versions.items()}
            del want
            tt = {n: [] for n in names}
            for n in names + names[::-1]:
                tt[n].append(ms(lambda: fn(versions[n]), iters=10, warmup=1))
            rec["ms"][kernel] = tt
        print(json.dumps(rec), flush=True)
        del x, We, bg, rmag, bm, Wd, bd, dy, dvia, dl1, e, wdn, args
        torch.cuda.empty_cache()
    return 0


def gated_main(dirs, check):
    """Every version's float32 B11 and B12 against the plain versions, and
    their times in turns, at the gated slice and the sweep's widths."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    versions = {n: GatedVersion(n, d, j) for j, (n, d) in enumerate(dirs.items())}
    for n in list(versions):
        ok = versions[n].finish()
        print(json.dumps({"version": n, "built": ok, "tf32": versions[n].tf32,
                          "ptxas": versions[n].ptxas() if ok else None}), flush=True)
        if not ok:
            del versions[n]
    print(json.dumps({"card": card(), "versions": list(versions)}), flush=True)
    names = list(versions)
    g = torch.Generator(device="cuda").manual_seed(4)
    for shape, (L, B, D, Sd) in GATED_SHAPES.items():
        args, (dy, dvia, dl1) = _gated_inputs(g, L, B, D, Sd, torch.float32)
        x, We, bg, rmag, bm, Wd, bd = args
        yr, viar, l1r, nactr, hr, hgar = S.sae_gated_fused_forward_reference(*args, save_h=True)
        want = S.sae_gated_fused_backward_reference(*args, dy, dvia, dl1)
        rec = {"shape": shape, "L": L, "B": B, "d_in": D, "d_sae": Sd, "errors": {},
               "tol": {"y_via": chip_smoke.SAE_REL[torch.float32],
                       "grads": chip_smoke.SAE_GRAD_REL[torch.float32]}}
        for n, v in versions.items():
            y, via, l1, nact, h, hga = v.forward(*args)
            gflip, mflip = (hga > 0) != (hgar > 0), (h > 0) != (hr > 0)
            rows = (gflip | mflip).any(dim=-1)
            clean = ~(gflip | mflip).any(dim=1)  # [L, S]
            keep = {0: clean[:, None, :], 1: clean[:, :, None]}
            grads, (h12, hga12) = v.backward(*args, dy, dvia, dl1)
            grads2, _ = v.backward(*args, dy, dvia, dl1)
            out = lambda a, b: (a - b).abs()[~rows].max().item() / max(1.0, b.abs().max().item())
            rec["errors"][n] = {
                "y_unflipped_rows": out(y, yr), "via_unflipped_rows": out(via, viar),
                "gate_flips": int(gflip.sum()), "magnitude_flips": int(mflip.sum()),
                "rows_with_flips": int(rows.sum()),
                "l1_rel": ((l1 - l1r).abs() / l1r.abs()).max().item(),
                "nact_is_own_mask": torch.equal(nact, (h > 0).sum(dim=1, dtype=torch.float32)),
                "grads_unflipped": [((a - b).abs() * keep.get(i, clean)).max().item()
                                    / b.abs().max().item()
                                    for i, (a, b) in enumerate(zip(grads, want))],
                "b12_acts_equal_b11": torch.equal(h12, h) and torch.equal(hga12, hga),
                "b12_two_calls_equal": all(torch.equal(a, b) for a, b in zip(grads, grads2))}
            del y, via, l1, nact, h, hga, grads, grads2, h12, hga12
        if not check:
            flop = 2 * L * B * D * Sd
            xc, WdT = x - bd[:, None], Wd.transpose(1, 2)
            calls = {"B11": (lambda v: v.forward(*args), [(xc, We), (hr, Wd), (hgar, Wd)], 3),
                     "B12": (lambda v: v.backward(*args, dy, dvia, dl1),
                             [(xc, We), (dy, WdT), (dvia, WdT), (xc.transpose(1, 2), hgar),
                              (hr.transpose(1, 2), dy), (hgar.transpose(1, 2), dvia)], 6)}
            iters = 10 if L == 1 else 5
            times = {}
            for kernel, (fn, products, n_products) in calls.items():
                tt = {n: [] for n in names}
                for n in names + names[::-1]:
                    tt[n].append(ms(lambda: fn(versions[n]), iters=iters, warmup=1))
                n_flop = n_products * flop
                times[kernel] = {"ms": tt, "TFLOP_per_s": {n: n_flop / min(v) / 1e9
                                                           for n, v in tt.items()},
                                 "bound": chip_smoke.bound(0, [("f32_product", n_flop)]),
                                 "cublas_products_ms": ms(
                                     lambda: [torch.matmul(a, b) for a, b in products],
                                     iters=iters, warmup=1),
                                 "kernels": [kn[:70] for kn in chip_smoke.kernel_names(
                                     lambda: fn(versions["package"]))]}
            rec["times"] = times
            del xc, WdT
        print(json.dumps(rec), flush=True)
        del x, We, bg, rmag, bm, Wd, bd, dy, dvia, dl1, args, yr, viar, hr, hgar, want
        torch.cuda.empty_cache()
    return 0


def topk_bf16_main(dirs):
    """Every version's bf16 B8 and B9 against the package's, bit for bit,
    and their times in turns."""
    versions = {n: Bf16TopkVersion(n, d, j) for j, (n, d) in enumerate(dirs.items())}
    for n in list(versions):
        ok = versions[n].finish()
        print(json.dumps({"version": n, "built": ok}), flush=True)
        if not ok:
            del versions[n]
    print(json.dumps({"card": card(), "versions": list(versions)}), flush=True)
    names = list(versions)
    k = chip_smoke.TOPK_K
    g = torch.Generator(device="cuda").manual_seed(4)
    for shape, (L, B, D, Sd), tc in (("topk_slice_bf16", SHAPES["topk_slice"], True),
                                     ("vit_s_bf16", (1, 4096, 384, 6144), False)):
        x, We, be, Wd, bd, dy, dl1 = chip_smoke._sae_inputs(g, L, B, D, Sd, torch.bfloat16)
        t = versions["package"].forward(x, We, be, Wd, bd, k, tc)[2]
        calls = {"B8": lambda v: v.forward(x, We, be, Wd, bd, k, tc),
                 "B9": lambda v: v.backward(x, We, be, Wd, bd, dy, dl1, t, tc)}
        rec = {"shape": shape, "L": L, "B": B, "d_in": D, "d_sae": Sd, "k": k,
               "route": "wgmma" if tc else "mma_sync", "equal_to_package": {}, "ms": {}}
        for kernel, fn in calls.items():
            want = fn(versions["package"])
            rec["equal_to_package"][kernel] = {
                n: all(torch.equal(a, b) for a, b in zip(fn(v), want)) for n, v in versions.items()}
            del want
            tt = {n: [] for n in names}
            for n in names + names[::-1]:
                tt[n].append(ms(lambda: fn(versions[n]), iters=10, warmup=1))
            rec["ms"][kernel] = tt
        print(json.dumps(rec), flush=True)
        del x, We, be, Wd, bd, dy, dl1, t
        torch.cuda.empty_cache()
    return 0


def topk_main(dirs):
    """Every version's float32 B8 and B9 against the plain versions, and
    their times in turns, at the TopK slice and the sweep's widths."""
    from vit_prisma_tpu_torch.ops import sae_step as S
    versions = {n: TopkVersion(n, d, j) for j, (n, d) in enumerate(dirs.items())}
    for n in list(versions):
        ok = versions[n].finish()
        print(json.dumps({"version": n, "built": ok, "tf32": versions[n].tf32,
                          "ptxas": versions[n].ptxas() if ok else None}), flush=True)
        if not ok:
            del versions[n]
    print(json.dumps({"card": card(), "versions": list(versions)}), flush=True)
    names = list(versions)
    k = chip_smoke.TOPK_K
    g = torch.Generator(device="cuda").manual_seed(4)
    for shape, (L, B, D, Sd) in (("topk_slice", SHAPES["topk_slice"]), ("sweep", SHAPES["sweep"])):
        x, We, be, Wd, bd, dy, dl1 = chip_smoke._sae_inputs(g, L, B, D, Sd, torch.float32)
        yr, _, _, _, hr = S.sae_fused_forward_topk_reference(x, We, be, Wd, bd, k, save_h=True)
        rec = {"shape": shape, "L": L, "B": B, "d_in": D, "d_sae": Sd, "k": k, "errors": {}}
        for n, v in versions.items():
            y, l1, nact, t, h = v.forward(x, We, be, Wd, bd, k)
            flip_rows = ((h > 0) != (hr > 0)).any(dim=-1)
            g6 = v.backward(x, Wd, bd, dy, dl1, h=h)
            g9 = v.backward(x, Wd, bd, dy, dl1, We=We, be=be, t=t)
            rec["errors"][n] = {
                "y_unflipped_rows": ((y - yr).abs()[~flip_rows].max().item()
                                     / max(1.0, yr.abs().max().item())),
                "mask_flips": int(((h > 0) != (hr > 0)).sum()),
                "rows_with_flips": int(flip_rows.sum()),
                "t_is_k_th_of_own_h": torch.equal(t, S._row_threshold(h, k)),
                "h_minus_zeros": int(torch.signbit(h).sum()),
                "nact_is_own_mask": torch.equal(nact, (h > 0).sum(dim=1, dtype=torch.float32)),
                "b9_equals_b6_on_h": all(torch.equal(a, b) for a, b in zip(g9, g6))}
            del y, l1, nact, h, g6, g9
        _, _, _, t, h = versions["package"].forward(x, We, be, Wd, bd, k)
        flop = 2 * L * B * D * Sd
        xc = x - bd[:, None]
        dhc = torch.where(h > 0, S._mm(dy, Wd.transpose(1, 2)) + dl1[:, None, None], 0.0)
        calls = {"B8": (lambda v: v.forward(x, We, be, Wd, bd, k), [(xc, We), (h, Wd)], 2),
                 "B9": (lambda v: v.backward(x, Wd, bd, dy, dl1, We=We, be=be, t=t),
                        [(xc, We), (dy, Wd.transpose(1, 2)), (xc.transpose(1, 2), dhc),
                         (h.transpose(1, 2), dy)], 4)}
        iters = 3 if L > 2 else 10
        times = {}
        for kernel, (fn, products, n_products) in calls.items():
            tt = {n: [] for n in names}
            for n in names + names[::-1]:
                tt[n].append(ms(lambda: fn(versions[n]), iters=iters, warmup=1))
            n_flop = n_products * flop
            times[kernel] = {"ms": tt, "TFLOP_per_s": {n: n_flop / min(v) / 1e9
                                                       for n, v in tt.items()},
                             "bound": chip_smoke.bound(0, [("f32_product", n_flop)]),
                             "cublas_products_ms": ms(
                                 lambda: [torch.matmul(a, b) for a, b in products], iters=iters,
                                 warmup=1),
                             "kernels": [kn[:70] for kn in chip_smoke.kernel_names(
                                 lambda: fn(versions["package"]))]}
        rec["times"] = times
        print(json.dumps(rec), flush=True)
        del x, We, be, Wd, bd, dy, dl1, yr, hr, t, h, xc, dhc
        torch.cuda.empty_cache()
    return 0


def bf16_main(dirs):
    """Every version's bf16 B4, B6, B5 against the package's, bit for bit,
    and their times in turns."""
    versions = {n: Bf16Version(n, d, j) for j, (n, d) in enumerate(dirs.items())}
    for n in list(versions):
        ok = versions[n].finish()
        print(json.dumps({"version": n, "built": ok}), flush=True)
        if not ok:
            del versions[n]
    print(json.dumps({"card": card(), "versions": list(versions)}), flush=True)
    names = list(versions)
    g = torch.Generator(device="cuda").manual_seed(4)
    for shape, (L, B, D, Sd), tc in (("sweep_bf16", SHAPES["sweep"], True),
                                     ("vit_s_bf16", (2, 4096, 384, 6144), False)):
        x, We, be, Wd, bd, dy, dl1 = chip_smoke._sae_inputs(g, L, B, D, Sd, torch.bfloat16)
        hc = versions["package"].forward(x, We, be, Wd, bd, tc)[3]
        calls = {"B4": lambda v: v.forward(x, We, be, Wd, bd, tc),
                 "B6": lambda v: v.backward(x, Wd, bd, dy, dl1, tc, hc=hc),
                 "B5": lambda v: v.backward(x, Wd, bd, dy, dl1, tc, We=We, be=be)}
        rec = {"shape": shape, "L": L, "B": B, "d_in": D, "d_sae": Sd,
               "route": "wgmma" if tc else "mma_sync", "equal_to_package": {}, "ms": {}}
        for kernel, fn in calls.items():
            want = fn(versions["package"])
            rec["equal_to_package"][kernel] = {
                n: all(torch.equal(a, b) for a, b in zip(fn(v), want)) for n, v in versions.items()}
            del want
            t = {n: [] for n in names}
            for n in names + names[::-1]:
                t[n].append(ms(lambda: fn(versions[n]), iters=5, warmup=1))
            rec["ms"][kernel] = t
        print(json.dumps(rec), flush=True)
        del x, We, be, Wd, bd, dy, dl1, hc
        torch.cuda.empty_cache()
    return 0


def errors(v, x, We, be, Wd, bd, dy, dl1, hc_plain, want4, want6, want5):
    """A version's max errors against the plain versions (y, hc of max(1,
    absmax); grads of absmax, B5's outside the features whose ReLU switched)
    and its rows and layer 0 alone against the whole call, to the bit."""
    rel = lambda a, b, floor: ((a - b).abs().max().item()
                               / max(floor, b.abs().max().item()))
    y, l1, nact, hc = v.forward(x, We, be, Wd, bd)
    g6 = v.backward(x, Wd, bd, dy, dl1, hc=hc_plain)
    g5 = v.backward(x, Wd, bd, dy, dl1, We=We, be=be)
    switched = ((hc > 0) != (want4[3] > 0)).any(dim=1)  # [L, S]
    keep = {0: ~switched[:, None, :], 1: ~switched[:, :, None], 2: ~switched}
    rec = {"y": rel(y, want4[0], 1.0), "hc": rel(hc, want4[3], 1.0),
           "l1": ((l1 - want4[1]).abs() / want4[1].abs()).max().item(),
           "relu_switches": int(switched.sum()),
           "B6": [rel(a, b, 0.0) for a, b in zip(g6, want6)],
           "B5_unswitched": [rel(a * keep[i], b * keep[i], 0.0)
                             for i, (a, b) in enumerate(zip(g5, want5))]}
    rows = v.forward(x[:, :128].contiguous(), We, be, Wd, bd)
    one = lambda *ts: [t[:1].contiguous() for t in ts]
    y0, _, _, hc0 = v.forward(*one(x, We, be, Wd, bd))
    g0 = v.backward(*one(x, Wd, bd, dy, dl1), hc=hc[:1].contiguous())
    g6own = v.backward(x, Wd, bd, dy, dl1, hc=hc)
    rec["rows_alone_equal"] = torch.equal(rows[0], y[:, :128]) and torch.equal(rows[3],
                                                                               hc[:, :128])
    rec["layer_0_alone_equal"] = (torch.equal(y0, y[:1]) and torch.equal(hc0, hc[:1])
                                  and torch.equal(g0[0], g6own[0][:1])
                                  and torch.equal(g0[1], g6own[1][:1]))
    return rec


def main():
    from vit_prisma_tpu_torch.ops import sae_step as S
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    only = None
    if "--only" in args:  # --only topk|gated
        i = args.index("--only")
        only, args = args[i + 1], args[:i] + args[i + 2:]
        if only not in ("topk", "gated"):
            raise SystemExit(f"--only {only}: the choices are topk and gated")
    check = "--check" in args
    dirs = {"package": PACKAGE, **{f"{i}:{Path(a).name}": Path(a) for i, a in enumerate(
        x for x in args if not x.startswith("--"))}}
    if only == "topk":
        return topk_bf16_main(dirs) if "--bf16" in args else topk_main(dirs)
    if only == "gated":
        return gated_bf16_main(dirs) if "--bf16" in args else gated_main(dirs, check)
    if "--bf16" in args:
        return bf16_main(dirs)
    versions = {n: Version(n, d, j) for j, (n, d) in enumerate(dirs.items())}
    for n in list(versions):
        ok = versions[n].finish()
        print(json.dumps({"version": n, "built": ok, "tf32": versions[n].tf32,
                          "ptxas": versions[n].ptxas() if ok else None}), flush=True)
        if not ok:
            del versions[n]
    print(json.dumps({"card": card(), "versions": list(versions)}), flush=True)
    names = list(versions)
    g = torch.Generator(device="cuda").manual_seed(4)
    for shape, (L, B, D, Sd) in SHAPES.items():
        x, We, be, Wd, bd, dy, dl1 = chip_smoke._sae_inputs(g, L, B, D, Sd, torch.float32)
        want4 = S.sae_fused_forward_reference(x, We, be, Wd, bd, save_h=True)
        hc = want4[3]
        want6 = S.sae_fused_backward_stored_reference(x, hc, Wd, bd, dy, dl1)
        want5 = S.sae_fused_backward_reference(x, We, be, Wd, bd, dy, dl1)
        rec = {"shape": shape, "L": L, "B": B, "d_in": D, "d_sae": Sd,
               "errors": {n: errors(v, x, We, be, Wd, bd, dy, dl1, hc, want4, want6, want5)
                          for n, v in versions.items()},
               "tol": {"y_hc": chip_smoke.SAE_REL[torch.float32],
                       "grads": chip_smoke.SAE_GRAD_REL[torch.float32]}}
        del want5
        if not check:
            flop = 2 * L * B * D * Sd
            xc = x - bd[:, None]
            dhc = torch.where(hc > 0, S._mm(dy, Wd.transpose(1, 2)) + dl1[:, None, None], 0.0)
            calls = {
                "B4": (lambda v: v.forward(x, We, be, Wd, bd), [(xc, We), (hc, Wd)]),
                "B6": (lambda v: v.backward(x, Wd, bd, dy, dl1, hc=hc),
                       [(dy, Wd.transpose(1, 2)), (xc.transpose(1, 2), dhc),
                        (hc.transpose(1, 2), dy)]),
                "B5": (lambda v: v.backward(x, Wd, bd, dy, dl1, We=We, be=be),
                       [(xc, We), (dy, Wd.transpose(1, 2)), (xc.transpose(1, 2), dhc),
                        (hc.transpose(1, 2), dy)]),
                "B4_plus_B6": (lambda v: v.backward(x, Wd, bd, dy, dl1,
                                                    hc=v.forward(x, We, be, Wd, bd)[3]), None)}
            if shape == "topk_slice":
                h = S.sae_fused_forward_topk_reference(x, We, be, Wd, bd, chip_smoke.TOPK_K,
                                                       save_h=True)[4]
                dht = torch.where(h > 0, S._mm(dy, Wd.transpose(1, 2)) + dl1[:, None, None], 0.0)
                calls["B6_on_topk_h"] = (lambda v: v.backward(x, Wd, bd, dy, dl1, hc=h),
                                         [(dy, Wd.transpose(1, 2)), (xc.transpose(1, 2), dht),
                                          (h.transpose(1, 2), dy)])
            iters = 3 if L > 2 else 10
            times = {}
            for kernel, (fn, products) in calls.items():
                t = {n: [] for n in names}
                for n in names + names[::-1]:
                    t[n].append(ms(lambda: fn(versions[n]), iters=iters, warmup=1))
                n_flop = {"B4": 2, "B6": 3, "B5": 4, "B4_plus_B6": 5,
                          "B6_on_topk_h": 3}[kernel] * flop
                times[kernel] = {"ms": t, "TFLOP_per_s": {n: n_flop / min(v) / 1e9
                                                          for n, v in t.items()},
                                 "bound": chip_smoke.bound(0, [("f32_product", n_flop)])}
                if products:
                    times[kernel]["cublas_products_ms"] = ms(
                        lambda: [torch.matmul(a, b) for a, b in products], iters=iters, warmup=1)
                    times[kernel]["kernels"] = [k[:70] for k in chip_smoke.kernel_names(
                        lambda: fn(versions["package"]))]
            rec["times"] = times
            del xc, dhc
        print(json.dumps(rec), flush=True)
        del x, We, be, Wd, bd, dy, dl1, want4, want6, hc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
