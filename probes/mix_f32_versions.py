"""The attention mix's float32 routes as the package builds them (3xTF32 on
the tensor cores for heads up to 128 wide) against other versions of the
same sources, each built alone: B1 (``attention_mix_tnh.cu``), B15
(``attention_mix.cu``) and B2 (``attention_mix_tnh_bwd.cu``) from each
directory given, which holds a copy of ``vit_prisma_tpu_torch/csrc`` (for
the FFMA versions, a parent commit's, unpacked with ``git archive`` into a
gitignored directory; or edited copies).  At every float32 shape of
chip_smoke.py's kernel phases: each version's error against the plain
version, times from CUDA events in turns (package, others, others
reversed, package), the kernel names
``torch.profiler`` sees, and the library beside (SDPA's CUDA-event time
for the forward, its backward's device time for B2, as chip_smoke.py takes
them), with the bound at chip_smoke.py's peaks.  Prints JSON lines.  Run
from the repository root on a CUDA card:
``python3 probes/mix_f32_versions.py OTHER_CSRC_DIR [...]``."""

import ctypes
import json
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _common import BUILD, card, finish_build, ms, start_build  # noqa: E402

import chip_smoke  # noqa: E402  (on the path through _common)

FILES = {"fwd": "attention_mix_tnh.cu", "mix": "attention_mix.cu",
         "bwd": "attention_mix_tnh_bwd.cu"}


def declare(lib, kind):
    """The C signature of the entry a library built from FILES[kind] has."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if kind == "fwd":
        lib.attention_mix_tnh_fwd.argtypes = [p] * 4 + [i] * 7 + [p]
    elif kind == "mix":
        lib.attention_mix_fwd.argtypes = [p] * 4 + [i] * 6 + [p]
    else:
        lib.attention_mix_tnh_bwd.argtypes = [p] * 8 + [i] * 7 + [p]


def stream():
    return torch.cuda.current_stream().cuda_stream


def fwd(lib, q, k, v, n_heads, causal):
    B, T, NH = q.shape
    z = torch.empty_like(q)
    rc = lib.attention_mix_tnh_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), z.data_ptr(), B, T,
                                   n_heads, NH // n_heads, int(causal), 0, 0, stream())
    if rc:
        raise RuntimeError(f"attention_mix_tnh_fwd: CUDA error {rc}")
    return z


def mix(lib, q, k, v):
    B, N, T, H = q.shape
    z = torch.empty_like(q)
    rc = lib.attention_mix_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), z.data_ptr(), B, N, T,
                               H, 0, 0, stream())
    if rc:
        raise RuntimeError(f"attention_mix_fwd: CUDA error {rc}")
    return z


def bwd(lib, q, k, v, dz, n_heads, causal):
    B, T, NH = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(B, n_heads, 3, T, dtype=torch.float32, device=q.device)
    rc = lib.attention_mix_tnh_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), dz.data_ptr(),
                                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                                   B, T, n_heads, NH // n_heads, int(causal), 0, 0, stream())
    if rc:
        raise RuntimeError(f"attention_mix_tnh_bwd: CUDA error {rc}")
    return dq, dk, dv


def rel_err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
               for a, b in zip(got, want))


def in_turns(libs, call):
    """ms of each version, timed package, others, others reversed, package."""
    names = list(libs)
    t = {n: [] for n in names}
    for n in names + names[::-1]:
        t[n].append(ms(lambda: call(libs[n]), iters=20, warmup=3))
    return t


def ptxas_tf32(log):
    """Registers and spill bytes of the 3xTF32 kernels in a build log, by
    kernel and template arguments."""
    out, fn = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Function properties for \S*?(\w+_tf32_kernel)I((?:Li\d+E)+)E", line)
        if "Function properties for" in line:
            fn = f"{m.group(1)}<{','.join(re.findall(r'\d+', m.group(2)))}>" if m else None
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn] = {"spill_bytes": int(m.group(1)) + int(m.group(2))}
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
    return out


def kernels_seen(call, libs):
    """Each version's kernel names and device time a call (torch.profiler;
    None where every window lost calls)."""
    out = {}
    for n, lib in libs.items():
        try:
            us = chip_smoke.device_us(lambda: call(lib))
        except AssertionError:
            us = None
        out[n] = {"names": [k[:60] for k in chip_smoke.kernel_names(lambda: call(lib))],
                  "device_ms": None if us is None else us * 1e-3}
    return out


def main():
    from vit_prisma_tpu_torch.ops import _build
    from vit_prisma_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    others = [Path(a) for a in sys.argv[1:]]
    procs = {(i, k): start_build(d / f, f"mix_f32_{i}_{k}")
             for i, d in enumerate(others) for k, f in FILES.items()}
    package = _build.load_library()
    libs = {k: {"package": package} for k in FILES}
    for (i, k), proc in procs.items():
        lib = finish_build(proc, f"mix_f32_{i}_{k}")
        if lib is None:  # nvcc's output printed; the others are still timed
            for kind in FILES:
                libs[kind].pop(f"{i}:{others[i].name}", None)
            continue
        declare(lib, k)
        libs[k][f"{i}:{others[i].name}"] = lib
        print(json.dumps({"version": f"{i}:{others[i].name}", "file": FILES[k],
                          "ptxas": ptxas_tf32(BUILD / f"mix_f32_{i}_{k}.log")}), flush=True)
    print(json.dumps({"version": "package",
                      "ptxas": ptxas_tf32(_build.build_dir() / "nvcc.log")}), flush=True)
    print(json.dumps({"card": card(), "versions": list(libs["fwd"])}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(22)
    peak = lambda ops, nbytes: chip_smoke.bound(nbytes, ops)
    for name, B, T, N, H, causal in chip_smoke.KERNEL_SHAPES:
        shape = (B, T, N * H)
        q = torch.randn(shape, generator=g, device="cuda") * H ** -0.5
        k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(2))
        want = A.attention_mix_tnh_reference(q, k, v, N, causal)
        call = lambda lib: fwd(lib, q, k, v, N, causal)
        qh, kh, vh = (a.reshape(B, T, N, H).transpose(1, 2).contiguous() for a in (q, k, v))
        pairs = T * (T + 1) // 2 if causal else T * T
        print(json.dumps({
            "kernel": "attention_mix_tnh", "shape": name, "B": B, "T": T, "N": N, "H": H,
            "causal": causal, "route": A.mix_route(H, torch.float32),
            "rel_err": {n: rel_err(call(lib), want) for n, lib in libs["fwd"].items()},
            "ms": in_turns(libs["fwd"], call), "kernels": kernels_seen(call, libs["fwd"]),
            "library_ms": ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, scale=1.0), iters=20, warmup=3),
            **peak([("f32_product", 4 * B * N * pairs * H), ("fp32", 5 * B * N * pairs)],
                   4 * q.numel() * 4)}), flush=True)
        del q, k, v, want, qh, kh, vh
    for name, B, N, T, H, dtypes in chip_smoke.MIX_SHAPES:
        if torch.float32 not in dtypes:
            continue
        q = torch.randn(B, N, T, H, generator=g, device="cuda") * H ** -0.5
        k, v = (torch.randn(B, N, T, H, generator=g, device="cuda") for _ in range(2))
        want = A.attention_mix_reference(q, k, v)
        call = lambda lib: mix(lib, q, k, v)
        print(json.dumps({
            "kernel": "attention_mix", "shape": name, "B": B, "N": N, "T": T, "H": H,
            "route": A.mix_route(H, torch.float32),
            "rel_err": {n: rel_err(call(lib), want) for n, lib in libs["mix"].items()},
            "ms": in_turns(libs["mix"], call), "kernels": kernels_seen(call, libs["mix"]),
            "library_ms": ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=1.0), iters=20, warmup=3),
            **peak([("f32_product", 4 * B * N * T * T * H), ("fp32", 5 * B * N * T * T)],
                   4 * q.numel() * 4)}), flush=True)
        del q, k, v, want
    for name, B, T, N, H, causal, dtypes in chip_smoke.GRAD_KERNEL_SHAPES:
        if torch.float32 not in dtypes:
            continue
        shape = (B, T, N * H)
        q = torch.randn(shape, generator=g, device="cuda") * H ** -0.5
        k, v, dz = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
        want = A.attention_mix_tnh_bwd_reference(q, k, v, dz, N, causal)
        call = lambda lib: bwd(lib, q, k, v, dz, N, causal)
        qh, kh, vh, dzh = (a.reshape(B, T, N, H).transpose(1, 2).contiguous()
                           for a in (q, k, v, dz))
        leaves = [a.requires_grad_(True) for a in (qh, kh, vh)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                               scale=1.0)
        library = chip_smoke.device_us(
            lambda: torch.autograd.grad(out, leaves, dzh, retain_graph=True),
            one_call_short=True) * 1e-3
        pairs = T * (T + 1) // 2 if causal else T * T
        print(json.dumps({
            "kernel": "attention_mix_tnh_bwd", "shape": name, "B": B, "T": T, "N": N, "H": H,
            "causal": causal, "route": A.mix_route(H, torch.float32),
            "rel_err": {n: rel_err(call(lib), want) for n, lib in libs["bwd"].items()},
            "ms": in_turns(libs["bwd"], call), "kernels": kernels_seen(call, libs["bwd"]),
            "library_ms": library,
            **peak([("f32_product", 10 * B * N * pairs * H), ("fp32", 8 * B * N * pairs)],
                   7 * q.numel() * 4)}), flush=True)
        del q, k, v, dz, want, qh, kh, vh, dzh, leaves, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
