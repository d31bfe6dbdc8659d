"""chip_smoke.py's kernel-name checks taken in a process of their own, as
the smoke takes them where every profiler window of its own process missed
a kernel: this process's windows are made to see nothing, so that each
check below goes to the new process, and must pass there.  Checks B2's
float32 passes at the gate-edge causal shape (the shape whose windows came
back empty late in a whole run), B1's float32 forward at B/32, and float32
B8 and B9 at the TopK slice; then that a check whose new process sees the
other route's kernels still fails.  Run from the repository root on a CUDA
card: ``python3 probes/names_retake.py`` (about a minute after the
build)."""

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main():
    print(cs.card())
    cs.phase_build({})
    cs.kernel_names = lambda fn, calls=3, pad=0.0: []  # this process only
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}

    def timed(what, check):
        t0 = time.perf_counter()
        out[what] = {"names": check(), "seconds": time.perf_counter() - t0}

    _, B, T, N, H, causal, _ = next(s for s in cs.GRAD_KERNEL_SHAPES
                                    if s[0] == "gate_edge_causal")
    q, k, v, dz = (torch.randn(B, T, N * H, generator=g, device="cuda") for _ in range(4))
    timed("B2 gate_edge_causal", lambda: cs.profiled_kernels(
        "B2 gate_edge_causal", [(f"{cs.ATTENTION}:attention_mix_tnh_bwd",
                                 (q, k, v, dz, N, causal), {})], "tf32x3", (1, 2)))
    _, B, T, N, H, causal = next(s for s in cs.KERNEL_SHAPES if s[0] == "b32")
    q, k, v = (torch.randn(B, T, N * H, generator=g, device="cuda") for _ in range(3))
    timed("B1 b32", lambda: cs.profiled_kernels(
        "B1 b32", [(f"{cs.ATTENTION}:attention_mix_tnh", (q, k, v, N, causal), {})],
        "tf32x3", (0,)))
    _, L, B, D, S, dtype = next(s for s in cs.TOPK_SHAPES if s[0] == cs.TOPK_F32_PROFILED_SHAPE)
    x, We, be, Wd, bd, dy, dl1 = cs._sae_inputs(g, L, B, D, S, dtype)
    from vit_prisma_tpu_torch.ops.sae_step import sae_fused_forward_topk
    t = sae_fused_forward_topk(x, We, be, Wd, bd, cs.TOPK_K)[3]
    timed("B8 and B9 slice_f32", lambda: cs._f32_profiled(
        "B8 and B9 slice_f32",
        [(f"{cs.SAE_STEP}:sae_fused_forward_topk", (x, We, be, Wd, bd, cs.TOPK_K),
          {"save_h": True}),
         (f"{cs.SAE_STEP}:sae_fused_backward_topk", (x, We, be, Wd, bd, dy, dl1, t), {})],
        cs.SAE_TF32_TOPK_FWD_KERNELS + cs.SAE_TF32_KERNELS))
    # a control: B2's float32 calls named as the FFMA route's, so that the
    # new process sees the other route's kernels and the check must fail
    try:
        cs.profiled_kernels("B2 control", [(f"{cs.ATTENTION}:attention_mix_tnh_bwd",
                                            (q, k, v, q, N, causal), {})], "ffma", (1, 2))
        out["control"] = "passed: the check did not fail"
    except AssertionError as e:
        out["control"] = f"failed as it must: {str(e)[:200]}"
    print(json.dumps({"retaken": cs.NAMES_RETAKEN, **out}))
    if cs.NAMES_RETAKEN != [*list(out)[:3], "B2 control"] or \
            not out["control"].startswith("failed"):
        raise SystemExit("the retake did not behave as it must")


if __name__ == "__main__":
    main()
