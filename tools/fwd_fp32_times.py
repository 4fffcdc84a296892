"""The fp32 form of the flash forward (B1f, and B12f: the same kernel with
every key visible) of the ``paligemma_tpu_torch`` in the current directory
on one CUDA card: at the LM prefill (B1 S266 Hq8 Hkv1 D256), the training
shape (B2 S512 Hq8 Hkv1 D256, prefix 268, kv_len 512 / 400) and a TP rank's
Hq4, the 896 px tower (B1 S4096 H16 D72) and B12f at S4096, each held to
the plain fp32 version (FP32_REL of the largest element, lse within 1e-5,
TF32 off) with the same bits on a second call, then the device time per
call (torch.profiler's device-side events) beside one fp32 SDPA on the
same inputs and the bound at 3xTF32:

    cd <tree> && python3 <this repository>/tools/fwd_fp32_times.py

Run several trees in turns in one call on one card to compare them
(parent, change, change, parent). Every line names the tree, and the
card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch

# (label, (B, S, Hq, Hkv, D), prefix_len, kv_len, route): "flash" through
# flash_attention_fwd_fp32, "vision" through B12's entry point (no lengths)
CASES = [
    ("LM prefill B1 S266 Hq8 Hkv1 D256", (1, 266, 8, 1, 256), [266], [266], "flash"),
    ("train B2 S512 Hq8 Hkv1 D256", (2, 512, 8, 1, 256), [268, 268], [512, 400], "flash"),
    ("train TP-local B2 S512 Hq4 Hkv1 D256", (2, 512, 4, 1, 256), [268, 268], [512, 400],
     "flash"),
    ("tower B1 S4096 H16 D72", (1, 4096, 16, 16, 72), [4096], [4096], "flash"),
    ("B12f B1 S4096 H16 D72", (1, 4096, 16, 16, 72), [4096], [4096], "vision"),
]


def _smoke():
    """This repository's chip_smoke.py as a module (it imports the package
    lazily, so the tree first on sys.path provides it)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    cs = _smoke()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_fp32_times: no CUDA device")
    from paligemma_tpu_torch.kernels import _build
    from paligemma_tpu_torch.kernels import flash_attention as fa
    from paligemma_tpu_torch.kernels.ablation import vision_attention as va

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = Path(os.getcwd()).name
    dev = torch.device("cuda", 0)
    lib_path = _build.build()
    _build.library()
    print(f"card [{tree}]: {torch.cuda.get_device_name(0)} | {cs.card_line()}", flush=True)
    cs.ptxas_lines(lib_path.parent / "ptxas.log", ("flash_fwd_f32",))

    gen = torch.Generator().manual_seed(cs.SEED + 27)
    for label, (b, s, hq, hkv, d), pfx, kvl, route in CASES:
        q, k, v = (torch.randn(shape, generator=gen).to(dev)
                   for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
        pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
        kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
        scale = d**-0.5
        if route == "flash":
            def run(q=q, k=k, v=v, pl=pl, kl=kl):
                return fa.flash_attention_with_lse(q, k, v, pl, kl)

            got, again = run(), run()
            want = fa._reference_forward(q, k, v, pl, kl, scale, 0)
            name = "flash_attention_fwd_fp32"
        else:
            def run(q=q, k=k, v=v):
                return (va.vision_attention(q, k, v),)

            got, again = run(), run()
            want = (va.vision_attention_reference(q, k, v, scale),)
            name = "vision_attention_fp32"
        cs.sync()
        errs = []
        for what, x, w, tol in zip(("out", "lse"), got, want, (cs.FP32_REL, 1e-5)):
            err = float((x - w).abs().max())
            rel = err / max(float(w.abs().max()), 1e-30 if what == "out" else 1.0)
            errs.append(f"{what} {err:.3e} ({rel:.2e})")
            if rel > tol:
                raise AssertionError(f"[{tree}] {label} {what}: {rel:.3e} against the plain "
                                     f"version, over {tol}")
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        print(f"check [{tree}] {label}: {', '.join(errs)}; same bits {same}", flush=True)
        if not same:
            raise AssertionError(f"[{tree}] {label}: a second call gave other bits")
        del want, again
        allowed = fa._allowed(s, s, pl, kl, 0, dev)
        a = cs._sdpa_args(q, k, v, allowed)
        mask = None if bool(allowed.all()) else a[3]

        def sdpa(a=a, mask=mask):
            return F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=mask,
                                                  enable_gqa=True)

        iters = 10 if s < 4096 else 3
        dt = cs.device_times(f"[{tree}] {label}", [(name, run), ("SDPA fp32", sdpa)],
                             iters=iters)
        flops, n_bytes = 4 * d * hq * int(allowed.sum()), 2 * cs.nbytes(q) + cs.nbytes(k, v)
        bound = cs.bound_ms(flops, n_bytes, cs.PEAK_TF32X3_FLOPS)
        print(f"times [{tree}] {label}: {name} {cs._ms(dt[name])}, one fp32 SDPA "
              f"{cs._ms(dt['SDPA fp32'])}, bound {bound:.4f} ms (3xTF32) | {cs.card_line()}",
              flush=True)
        del q, k, v, got, a


if __name__ == "__main__":
    main()
