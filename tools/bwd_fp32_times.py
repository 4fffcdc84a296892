"""The fp32 forms of the flash backward (B6 dq and dk/dv) of the
``paligemma_tpu_torch`` in the current directory on one CUDA card: each of
chip_smoke.py's B6 fp32 cases held to the plain fp32 version (FP32_REL of
the largest element, TF32 off) with the same bits on a second call, then
the device time per call of dq, dk/dv and one fp32 SDPA backward (bool
mask; dq, dk and dv in one call) at the training shape and at a TP rank's
Hq4 (torch.profiler's device-side events), beside the bound at 3xTF32:

    cd <tree> && python3 <this repository>/tools/bwd_fp32_times.py [sass]

(``sass``: also count the SASS instructions of the two kernels with the
toolkit's ``cuobjdump``.) Run several trees in turns in one call on one
card to compare them (parent, change, change, parent). Every line names the
tree, and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch


def _smoke():
    """This repository's chip_smoke.py as a module (it imports the package
    lazily, so the tree first on sys.path provides it)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_counts(lib_path, tree):
    """Instruction mnemonics of the fp32 backward kernels' SASS."""
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    out = subprocess.run([str(cuobjdump if cuobjdump.exists() else "cuobjdump"), "-sass",
                          str(lib_path)], capture_output=True, text=True).stdout
    for name in ("flash_bwd_dq_f32_kernelILi256", "flash_bwd_dkv_f32_kernelILi256"):
        body = out.split(name, 1)
        if len(body) < 2:
            print(f"sass [{tree}] {name}: not found", flush=True)
            continue
        body = body[1].split(".........", 1)[0]
        ops = Counter(m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                                      r"([A-Z][A-Z0-9_.]+)", body))
        top = ", ".join(f"{k} {n}" for k, n in ops.most_common(14))
        print(f"sass [{tree}] {name[:26]}: {sum(ops.values())} instructions: {top}", flush=True)


def main():
    cs = _smoke()
    from paligemma_tpu_torch.kernels import _build
    from paligemma_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = Path(os.getcwd()).name
    dev = torch.device("cuda", 0)
    lib_path = _build.build()
    _build.library()
    print(f"card [{tree}]: {torch.cuda.get_device_name(0)} | {cs.card_line()}", flush=True)
    cs.ptxas_lines(lib_path.parent / "ptxas.log", ("flash_bwd_dq_f32", "flash_bwd_dkv_f32"))
    if "sass" in sys.argv[1:]:
        sass_counts(lib_path, tree)

    gen = torch.Generator().manual_seed(cs.SEED + 22)
    for label, (b, s, hq, hkv, d), pfx, kvl, timed in cs.B6_FP32_CASES:
        q, k, v, dout = (torch.randn(shape, generator=gen).to(dev) for shape in
                         ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
        pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
        kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
        out, lse = fa.flash_attention_with_lse(q, k, v, pl, kl)
        delta = fa._delta(out, dout)
        scale = d**-0.5

        def run_dq():
            return fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, pl, kl, scale)

        def run_dkv():
            return fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, pl, kl, scale)

        got = (run_dq(), *run_dkv())
        again = (run_dq(), *run_dkv())
        want = fa._reference_backward(q, k, v, dout, lse, delta, pl, kl, scale, 0)
        cs.sync()
        errs = []
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            err = float((x - w).abs().max())
            rel = err / max(float(w.abs().max()), 1e-30)
            errs.append(f"{name} {err:.3e} ({rel:.2e} of max)")
            if rel > cs.FP32_REL:
                raise AssertionError(f"[{tree}] {label} {name}: {rel:.3e} of the largest "
                                     f"element against the plain version")
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        print(f"check [{tree}] {label}: {', '.join(errs)}; same bits {same}", flush=True)
        if not same:
            raise AssertionError(f"[{tree}] {label}: a second call gave other bits")
        if not timed:
            continue
        allowed = fa._allowed(s, s, pl, kl, 0, dev)
        pairs = hq * int(allowed.sum())
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        a = cs._sdpa_args(*leaves, allowed)
        lib_out = F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3],
                                                 enable_gqa=True)
        g = dout.transpose(1, 2)
        dt = cs.device_times(f"[{tree}] {label}", [
            ("flash_attention_bwd_dq_fp32", run_dq),
            ("flash_attention_bwd_dkv_fp32", run_dkv),
            ("SDPA fp32 backward",
             lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True))], iters=10)
        stats = cs.nbytes(lse, delta)
        b_dq = cs.bound_ms(6 * d * pairs, cs.nbytes(q, k, v, dout, got[0]) + stats,
                           cs.PEAK_TF32X3_FLOPS)
        b_dkv = cs.bound_ms(8 * d * pairs, cs.nbytes(q, k, v, dout, got[1], got[2]) + stats,
                            cs.PEAK_TF32X3_FLOPS)
        ms_dq, ms_dkv = dt["flash_attention_bwd_dq_fp32"], dt["flash_attention_bwd_dkv_fp32"]
        pair = None if None in (ms_dq, ms_dkv) else ms_dq + ms_dkv
        print(f"times [{tree}] {label}: dq {cs._ms(ms_dq)} (bound {b_dq:.4f} ms), dk/dv "
              f"{cs._ms(ms_dkv)} (bound {b_dkv:.4f} ms), pair "
              f"{'not measured' if pair is None else f'{pair:.4f} ms'}, one fp32 SDPA backward "
              f"{cs._ms(dt['SDPA fp32 backward'])} | {cs.card_line()}", flush=True)
        del lib_out, leaves


if __name__ == "__main__":
    main()
