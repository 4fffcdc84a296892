"""K2 (``w8a8_gemm``, the W8A8 prefill GEMM) of the ``paligemma_tpu_torch``
in the current directory on one CUDA card, at one Gemma-2B layer's four
projections (qkv 2048 -> 2560, o 2048 -> 2048, gateup 2048 -> 32768, down
16384 -> 2048; seeded int8 weights and fp32 column scales, x over four
decades of row scale) at M266 (one 224 px prompt) and M2560 (a serving
wave): each product's bf16 output and int32 sums held to the plain version
bit for bit, then the device time per call (torch.profiler's device-side
events) of K2 and of ``torch._int_mm`` on the same codes (its (N, K) copy
made beforehand), and the four projections' sums beside the bound:

    cd <tree> && python3 <this repository>/tools/w8a8_times.py

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

sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch

PROJECTIONS = (("qkv", 2048, 2560), ("o", 2048, 2048), ("gateup", 2048, 32768),
               ("down", 16384, 2048))
ROWS = (266, 2560)


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
        raise SystemExit("w8a8_times: no CUDA device")
    from paligemma_tpu_torch.kernels import _build, w8a8

    tree = Path(os.getcwd()).name
    dev = torch.device("cuda", 0)
    lib_path = _build.build()
    _build.library()
    print(f"card [{tree}]: {torch.cuda.get_device_name(0)} | {cs.card_line()}", flush=True)
    cs.ptxas_lines(lib_path.parent / "ptxas.log", ("w8a8_gemm",))
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 18)
    weights = {name: (torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                    dtype=torch.int8),
                      torch.rand(n, generator=g, device=dev) * 1e-2)
               for name, k, n in PROJECTIONS}
    for m in ROWS:
        sums = {"w8a8_gemm": 0.0, "torch._int_mm": 0.0, "bound": 0.0}
        for name, k, n in PROJECTIONS:
            w8, s = weights[name]
            x = (torch.randn(m, k, generator=g, device=dev)
                 * 10.0 ** (torch.rand(m, 1, generator=g, device=dev) * 4 - 2)).to(torch.bfloat16)
            x[0] = 0
            x8, a_s = w8a8.w8a8_quant_rows(x)
            label = f"{name} M{m} K{k} N{n}"
            got = w8a8.w8a8_gemm(x8, w8, a_s, s)
            acc = w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=torch.int32)
            exact = w8a8.int_sums_reference(x8, w8)
            ok = (torch.equal(acc, exact)
                  and torch.equal(got, w8a8.scale_sums(exact, a_s, s, torch.bfloat16))
                  and torch.equal(w8a8.w8a8_gemm(x8, w8, a_s, s), got))
            print(f"check [{tree}] {label}: bf16 and int32 bit for bit, the same bits twice: "
                  f"{ok}", flush=True)
            if not ok:
                raise AssertionError(f"[{tree}] {label}: K2 differs from its plain version")
            del acc, exact
            w_nk = w8.t().contiguous()  # torch._int_mm's layout, outside the timed window
            dt = cs.device_times(f"[{tree}] {label}", (
                ("w8a8_gemm", lambda: w8a8.w8a8_gemm(x8, w8, a_s, s)),
                ("torch._int_mm", lambda: torch._int_mm(x8, w_nk.t()))))
            bound = cs.bound_ms(2.0 * m * k * n, cs.nbytes(x8, w8, a_s, s, got),
                                cs.PEAK_INT8_OPS)
            for key, v in list(dt.items()) + [("bound", bound)]:
                sums[key] = None if v is None or sums[key] is None else sums[key] + v
            del w_nk, got
        print(f"times [{tree}] one layer's four projections at M{m}, device ms: " + ", ".join(
            f"{key} {'not measured' if v is None else f'{v:.4f}'}" for key, v in sums.items())
            + f" | {cs.card_line()}", flush=True)


if __name__ == "__main__":
    main()
