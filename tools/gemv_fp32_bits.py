"""Bit-for-bit comparison of the fp32 GEMV tile with the norm prologue
(``gemv_tile_sums_f32`` with NORM: rows 3af's qkv and gateup, and the plans
whose K range does not fit the staged norm weight) between two trees of
``paligemma_tpu_torch`` on one CUDA card.

``save`` runs the tree in the current directory: Gemma-2B's qkv (2048 ->
2560), gateup + GeGLU (2048 -> 32768) and o + residual (2048 -> 2048), a
wide plan of one CTA a column tile whose K range is longer than the staged
buffer (8208 -> 65536), and a ragged shape (1000 -> 384), each with the
norm at 1, 8, 9 and 72 rows (the wide plan at 1, 8 and 9), every output
checked against the plain fp32 version (within FP32_REL of max(1, the
largest element)) and called twice for the same bits, then saved.
``compare`` says whether two saved files hold the same bits:

    cd <tree> && python3 <this repository>/tools/gemv_fp32_bits.py save /tmp/a.pt
    python3 tools/gemv_fp32_bits.py compare /tmp/a.pt /tmp/b.pt
"""

from __future__ import annotations

import os
import sys

import torch

FP32_REL = 2e-5  # chip_smoke.py, tests/test_torch_cuda.py
CASES = ((2048, 2560, {}), (2048, 32768, {"geglu": True}), (2048, 2048, {"residual": True}),
         (8208, 65536, {}), (1000, 384, {}))


def save(out_path: str) -> None:
    sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch
    from paligemma_tpu_torch.kernels import int8_gemv as gv

    dev = torch.device("cuda", 0)
    res, worst = {}, 0.0
    for k, n, kw in CASES:
        g = torch.Generator(device=dev).manual_seed(k + n)
        w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
        nw = torch.randn(k, generator=g, device=dev) * 0.1
        for b in (1, 8, 9, 72):
            if k == 8208 and b > 9:
                continue
            x = torch.randn(b, k, generator=g, device=dev) * 2.0
            args = dict(kw, norm=(nw, 1e-6))
            if "residual" in args:
                width = n // 2 if kw.get("geglu") else n
                args["residual"] = torch.randn(b, width, generator=g, device=dev)
            got = gv.int8_gemv(x, w8, s, **args)
            want = gv.int8_gemv_reference(x, w8, s, **args)
            e = float((got - want).abs().max() / max(1.0, float(want.abs().max())))
            worst = max(worst, e)
            assert e <= FP32_REL, (k, n, b, e)
            assert torch.equal(gv.int8_gemv(x, w8, s, **args), got)
            res[f"{k}x{n}B{b}"] = got.cpu()
        del w8
    torch.save(res, out_path)
    print(f"bits: {len(res)} cases saved, worst error {worst:.3e} of max(1, max |plain|)")


def compare(a_path: str, b_path: str) -> None:
    a, b = torch.load(a_path), torch.load(b_path)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    print(f"bits {a_path} == {b_path}: {len(a)} cases,",
          "all equal" if not bad else f"DIFFER {bad}")
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        save(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)
