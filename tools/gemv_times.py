"""Device times of the ``paligemma_tpu_torch`` in the current directory,
with the weights cold as in a decode step, each beside its bound and a
library call (never called by the port), by this repository's chip_smoke
functions run on that tree:

* ``gemv``: the int8 GEMV (``int8_gemv``, row 3a) at PaliGemma-3B-224's four
  decoder projections and the fused LM-head argmax (``head_argmax_fused``,
  B3), B = 1 and 8, beside ``torch._weight_int8pack_mm``
  (``chip_smoke.gemv_device_times``);
* ``int4``: B9 (``int4_matmul``) at the four projections, M = 1, 8, 17, 266,
  1024, beside ``torch._weight_int4pack_mm`` (``chip_smoke.wq_device_times``);
* ``int8``: B11 (``int8_matmul``, ``int8_matmul_nmajor``) at the same
  projections and rows beside ``torch._weight_int8pack_mm``; both, at M >=
  266, beside cuBLAS on weights dequantized beforehand;
* ``lora``: one layer's multi-LoRA operands at B8 (the four shrinks, the
  GEMVs with the expand against the GEMVs alone) and the bank's extra time
  per tick (``chip_smoke.lora_device_times``);
* ``norm``: one layer's norms, qkv, RoPE and gateup at B1 and B8, the norm
  in the GEMVs' prologue and RoPE in the qkv GEMV's epilogue where the tree
  has them (``chip_smoke.fused_device_times``).

It checks nothing, so diagnostic builds run too:

    cd <tree> && python3 <repo>/tools/gemv_times.py [--label L] [--what gemv,int4,int8,lora,norm]

(``<repo>``: this repository.)

(``--label``: printed beside the tree's name.) Run several trees in turns
in one call on one card to compare them; tools/gemv_variants.py runs it on
copies of the package with one change each.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch

import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This repository's chip_smoke.py (the tree under test may hold an
    older one)."""
    spec = importlib.util.spec_from_file_location("gemv_chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--what", default="gemv,int4,lora")
    args = ap.parse_args(argv)
    tree = " ".join(filter(None, [os.path.basename(os.getcwd()), args.label]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"gemv [{tree}] card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs, dev = _chip_smoke(), torch.device("cuda")
    for what in args.what.split(","):
        if what == "gemv":
            cs.gemv_device_times(dev, label=tree)
        elif what in ("int4", "int8"):
            cs.wq_device_times(dev, label=tree, kinds=(what,))
        elif what == "lora":
            cs.lora_device_times(dev, label=tree)
        elif what == "norm":
            cs.fused_device_times(dev, label=tree)
        else:
            raise SystemExit(f"gemv_times: --what takes gemv, int4, int8, lora, norm "
                             f"(got {what!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
