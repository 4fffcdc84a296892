"""Device time of the int8 GEMV (``int8_gemv``, row 3a) at PaliGemma-3B-224's
four decoder projections and of the fused LM-head argmax
(``head_argmax_fused``, B3) of the ``paligemma_tpu_torch`` in the current
directory, at B = 1 and 8, each beside its bytes bound and beside
``torch._weight_int8pack_mm``, with the weights cold as in a decode step:
``chip_smoke.gemv_device_times`` of this repository, run on that tree. It
checks nothing, so diagnostic builds run too:

    cd <tree> && python3 <this repository>/tools/gemv_times.py [--label L]

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
    args = ap.parse_args(argv)
    tree = " ".join(filter(None, [os.path.basename(os.getcwd()), args.label]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"gemv [{tree}] card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _chip_smoke().gemv_device_times(torch.device("cuda"), label=tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
