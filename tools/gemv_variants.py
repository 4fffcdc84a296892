"""Builds of the int8 GEMV tile (``csrc/gemv_tile.cuh``) and its plan with
one change each, timed by tools/gemv_times.py:

    python3 tools/gemv_variants.py [NAME ...]      # default: all of VARIANTS

A variant is a copy of ``paligemma_tpu_torch`` under
``build/gemv_variants/NAME/`` with the text replacements of ``VARIANTS[NAME]``
applied (each must match exactly once, so a variant that no longer fits the
source fails instead of timing the default). The copy builds its own kernels
when tools/gemv_times.py runs on it, in a process of its own; then the
``-Xptxas -v`` lines of its GEMV kernels are printed. The product code has
no knob for any of this.
"""

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "paligemma_tpu_torch"
TILE = "csrc/gemv_tile.cuh"

# the loads alone: every loaded word kept alive by a cheap sum, no mma
_LOADS_ONLY = """        acc[0][0] += __uint_as_float((wb[s][0].x ^ wb[s][1].y ^ wb[s][2].z ^ wb[s][3].w ^
                                      wb[s][0].w ^ wb[s][1].z ^ wb[s][2].y ^ wb[s][3].x ^
                                      xb[s].x) & 0x3fffffffu);
"""
# the arithmetic with no weight loads: each row word a constant
_NO_WEIGHT_LOADS = (TILE, "const uint4 v = ldg_stream16(p + r * n1);",
                    "const uint32_t c = 0x01010101u * (uint32_t)(nrow + r);\n"
                    "        const uint4 v = make_uint4(c, c, c, c);")

VARIANTS = {
    "default": [],
    "stages2": [(TILE, "#define GT_STAGES 3", "#define GT_STAGES 2")],
    "stages4": [(TILE, "#define GT_STAGES 3", "#define GT_STAGES 4")],
    "loads": [(TILE, "        gt_mma_step(acc, wb[s], xb[s], magic);\n", _LOADS_ONLY)],
    "math_x": [_NO_WEIGHT_LOADS],
    "math": [_NO_WEIGHT_LOADS,
             (TILE, "  uint32_t lo = 0u, hi = 0u;\n  if (xrow) {",
              "  uint32_t lo = (uint32_t)nrow, hi = 0u;\n  if (false) {")],
    "warps4": [("kernels/gemv_plan.py", "WARP_CHOICES = (4, 8)", "WARP_CHOICES = (4,)")],
    "target2x": [("kernels/gemv_plan.py", "TARGET_WARPS = 16 * 132", "TARGET_WARPS = 32 * 132")],
}
KERNELS = ("int8_gemv_kernel", "head_argmax_kernel")


def make_copy(name: str) -> str:
    """build/gemv_variants/NAME/ holding the patched package; returns it."""
    top = os.path.join(ROOT, "build", "gemv_variants", name)
    shutil.rmtree(top, ignore_errors=True)
    pkg = os.path.join(top, PKG)
    shutil.copytree(os.path.join(ROOT, PKG), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    for rel, old, new in VARIANTS[name]:
        path = os.path.join(pkg, rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} matches {text.count(old)} times in {rel}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return top


def main() -> int:
    sys.path.insert(0, ROOT)
    from chip_smoke import ptxas_lines

    names = sys.argv[1:] or list(VARIANTS)
    rc = 0
    for name in names:
        top = make_copy(name)
        res = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "gemv_times.py")],
                             cwd=top)
        rc |= res.returncode
        print(f"variant [{name}]: gemv_times rc {res.returncode}", flush=True)
        for log in pathlib.Path(top, "build", PKG).glob("*/ptxas.log"):
            ptxas_lines(log, KERNELS)
    return rc


if __name__ == "__main__":
    sys.exit(main())
