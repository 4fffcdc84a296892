"""The plan of B9 / B11 above 16 rows (``kernels/ablation/_wq_gemm.py``) on
the card in the current directory: how many clusters of c CTAs of each
wgmma tile the card holds at once (``pg_wq_max_clusters``, the source of
``CLUSTERS_RESIDENT``), then the device time of int8_matmul ((K, N)
weights, cold) at Gemma-2B's four projections and 17, 266 and 1024 rows
under the plan and under the plan forced to one row tile or a smaller
cluster cap (chip_smoke.device_ms). It checks nothing:

    cd <tree> && python3 <this repository>/tools/wq_plan_sweep.py
"""

import ctypes
import importlib.util
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch

import torch  # noqa: E402

from paligemma_tpu_torch.kernels import _build  # noqa: E402
from paligemma_tpu_torch.kernels.ablation import _wq_gemm as wq  # noqa: E402
from paligemma_tpu_torch.kernels.ablation import quant_pallas as qp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (17, 266, 1024)
# (label, the only row tile allowed, the largest cluster allowed)
VARIANTS = (("plan", None, None), ("rows64", 64, None), ("rows128", 128, None),
            ("rows136", 136, None), ("rows256", 256, None), ("cluster<=2", None, 2),
            ("cluster<=4", None, 4))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("wq_chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forced_plan(rows, cap, m, k, n, layout):
    """WqPlan.make with ROW_TILES and CLUSTERS_RESIDENT cut down."""
    saved = wq.ROW_TILES, wq.CLUSTERS_RESIDENT
    try:
        if rows:
            wq.ROW_TILES = (rows,)
        if cap:
            wq.CLUSTERS_RESIDENT = {r: {c: v for c, v in t.items() if c <= cap}
                                    for r, t in saved[1].items()}
        return wq.WqPlan.make(m, k, n, layout)
    finally:
        wq.ROW_TILES, wq.CLUSTERS_RESIDENT = saved


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"wq_plan_sweep card: {card}", flush=True)
    lib = _build.library()
    for layout, name in enumerate(("int8 (K, N)", "int8 (N, K)", "int4")):
        for rows in ((16, 64, 128, 136, 256) if layout == 1 else (64, 128, 136, 256)):
            got = []
            for c in (1, 2, 3, 4, 6, 8):
                v = ctypes.c_int(0)
                _build.check(lib.pg_wq_max_clusters(layout, rows, c, ctypes.byref(v)),
                             "pg_wq_max_clusters")
                got.append(f"c{c} {v.value}")
            print(f"resident clusters {name} rows {rows}: " + ", ".join(got), flush=True)

    cs, dev = _chip_smoke(), torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    make = wq.WqPlan.__dict__["make"]  # the classmethod, restored after each variant
    for label, k, n in cs.PROJECTIONS:
        copies = max(4, -(-60_000_000 // (k * n)))
        w8s = [torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
               for _ in range(copies)]
        s8 = (torch.rand(n, generator=g, device=dev) + 0.5) / (127.0 * k**0.5)
        for m in ROWS:
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            out = []
            for vname, rows, cap in VARIANTS:
                plan = forced_plan(rows, cap, m, k, n, "kn")
                wq.WqPlan.make = lambda *a, plan=plan: plan  # noqa: E731
                try:
                    ms = cs.device_ms(cs._cycling([lambda w=w: qp.int8_matmul(x, w, s8)
                                                   for w in w8s]), 2 * copies)[0]
                finally:
                    wq.WqPlan.make = make
                txt = "not measured" if ms is None else f"{ms * 1e3:.2f} us"
                out.append(f"{vname} (rows {plan.rows}, cluster {plan.cluster}, {plan.ctas} "
                           f"CTAs) {txt}")
            print(f"sweep {label} M{m}: " + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
