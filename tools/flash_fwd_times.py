"""Device time of the flash forward (B1) of the ``paligemma_tpu_torch`` in
the current directory, at chip_smoke.py's three timed shapes (LM prefill B1
S266 Hq8 Hkv1 D256; training B2 S512, prefix 268, kv_len 512 / 400; the
896 px tower B1 S4096 H16 D72): torch.profiler's device-side events over
20 calls, per call, beside the max |error| against the plain version. It
checks nothing, so that diagnostic builds (a copy of the package with the
copies or the products of csrc/flash_attention.cu taken out) run too:

    cd <tree> && python3 <this repository>/tools/flash_fwd_times.py

Run several trees in turns in one call on one card to compare them.
"""

import os
import sys

sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from paligemma_tpu_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = [("LM prefill B1 S266", (1, 266, 8, 1, 256), [266], [266]),
          ("train B2 S512", (2, 512, 8, 1, 256), [268, 268], [512, 400]),
          ("tower B1 S4096 D72", (1, 4096, 16, 16, 72), [4096], [4096])]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_times: no CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    tree = os.path.basename(os.getcwd())
    for label, (b, s, hq, hkv, d), pfx, kvl in SHAPES:
        q, k, v = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
                   for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
        pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
        kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
        out = fa.flash_attention(q, k, v, pl, kl)
        want = fa.reference_attention(q, k, v, pl, kl)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fa.flash_attention(q, k, v, pl, kl)
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 20) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        print(f"diag [{tree}] {label}: " + ", ".join(f"{k[:34]} {us:.2f} us" for k, us in rows)
              + f"  err {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
