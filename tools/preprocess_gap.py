"""How far ``processing.images.preprocess_device`` on the card is from the
same call on the host, and its time on each, beside the same resize done in
float32 (the form the function does not take):

    python3 tools/preprocess_gap.py      # needs one CUDA card

For each frame size (B = 2 seeded uint8 RGB frames -> 224 px) it prints the
max |card - host| in normalized units for the float64 math of the port's
function and for a float32 variant, and each one's time on the card (CUDA
events, mean of 20 calls after one) and on the host (mean of 5). It checks
nothing.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from paligemma_tpu_torch.processing.images import preprocess_device  # noqa: E402

SIZES = ((300, 400), (500, 300), (100, 150), (480, 640))


def float32_variant(x, size):
    y = F.interpolate(x.to(torch.float32).permute(0, 3, 1, 2), size=(size, size),
                      mode="bicubic", align_corners=False, antialias=True)
    return (y * (1.0 / 255.0) - 0.5) / 0.5


def card_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def host_ms(fn, iters=5):
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("preprocess_gap: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for h, w in SIZES:
        raw = np.random.default_rng(0).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
        x_host, x_card = torch.from_numpy(raw), torch.from_numpy(raw).cuda()
        for name, fn in (("float64 (the port)", lambda x: preprocess_device(x, 224)),
                         ("float32 variant", lambda x: float32_variant(x, 224))):
            gap = float((fn(x_card).cpu() - fn(x_host)).abs().max())
            print(f"preprocess_gap: {h}x{w} -> 224, B2, {name}: max |card - host| {gap:.3e}; "
                  f"card {card_ms(lambda: fn(x_card)):.4f} ms, host "
                  f"{host_ms(lambda: fn(x_host)):.3f} ms  [{card}]", flush=True)


if __name__ == "__main__":
    main()
