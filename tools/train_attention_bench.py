"""The flash attention kernels, the 896 px vision tower and the LoRA
training step, timed on one CUDA card with the ``paligemma_tpu_torch`` of
the current directory, so that a change and its parent can be compared in
one call on one card (run the trees in turns: parent, change, change,
parent):

    cd <tree> && python3 <this repository>/tools/train_attention_bench.py [steps]

The helpers, inputs and training configuration are this repository's
chip_smoke.py's (seeded), whichever tree runs:

1. the backward kernels dq and dk/dv (B6) and the forward (B1) at
   B2 S512 Hq8 Hkv1 D256, prefix 268, kv_len 512 / 400, each held to its
   plain version (1e-2 of the largest element), then their device time per
   call (torch.profiler's device-side events) beside one SDPA call that
   computes the same function;
2. the forward (B1) at chip_smoke.py's timed shapes (LM prefill B1 S266
   Hq8 Hkv1 D256, the training shape, the 896 px tower B1 S4096 H16 D72),
   held to its plain version, then its device time per call beside SDPA's
   (and B12's at the tower's shape) and the bound;
3. one 896 px SigLIP-So400m encode with ``attn="flash"`` (27 B1 calls;
   random weights): ms per encode (CUDA events, the least of two rounds of
   5) and its device time (torch.profiler);
4. PaliGemma-3B-224 at full width and depth (random weights), LoRA r8 on
   all seven targets, remat: the median step time over ``steps`` steps
   (CUDA events, the first step left out) and one profiled step.

Every line names the tree, and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def _smoke():
    """This repository's chip_smoke.py as a module (it imports the package
    lazily, so the tree first on sys.path provides it)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def attention_kernels(cs, dev, tree):
    from paligemma_tpu_torch.kernels import flash_attention as fa

    b, s, hq, hkv, d = cs.TRAIN_B, cs.TRAIN_S, 8, 1, 256
    prefix, kv_len = 256 + cs.TRAIN_PROMPT, [cs.TRAIN_S, cs.TRAIN_REAL1]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                     for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    pl = torch.tensor([prefix] * b, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    scale = d**-0.5
    out, lse = fa.flash_attention_with_lse(q, k, v, pl, kl)
    delta = fa._delta(out, dout)

    def run_dq():
        return fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, pl, kl, scale)

    def run_dkv():
        return fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, pl, kl, scale)

    got = (run_dq(), *run_dkv())
    want = fa._reference_backward(q, k, v, dout, lse, delta, pl, kl, scale, 0)
    cs.sync()
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        err = float((x.float() - w.float()).abs().max())
        if err > 1e-2 * max(1.0, float(w.float().abs().max())):
            raise AssertionError(f"[{tree}] {name}: max_abs_err {err} against the plain version")

    allowed = fa._allowed(s, s, pl, kl, 0, dev)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    a = cs._sdpa_args(*leaves, allowed)
    lib_out = F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3], enable_gqa=True)
    lib_grad = dout.transpose(1, 2)
    fwd = cs._sdpa_args(q, k, v, allowed)
    label = f"[{tree}] B{b} S{s} Hq{hq} Hkv{hkv} D{d}"
    dt = cs.device_times(label, [
        ("flash_attention_bwd_dq", run_dq),
        ("flash_attention_bwd_dkv", run_dkv),
        ("SDPA backward", lambda: torch.autograd.grad(lib_out, leaves, lib_grad,
                                                      retain_graph=True)),
        ("flash_attention_fwd", lambda: fa.flash_attention(q, k, v, pl, kl)),
        ("SDPA", lambda: F.scaled_dot_product_attention(fwd[0], fwd[1], fwd[2],
                                                        attn_mask=fwd[3], enable_gqa=True)),
    ])
    if None not in (dt["flash_attention_bwd_dq"], dt["flash_attention_bwd_dkv"]):
        print(f"  device B6 dq + dk/dv {label}: "
              f"{dt['flash_attention_bwd_dq'] + dt['flash_attention_bwd_dkv']:.4f} ms", flush=True)


def forward_kernels(cs, dev, tree):
    from paligemma_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    for label, (b, sq, skv, hq, hkv, d), pfx, kvl, q_off, timing in cs.FLASH_FWD_CASES:
        if timing is None:
            continue
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
        pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
        kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
        out = fa.flash_attention(q, k, v, pl, kl, q_offset=q_off)
        want = fa.reference_attention(q, k, v, pl, kl, q_offset=q_off)
        cs.sync()
        err = float((out.float() - want.float()).abs().max())
        if err > 1e-2 * max(1.0, float(want.float().abs().max())):
            raise AssertionError(f"[{tree}] B1 {label}: max_abs_err {err} against the plain "
                                 "version")
        del want
        cs.flash_fwd_device_times(f"[{tree}] {label}", q, k, v, pl, kl, q_off)


def tower_encode(cs, dev, tree, card):
    from paligemma_tpu_torch.convert import init_vision_params
    from paligemma_tpu_torch.core.config import paligemma_3b_896
    from paligemma_tpu_torch.models import siglip

    vcfg = paligemma_3b_896().vision_config
    vp = init_vision_params(vcfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev,
                            torch.bfloat16)
    px = torch.from_numpy(np.random.default_rng(cs.SEED).standard_normal(
        (1, 3, vcfg.image_size, vcfg.image_size), dtype=np.float32)).to(dev)

    def encode():
        return siglip.encode(vp, vcfg, px, attn="flash")

    ms = min(cs.cuda_ms(encode, 5), cs.cuda_ms(encode, 5))
    dev_ms, parts = cs.device_ms(encode, 3)
    busy = ("not measured" if dev_ms is None else f"{dev_ms:.3f} ms ("
            + ", ".join(f"{k[:40]} {us / 1e3:.3f} ms" for k, us in parts[:3]) + ")")
    print(f"tower [{tree}]: 896px ({vcfg.num_patches} patches, {vcfg.num_hidden_layers} layers) "
          f"attn='flash': {ms:.3f} ms per encode; device {busy}  [{card}]", flush=True)


def train_step(cs, dev, tree, card, steps):
    from paligemma_tpu_torch import paligemma_3b_224
    from paligemma_tpu_torch.convert import init_params
    from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = paligemma_3b_224()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev,
                         torch.bfloat16)
    batch = cs.train_batch(cfg)
    tr = Trainer(params, cfg, TrainConfig(lora_rank=8, lora_alpha=8.0, learning_rate=1e-3,
                                          remat=True),
                 generator=torch.Generator(dev).manual_seed(cs.SEED))
    times, losses = [], []
    for _ in range(steps):
        loss, ms = cs._timed_step(tr, batch)
        losses.append(loss)
        times.append(ms)
    print(f"train [{tree}]: step B{cs.TRAIN_B} S{cs.TRAIN_S} LoRA r8 remat: "
          f"{float(np.median(times[1:])):.3f} ms (median of {steps - 1}: "
          f"{' '.join(f'{t:.1f}' for t in times[1:])}); losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}  [{card}]", flush=True)
    cs._profile(f"[{tree}] train step B{cs.TRAIN_B} S{cs.TRAIN_S} LoRA r8 remat",
                lambda: tr.train_step(batch), 1, card, top=30, unit="step")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("train_attention_bench: no CUDA device")
    sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch
    cs = _smoke()
    from paligemma_tpu_torch.kernels import _build

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    tree = os.path.basename(os.getcwd())
    t0 = time.perf_counter()
    _build.library()
    print(f"bench [{tree}]: {Path(_build.__file__).parents[1]} built/loaded in "
          f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    attention_kernels(cs, dev, tree)
    forward_kernels(cs, dev, tree)
    tower_encode(cs, dev, tree, card)
    train_step(cs, dev, tree, card, steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
