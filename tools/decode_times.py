"""One decode step and one serving tick of the ``paligemma_tpu_torch`` in
the current directory, on the device and on the host, by this repository's
chip_smoke functions run on that tree:

* ``fused``: the device time of one decoder layer's norms, qkv, RoPE and
  gateup at B = 1 and 8, weights cold (``chip_smoke.fused_device_times``:
  the GEMVs with the norm prologue and the RoPE + KV write epilogue where
  the tree has them, else the separate rms_norm and rope_kv_write
  kernels beside the GEMVs);
* ``step``: PaliGemma-3B-224 at full width (random weights from the seed
  in ``--dtype``, bfloat16 or float32, int8 decode tree): the b1 greedy
  decode step at window 512 (host wall
  per step over 32 steps of ``decode_chunk``, three times; one profiled
  window of 8 steps: device busy, device events, launches per decoder
  layer, the wrappers' calls per step), then the paged fused serving tick
  with 8 live rows (host wall per tick over 4 windows of 8 ticks; one
  profiled window).

It checks nothing, so diagnostic builds run too:

    cd <tree> && python3 <this repository>/tools/decode_times.py [--label L] [--what fused,step] \
        [--dtype float32]

Run trees in turns (parent, change, change, parent) in one call on one
card to compare them.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch

import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This repository's chip_smoke.py (the tree under test may hold an
    older one)."""
    spec = importlib.util.spec_from_file_location("decode_chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _per(counts, before, n):
    return {k: (v - before.get(k, 0)) / n for k, v in counts.items() if v - before.get(k, 0)}


def step_times(cs, dev, card, tree, dtype=torch.bfloat16):
    from paligemma_tpu_torch import kernels, paligemma_3b_224
    from paligemma_tpu_torch.convert import init_params
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    cfg = paligemma_3b_224()
    n_layers = cfg.text_config.num_hidden_layers
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev, dtype)
    decode = quantize_lm_for_serving(params)
    eng = PaliGemmaEngine(params, cfg, max_seq_len=cs.MAX_SEQ, decode_params=decode)
    pixels, ids, mask = cs.make_inputs(cfg, dev)
    walls = [cs.decode_step_ms(eng, pixels, ids, mask) for _ in range(3)]
    print(f"step [{tree}] b1 greedy decode W512: host wall per step "
          f"{', '.join(f'{w:.4f}' for w in walls)} ms ({1000.0 / min(walls):.1f} tok/s at the "
          f"fastest)  [{card}]", flush=True)

    def window(e, n):
        ls = e.prefill(pixels, ids, mask)
        e.decode_chunk(ls[0], ls[1], n, kv_bucket=512)  # warm-up
        ls = e.prefill(pixels, ids, mask)
        cs.sync()
        return lambda: e.decode_chunk(ls[0], ls[1], n, kv_bucket=512)

    run = window(eng, 8)
    before = kernels.launch_counts()
    run()
    cs.sync()
    calls = json.dumps(_per(kernels.launch_counts(), before, 8))
    print(f"step [{tree}] b1: wrapper calls per step {calls}", flush=True)
    got = cs._profile(f"[{tree}] greedy decode B1 W512, 8 steps", window(eng, 8), 8, card)
    if got is not None:
        per_layer, norms, rope = cs.layer_launches(got[1], n_layers)
        print(f"step [{tree}] b1: device launches per decoder layer {per_layer:.2f}, final "
              f"norms per step {norms:.2f}, separate RoPE kernels {rope / 8:.1f} a step",
              flush=True)
    del eng

    paged = PagedServingEngine(params, cfg, decode_params=decode, page_size=cs.PAGE,
                               n_pages=cs.FULL_POOL, paged_kernel="fused", **cs.SERVE)
    for r in cs.serving_requests(cfg)[:8]:
        r.max_new_tokens = 200
        paged.submit(r)
    paged.step()  # prefill the 8 rows and decode a first window
    paged.step()
    cs.sync()
    ticks = cs.SERVE["sync_every"]
    t0 = time.perf_counter()
    for _ in range(4):
        paged.step()
    cs.sync()
    tick_ms = (time.perf_counter() - t0) * 1e3 / (4 * ticks)
    print(f"step [{tree}] paged fused tick, 8 live rows: host wall per tick {tick_ms:.4f} ms "
          f"({8 * 1000.0 / tick_ms:.1f} tok/s over the 8 rows)  [{card}]", flush=True)
    before = kernels.launch_counts()
    paged.step()
    cs.sync()
    print(f"step [{tree}] paged tick: wrapper calls per tick "
          f"{json.dumps(_per(kernels.launch_counts(), before, ticks))}", flush=True)
    got = cs._profile(f"[{tree}] paged fused greedy window B8, {ticks} ticks", paged.step, ticks,
                      card, unit="tick")
    if got is not None:
        per_layer, norms, rope = cs.layer_launches(got[1], n_layers)
        print(f"step [{tree}] paged tick: device launches per decoder layer {per_layer:.2f}, "
              f"final norms per tick {norms:.2f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--what", default="fused,step")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    tree = " ".join(filter(None, [os.path.basename(os.getcwd()), args.label,
                                  "" if args.dtype == "bfloat16" else args.dtype]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"decode [{tree}] card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs, dev = _chip_smoke(), torch.device("cuda")
    for what in args.what.split(","):
        if what == "fused":
            cs.fused_device_times(dev, label=tree)
        elif what == "step":
            step_times(cs, dev, card, tree, getattr(torch, args.dtype))
        else:
            raise SystemExit(f"decode_times: --what takes fused, step (got {what!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
