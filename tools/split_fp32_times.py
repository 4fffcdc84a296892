"""The fp32 split decode attention (rows 3bf, 9f, 11f and the mixed 3bmf,
9mf: ``attn_split_f32`` and its combine) of the ``paligemma_tpu_torch`` in
the current directory on one CUDA card, beside the bf16 pass (3b, 9) at the
same shapes and one fp32 SDPA on the same keys:

* 3bf: the dense cache, B1 W2048 Hq8 Hkv1 D256 (a b1 decode step), and B8;
* 3bmf: fp32 q over a bf16 cache at B1 W2048;
* 9f: the paged pool, B8 W1024 page size 64 at layer 17 of an 18-layer
  pool, fragmented pages, one empty row (an 8-slot tick); 9mf over a bf16
  pool;
* 11f: B10's fp32 form (two segments, B1 W2048 Hq8 Hkv1 D256).

Each fp32 and mixed case is first held to its plain fp32 version (within
FP32_REL of the largest element, TF32 off) and called twice for the same
bits; then its device time per call (torch.profiler's device-side events,
split and combine apart) and the bytes bound (the keys' bytes in the
cache's dtype):

    cd <tree> && python3 <this repository>/tools/split_fp32_times.py

Run several trees in turns in one call on one card to compare them
(parent, change, change, parent). Every line names the tree, and the
card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch

D, HQ, PS, LAYERS, LAYER = 256, 8, 64, 18, 17


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
        raise SystemExit("split_fp32_times: no CUDA device")
    from paligemma_tpu_torch.kernels import _build
    from paligemma_tpu_torch.kernels import decode_attention as da
    from paligemma_tpu_torch.kernels import paged_attention as pa
    from paligemma_tpu_torch.kernels.ablation import decode_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = Path(os.getcwd()).name
    dev = torch.device("cuda", 0)
    lib_path = _build.build()
    _build.library()
    print(f"card [{tree}]: {torch.cuda.get_device_name(0)} | {cs.card_line()}", flush=True)
    cs.ptxas_lines(lib_path.parent / "ptxas.log", ("attn_split",))
    gen = torch.Generator().manual_seed(cs.SEED + 28)
    rng = np.random.default_rng(cs.SEED + 28)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def check(label, run, want):
        got, again = run(), run()
        cs.sync()
        err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
        same = torch.equal(got, again)
        print(f"check [{tree}] {label}: {err:.3e} of max against the plain fp32 version; same "
              f"bits {same}", flush=True)
        if err > cs.FP32_REL or not same:
            raise AssertionError(f"[{tree}] {label}: error {err:.3e} (FP32_REL {cs.FP32_REL}), "
                                 f"same bits {same}")

    def report(label, fns, n_keys, cache_bytes):
        dt = cs.device_times(f"[{tree}] {label}", fns, iters=20)
        bound = cs.bound_ms(4 * D * HQ * n_keys, 2 * n_keys * D * cache_bytes,
                            cs.PEAK_FP32_FLOPS)
        print(f"times [{tree}] {label}: " + ", ".join(f"{n} {cs._ms(v)}" for n, v in dt.items())
              + f"; bound {bound:.5f} ms (bytes) | {cs.card_line()}", flush=True)

    # -- 3bf / 3bmf: the dense cache, W2048
    for b in (1, 8):
        q = rnd(b, HQ, D)
        kc, vc = rnd(b, 2048, D), rnd(b, 2048, D)
        lens = torch.tensor([2048 - 61 * i for i in range(b)], device=dev)
        valid = (torch.arange(2048, device=dev)[None] < lens[:, None]).contiguous()
        n_keys = int(valid.sum())
        scale = D**-0.5
        kb, vb, qb = kc.to(torch.bfloat16), vc.to(torch.bfloat16), q.to(torch.bfloat16)

        def fp32(q=q, kc=kc, vc=vc, valid=valid):
            return da.decode_attention(q, kc, vc, valid, scale)

        def mixed(q=q, kb=kb, vb=vb, valid=valid):
            return da.decode_attention(q, kb, vb, valid, scale)

        def bf16(qb=qb, kb=kb, vb=vb, valid=valid):
            return da.decode_attention(qb, kb, vb, valid, scale)

        a = (q[:, :, None], kc[:, None], vc[:, None], valid[:, None, None])

        def sdpa(a=a):
            return F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3], scale=scale,
                                                  enable_gqa=True)

        label = f"3bf B{b} W2048 Hq8 Hkv1 D256"
        check(label, fp32, da.decode_attention_reference(q, kc, vc, valid, scale))
        fns = [("decode_attention_fp32", fp32), ("decode_attention (bf16)", bf16),
               ("SDPA fp32", sdpa)]
        if b == 1:
            check("3bmf B1 W2048", mixed, da.decode_attention_reference(q, kb, vb, valid, scale))
            fns.insert(1, ("decode_attention_fp32_cache_bf16", mixed))
        report(label, fns, n_keys, 4)
        if b == 1:
            print(f"  (3bmf and bf16 3b read the bf16 cache: bound "
                  f"{cs.bound_ms(0, 2 * n_keys * D * 2):.5f} ms)", flush=True)
        del kc, vc, kb, vb

    # -- 9f / 9mf: B8 W1024 page size 64 at layer 17, fragmented pages
    b, w = 8, 1024
    n_p = w // PS
    n_pages = b * n_p + 1
    kp, vp = rnd(LAYERS, n_pages, PS, 1, D), rnd(LAYERS, n_pages, PS, 1, D)
    table = torch.from_numpy((rng.permutation(n_pages - 1) + 1).reshape(b, n_p).astype(
        np.int32)).to(dev)
    lens = [w - 61 * i for i in range(b)]
    lens[3] = 0
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = rnd(b, HQ, D)
    kpb, vpb, qb = kp.to(torch.bfloat16), vp.to(torch.bfloat16), q.to(torch.bfloat16)

    def paged(q=q, kp=kp, vp=vp):
        return pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=LAYER)

    def paged_mixed(q=q, kp=kpb, vp=vpb):
        return pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=LAYER)

    def paged_bf16(q=qb, kp=kpb, vp=vpb):
        return pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=LAYER)

    kd = kp[LAYER][table.long()].reshape(b, w, D)
    vd = vp[LAYER][table.long()].reshape(b, w, D)
    pmask = (torch.arange(w, device=dev)[None] < kv_len[:, None].long())[:, None, None]

    def sdpa_paged():
        return F.scaled_dot_product_attention(q[:, :, None], kd[:, None], vd[:, None],
                                              attn_mask=pmask, enable_gqa=True)

    label = "9f B8 W1024 ps64 layer17"
    check(label, paged, pa.reference_paged_decode_attention(q, kp, vp, table, kv_len,
                                                            layer_idx=LAYER))
    check("9mf B8 W1024 ps64 layer17", paged_mixed,
          pa.reference_paged_decode_attention(q, kpb, vpb, table, kv_len, layer_idx=LAYER))
    report(label, [("paged_decode_attention_fp32", paged),
                   ("paged_decode_attention_fp32_cache_bf16", paged_mixed),
                   ("paged_decode_attention (bf16)", paged_bf16),
                   ("SDPA fp32 (keys gathered)", sdpa_paged)], sum(lens), 4)
    print(f"  (9mf and bf16 9 read the bf16 pool: bound "
          f"{cs.bound_ms(0, 2 * sum(lens) * D * 2):.5f} ms)", flush=True)
    del kp, vp, kpb, vpb, kd, vd

    # -- 11f: B10's fp32 form, two segments
    q = rnd(1, HQ, D)
    kc, vc = rnd(1, 2048, 1, D), rnd(1, 2048, 1, D)
    seg0, seg1, kvl = (torch.tensor([v], dtype=torch.int32, device=dev) for v in (266, 400, 2048))

    def seg():
        return sa.decode_attention(q, kc, vc, seg0, seg1, kvl)

    label = "11f B1 W2048 Hq8 Hkv1 D256 segments [0, 266) + [400, 2048)"
    check(label, seg, sa.reference_decode_attention(q, kc, vc, seg0, seg1, kvl))
    report(label, [("seg_decode_attention_fp32", seg)], 266 + 2048 - 400, 4)


if __name__ == "__main__":
    main()
