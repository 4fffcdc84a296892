"""Device time of the vision-tower attention (B12) and of the split-K
decode attention kernels (3b dense, B5 paged, B10 seg) of the
``paligemma_tpu_torch`` in the current directory, each beside one PyTorch
call for the same function (SDPA) and B12 beside the flash forward (B1):
torch.profiler's device-side events over 20 calls, per call, every event
apart (so the split and the combine pass of 3b print apart), with the max
|error| against the plain version. It checks nothing, so diagnostic
builds run too. It also prints the host time of B12's tensor maps where
the tree has them:

    cd <tree> && python3 <this repository>/tools/attention_times.py [b12 | split]

(``b12`` or ``split``: only those kernels.) Run several trees in turns in one call on one card to compare them.
"""

import ctypes
import os
import sys
import time

sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from paligemma_tpu_torch.kernels import _build  # noqa: E402
from paligemma_tpu_torch.kernels import decode_attention as da  # noqa: E402
from paligemma_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paligemma_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from paligemma_tpu_torch.kernels.ablation import decode_attention as sda  # noqa: E402
from paligemma_tpu_torch.kernels.ablation import vision_attention as va  # noqa: E402

ITERS = 20


def device_us(fn):
    """[(event, us per call)] of ``fn`` on the device, largest first."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / ITERS) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def show(tree, label, name, fn, err=None):
    rows = device_us(fn)
    total = sum(us for _, us in rows)
    parts = ", ".join(f"{k[:40]} {us:.2f}" for k, us in rows[:4])
    tail = "" if err is None else f"  err {err:.3e}"
    print(f"times [{tree}] {label:26s} {name:22s} {total:9.2f} us ({parts}){tail}", flush=True)


def err_of(got, want):
    return float((got.float() - want.float()).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("attention_times: no CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    tree = os.path.basename(os.getcwd())
    only = sys.argv[1] if len(sys.argv) > 1 else None

    def bf(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    # B12 at the 224 / 448 / 896 px towers (B1 H16 D72), B1 and SDPA beside it
    for s in (256, 1024, 4096) if only in (None, "b12") else ():
        q, k, v = bf(1, s, 16, 72), bf(1, s, 16, 72), bf(1, s, 16, 72)
        label = f"B12 B1 S{s} H16 D72"
        e = err_of(va.vision_attention(q, k, v), va.vision_attention_reference(q, k, v, 72**-0.5))
        show(tree, label, "vision_attention", lambda: va.vision_attention(q, k, v), e)
        lens = torch.tensor([s], dtype=torch.int32, device=dev)
        show(tree, label, "flash_attention_fwd", lambda: fa.flash_attention(q, k, v, lens, lens))
        t = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        show(tree, label, "SDPA", lambda: F.scaled_dot_product_attention(*t))
        fn = getattr(_build.library(), "pg_vision_attention_maps", None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
            n = 2000
            t0 = time.perf_counter()
            fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), 1, s, 16, 72, va.rows_per_block(1, s, 16), n)
            us = (time.perf_counter() - t0) / n * 1e6
            print(f"times [{tree}] {label:26s} {'tensor maps (host)':22s} {us:9.2f} us per call",
                  flush=True)

    if only == "b12":
        return 0
    # 3b: the dense window, Hq8 Hkv1 D256, beside SDPA with a bool mask and GQA
    for b, w in ((1, 512), (1, 2048), (8, 2048)):
        q = bf(b, 8, 256)
        kc, vc = bf(b, 2048, 256), bf(b, 2048, 256)
        lens = torch.tensor([w - 61 * i for i in range(b)], device=dev)
        valid = (torch.arange(w, device=dev)[None] < lens[:, None]).contiguous()
        label = f"3b B{b} W{w}"
        e = err_of(da.decode_attention(q, kc, vc, valid, 256**-0.5),
                   da.decode_attention_reference(q, kc, vc, valid, 256**-0.5))
        show(tree, label, "decode_attention",
             lambda: da.decode_attention(q, kc, vc, valid, 256**-0.5), e)
        t = (q[:, :, None], kc[:, None, :w], vc[:, None, :w], valid[:, None, None])
        show(tree, label, "SDPA", lambda: F.scaled_dot_product_attention(
            t[0], t[1], t[2], attn_mask=t[3], scale=256**-0.5, enable_gqa=True))

    # B5: paged, B8 W1024 page size 64, layer 17 of an 18-layer pool
    b, w, ps = 8, 1024, 64
    n_p = w // ps
    kp, vp = bf(18, b * n_p + 1, ps, 1, 256), bf(18, b * n_p + 1, ps, 1, 256)
    table = (1 + torch.randperm(b * n_p, generator=torch.Generator().manual_seed(0))).reshape(
        b, n_p).to(torch.int32).to(dev)
    kv_len = torch.tensor([w - 61 * i for i in range(b)], dtype=torch.int32, device=dev)
    q = bf(b, 8, 256)
    e = err_of(pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17),
               pa.reference_paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17))
    show(tree, "B5 B8 W1024 ps64", "paged_decode_attention",
         lambda: pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17), e)
    kd = kp[17][table.long()].reshape(b, w, 256)
    vd = vp[17][table.long()].reshape(b, w, 256)
    mask = (torch.arange(w, device=dev)[None] < kv_len[:, None].long())[:, None, None]
    show(tree, "B5 B8 W1024 ps64", "SDPA (gathered keys)", lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd[:, None], vd[:, None], attn_mask=mask, enable_gqa=True))

    # B10: the two-segment cache, B1 contiguous and B8 with holes (S_max 2048)
    rows = ([2048, 64, 250, 256, 300, 33, 97, 700], [2048, 64, 266, 640, 300, 33, 1200, 700],
            [2048, 64, 1000, 1024, 300, 33, 1500, 700])
    for b in (1, 8):
        q, kc, vc = bf(b, 8, 256), bf(b, 2048, 1, 256), bf(b, 2048, 1, 256)
        segs = [torch.tensor(r[:b], dtype=torch.int32, device=dev) for r in rows]
        label = f"B10 B{b} S2048" + (" holes" if b > 1 else "")
        e = err_of(sda.decode_attention(q, kc, vc, *segs),
                   sda.reference_decode_attention(q, kc, vc, *segs))
        show(tree, label, "seg_decode_attention", lambda: sda.decode_attention(q, kc, vc, *segs), e)
        col = torch.arange(2048, device=dev)[None]
        mask = ((col < segs[0][:, None]) | ((col >= segs[1][:, None])
                                           & (col < segs[2][:, None])))[:, None, None]
        t = (q[:, :, None], kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3), mask)
        show(tree, label, "SDPA", lambda: F.scaled_dot_product_attention(
            t[0], t[1], t[2], attn_mask=t[3], enable_gqa=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
