"""The fp32 GEMV tile (``gemv_tile_sums_f32``: rows 3af, 3dmf, 4f, 5ef and
the fp32 LoRA expand of 3ef) of the ``paligemma_tpu_torch`` in the current
directory on one CUDA card, device times per call (torch.profiler's
device-side events) with the weights cold as in a decode step (each call
takes the next of enough copies to pass 60 MB; the L2 holds 50 MB), beside
the bf16 tile at the same shapes and the bytes bound:

* 3af: one layer's four GEMVs of Gemma-2B (qkv with the input norm, RoPE
  and the KV write; o + residual; gateup with the post-attention norm and
  GeGLU; down + residual) at 1, 8, 9 and 72 rows (a b1 step, an 8-slot
  tick, a b1 and an 8-slot speculative verify);
* 4f: the fused LM-head argmax at the same rows;
* 3dmf: the qkv GEMV at fp32 over a bf16 cache, B1;
* 5ef: mode 3 (the fp32 partial) and K1 (with a bank's delta) on rank 0 of
  m = 2 (o K1024, down K8192), B8;
* the fp32 expand: one layer's four GEMVs with a rank-8 bank of three
  adapters at B8, against the same GEMVs without.

Each fp32 case is first held to its plain fp32 version (within FP32_REL of
max(1, the largest element), TF32 off) and called twice for the same bits;
the worst error is printed. Then the times:

    cd <tree> && python3 <this repository>/tools/gemv_fp32_times.py [--rows 1,8,9,72] \
        [--what 3af,3dmf,4f,5ef,expand]

Run several trees in turns in one call on one card to compare them
(parent, change, change, parent). Every line names the tree, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())  # the tree under test provides paligemma_tpu_torch

HIDDEN, HEADS, HEAD_DIM, INTER, VOCAB = 2048, 8, 256, 16384, 257152
BANK_G = 24  # three rank-8 adapters
PROJ = (("qkv", HIDDEN, (HEADS + 2) * HEAD_DIM), ("o", HIDDEN, HIDDEN),
        ("gateup", HIDDEN, 2 * INTER), ("down", INTER, HIDDEN))


def _smoke():
    """This repository's chip_smoke.py as a module (it imports the package
    lazily, so the tree first on sys.path provides it)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Ctx:
    """The tree under test, its kernels' modules, the card, and the helpers
    every section uses."""

    def __init__(self, cs):
        from paligemma_tpu_torch.kernels import decode_head as dh
        from paligemma_tpu_torch.kernels import int8_gemv as gv

        self.cs, self.dh, self.gv = cs, dh, gv
        self.tree = Path(os.getcwd()).name
        self.dev = torch.device("cuda", 0)
        self.card = cs.card_line()
        self.gen = torch.Generator().manual_seed(cs.SEED + 29)
        self.worst = 0.0

    def rnd(self, *shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=self.gen) * scale).to(self.dev, dtype)

    def int8(self, k, n):
        return torch.randint(-127, 128, (k, n), generator=self.gen, dtype=torch.int8).to(self.dev)

    def scales(self, k, n):
        return (torch.rand(n, generator=self.gen).to(self.dev) + 0.5) / (127 * k**0.5)

    @staticmethod
    def cycling(fns):
        at = [0]

        def run():
            at[0] = (at[0] + 1) % len(fns)
            return fns[at[0]]()
        return run

    def check(self, label, run, want):
        """run() within FP32_REL of max(1, max |want|), the same bits twice."""
        got, again = run(), run()
        self.cs.sync()
        err = float((got.float() - want.float()).abs().max()) / max(
            1.0, float(want.float().abs().max()))
        same = torch.equal(got, again)
        self.worst = max(self.worst, err)
        if err > self.cs.FP32_REL or not same:
            raise AssertionError(f"[{self.tree}] {label}: error {err:.3e} (FP32_REL "
                                 f"{self.cs.FP32_REL}), same bits {same}")

    def times(self, label, fns, calls, n_bytes):
        cs = self.cs
        dt = cs.device_times(f"[{self.tree}] {label}", fns, iters=calls)
        bound = n_bytes / cs.PEAK_BYTES * 1e3
        print(f"times [{self.tree}] {label}: "
              + ", ".join(f"{n} {cs._ms(v)}" for n, v in dt.items())
              + f"; bound {bound:.4f} ms (bytes) | {self.card}", flush=True)
        return dt


def layer_times(c, weights, norms, rows_list):
    """3af: the four projections at each row count, fp32 and bf16 x."""
    gv, layer = c.gv, {}
    for rows in rows_list:
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            x, xd = c.rnd(rows, HIDDEN, dtype=dtype), c.rnd(rows, INTER, dtype=dtype)
            res = c.rnd(rows, HIDDEN, dtype=dtype)
            ang = torch.rand(rows, HEAD_DIM, generator=c.gen).to(c.dev) * 6.28
            cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
            pos = torch.full((rows,), 5, dtype=torch.int32, device=c.dev)
            bufs = ([c.rnd(rows, 16, HEAD_DIM, dtype=dtype) for _ in range(2)]
                    + [c.rnd(rows, HEAD_DIM, dtype=dtype) for _ in range(2)])
            norm1, norm2 = ((w.to(dtype), 1e-6) for w in norms)
            kws = {"o": {"residual": res}, "gateup": {"geglu": True, "norm": norm2},
                   "down": {"residual": res}}

            def call(name, w, s):
                if name == "qkv":
                    return gv.int8_gemv_rope_kv(x, w, s, cos, sin, pos, HEADS, *bufs,
                                                norm=norm1)[0]
                return gv.int8_gemv(xd if name == "down" else x, w, s, **kws[name])

            for name, k, n in PROJ:
                ws, s = weights[name]
                if dtype == torch.float32:  # qkv: its GEMV with the norm, before RoPE
                    xin, kw = (x, {"norm": norm1}) if name == "qkv" else (
                        xd if name == "down" else x, kws[name])
                    c.check(f"{name} B{rows}", lambda: gv.int8_gemv(xin, ws[0], s, **kw),
                            gv.int8_gemv_reference(xin, ws[0], s, **kw))
                esize = 4 if dtype == torch.float32 else 2
                out_n = n // 2 if name == "gateup" else n
                n_bytes = k * n + 4 * n + esize * rows * (k + out_n + (n if "residual" in
                                                                     kws.get(name, {}) else 0))
                fn = c.cycling([lambda w=w, s=s, name=name: call(name, w, s) for w in ws])
                dt = c.times(f"3af {name} {tag} B{rows} {k}->{n}", [(f"int8_gemv {tag}", fn)],
                             4 * len(ws), n_bytes)
                layer.setdefault((rows, tag), []).append(dt[f"int8_gemv {tag}"])
        for tag in ("fp32", "bf16"):
            v = layer[rows, tag]
            total = None if any(t is None for t in v) else sum(v)
            print(f"times [{c.tree}] 3af a layer's four {tag} B{rows}: {c.cs._ms(total)} | "
                  f"{c.card}", flush=True)
    print(f"check [{c.tree}] 3af worst error {c.worst:.3e} of max(1, max |plain|) | {c.card}",
          flush=True)


def dmf_times(c, qkv_weights, nw1):
    """3dmf: the qkv GEMV at fp32 over a bf16 cache (and over an fp32 one), B1."""
    ws, s = qkv_weights
    x = c.rnd(1, HIDDEN)
    ang = torch.rand(1, HEAD_DIM, generator=c.gen).to(c.dev) * 6.28
    cos, sin = ang.cos(), ang.sin()
    pos = torch.full((1,), 5, dtype=torch.int32, device=c.dev)
    bufs = {dt: [c.rnd(1, 16, HEAD_DIM, dtype=dt) for _ in range(2)]
            + [c.rnd(1, HEAD_DIM, dtype=dt) for _ in range(2)]
            for dt in (torch.float32, torch.bfloat16)}

    def rope(w, cache):
        return c.gv.int8_gemv_rope_kv(x, w, s, cos, sin, pos, HEADS, *bufs[cache],
                                      norm=(nw1, 1e-6))[0]

    c.times("3dmf B1 2048->2560 (and 3af's qkv, the fp32 cache)",
            [("int8_gemv_rope_kv_fp32_cache_bf16",
              c.cycling([lambda w=w: rope(w, torch.bfloat16) for w in ws])),
             ("int8_gemv_rope_kv_fp32", c.cycling([lambda w=w: rope(w, torch.float32)
                                                   for w in ws]))],
            4 * len(ws), HIDDEN * 2560 + 4 * 2560 + 4 * HIDDEN + 2 * 2 * HEAD_DIM * 2)


def head_times(c, rows_list):
    """4f: the fused head argmax (one copy: 527 MB, cold by itself), its ids
    the argmax of the fp32 logits path's GEMV."""
    dh, gv = c.dh, c.gv
    w8, s = c.int8(HIDDEN, VOCAB), c.scales(HIDDEN, VOCAB)
    head = dh.repack_head({"w8": w8, "s": s})
    for rows in rows_list:
        y = c.rnd(rows, HIDDEN)
        ids, mx = dh.head_argmax_fused(y, head, return_max=True)
        logits = gv.int8_gemv(y, w8, s)
        c.cs.sync()
        if not (torch.equal(ids.long(), logits.argmax(-1))
                and torch.equal(mx, logits.max(-1).values)):
            raise AssertionError(f"[{c.tree}] 4f B{rows}: not the argmax of the fp32 logits "
                                 "path")
        yb = y.to(torch.bfloat16)
        c.times(f"4f B{rows} 2048->257152", [
            ("head_argmax_fp32", lambda y=y: dh.head_argmax_fused(y, head)),
            ("head_argmax (bf16)", lambda yb=yb: dh.head_argmax_fused(yb, head))], 5,
            HIDDEN * VOCAB + 4 * VOCAB + 4 * rows * HIDDEN)


def partial_times(c):
    """5ef: mode 3 and K1 at rank 0 of m = 2 (o, down), B8."""
    gv = c.gv
    for name, k, n in (("o", HIDDEN // 2, HIDDEN), ("down", INTER // 2, HIDDEN)):
        ws = [c.int8(k, n) for _ in range(max(2, -(-60_000_000 // (k * n))))]
        s = c.scales(k, n)
        x, z, lb = c.rnd(8, k), c.rnd(8, BANK_G, scale=0.1), c.rnd(BANK_G, n, scale=0.01)
        c.check(f"5ef mode 3 {name} B8", lambda: gv.int8_gemv_f32(x, ws[0], s),
                gv.int8_gemv_reference(x, ws[0], s, out_fp32=True))
        c.check(f"5ef K1 {name} B8", lambda: gv.int8_gemv_f32(x, ws[0], s, lora=(z, lb, ())),
                gv.int8_gemv_reference(x, ws[0], s, out_fp32=True, lora=(z, lb, ())))
        xb, zb = x.to(torch.bfloat16), z.to(torch.bfloat16)
        c.times(f"5ef {name} m2 rank 0 B8 {k}->{n}", [
            ("int8_gemv_f32_fp32", c.cycling([lambda w=w: gv.int8_gemv_f32(x, w, s)
                                              for w in ws])),
            ("int8_gemv_f32 (bf16)", c.cycling([lambda w=w: gv.int8_gemv_f32(xb, w, s)
                                                for w in ws])),
            ("int8_gemv_f32_lora_fp32", c.cycling([lambda w=w: gv.int8_gemv_f32(
                x, w, s, lora=(z, lb, ())) for w in ws])),
            ("int8_gemv_f32_lora (bf16)", c.cycling([lambda w=w: gv.int8_gemv_f32(
                xb, w, s, lora=(zb, lb, ())) for w in ws]))], 4 * len(ws),
            k * n + 4 * n + 4 * 8 * (k + n))


def expand_times(c, weights, nw1, nw2):
    """The fp32 expand: one layer's four GEMVs at B8 with a bank, against
    the same GEMVs without."""
    gv = c.gv
    bounds = {"qkv": (2048, 2304), "o": (), "gateup": (INTER,), "down": ()}
    x, xd, res = c.rnd(8, HIDDEN), c.rnd(8, INTER), c.rnd(8, HIDDEN)
    ang = torch.rand(8, HEAD_DIM, generator=c.gen).to(c.dev) * 6.28
    cos, sin = ang.cos(), ang.sin()
    pos = torch.full((8,), 5, dtype=torch.int32, device=c.dev)
    bufs = [c.rnd(8, 16, HEAD_DIM), c.rnd(8, 16, HEAD_DIM), c.rnd(8, HEAD_DIM),
            c.rnd(8, HEAD_DIM)]

    def call(name, w, s, lo):
        if name == "qkv":
            return gv.int8_gemv_rope_kv(x, w, s, cos, sin, pos, HEADS, *bufs,
                                        norm=(nw1, 1e-6), lora=lo)
        if name == "gateup":
            return gv.int8_gemv(x, w, s, geglu=True, lora=lo, norm=(nw2, 1e-6))
        return gv.int8_gemv(xd if name == "down" else x, w, s, residual=res, lora=lo)

    total = {}
    for what in ("with the bank", "without"):
        v = []
        for name, k, n in PROJ:
            ws, s = weights[name]
            lo = None if what == "without" else (
                c.rnd(8, BANK_G * (len(bounds[name]) + 1), scale=0.1),
                c.rnd(BANK_G, n, scale=0.01), bounds[name])
            fn = c.cycling([lambda w=w, s=s, name=name, lo=lo: call(name, w, s, lo)
                            for w in ws])
            v.append(c.cs.device_times(f"[{c.tree}] fp32 expand B8 {name} {what}",
                                       [(name, fn)], iters=4 * len(ws))[name])
        total[what] = None if any(t is None for t in v) else sum(v)
    print(f"times [{c.tree}] fp32 expand, a layer's four GEMVs B8: with the bank "
          f"{c.cs._ms(total['with the bank'])}, without {c.cs._ms(total['without'])} | "
          f"{c.card}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="1,8,9,72")
    ap.add_argument("--what", default="3af,3dmf,4f,5ef,expand")
    args = ap.parse_args(argv)
    rows_list = [int(r) for r in args.rows.split(",")]
    what = args.what.split(",")
    cs = _smoke()
    if not torch.cuda.is_available():
        raise SystemExit("gemv_fp32_times: no CUDA device")
    from paligemma_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    lib_path = _build.build()
    _build.library()
    c = Ctx(cs)
    print(f"card [{c.tree}]: {torch.cuda.get_device_name(0)} | {c.card}", flush=True)
    cs.ptxas_lines(lib_path.parent / "ptxas.log", ("int8_gemv_kernelIf", "head_argmax_kernelIf"))
    weights = {}
    for name, k, n in PROJ:  # enough copies of each to pass the 50 MB L2
        weights[name] = ([c.int8(k, n) for _ in range(max(2, -(-60_000_000 // (k * n))))],
                         c.scales(k, n))
    norms = (c.rnd(HIDDEN, scale=0.1), c.rnd(HIDDEN, scale=0.1))
    if "3af" in what:
        layer_times(c, weights, norms, rows_list)
    if "3dmf" in what:
        dmf_times(c, weights["qkv"], norms[0])
    if "4f" in what:
        head_times(c, rows_list)
    if "5ef" in what:
        partial_times(c)
    if "expand" in what:
        expand_times(c, weights, *norms)


if __name__ == "__main__":
    main()
