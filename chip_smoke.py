"""GPU smoke run of paligemma_tpu_torch: build the hand-written Hopper
kernels, check each against its plain PyTorch version at the shapes of the
main path, then drive the int8 greedy inference path of PaliGemma-3B-224
(full widths, random weights from a seed) through PaliGemmaEngine.generate
and hold it against the plain path.

    python3 chip_smoke.py          # needs one CUDA card, nvcc and triton

Prints per-phase lines, then a JSON line with one entry per kernel, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit code
is not 0 and the last line is never printed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_TEXT = 10  # text tokens after the 256 image tokens
N_NEW = 64  # greedy tokens per generate
MAX_SEQ = 2048
# Teacher-forced logits of the kernel path vs the plain path, relative to
# the plain path's max |logit|. Both take fp32 int8 dots and bf16
# activations through 18 layers, but round to bf16 at different places
# (fused GEMV epilogues and fp32 attention vs per-op bf16), so they differ
# by a few bf16 ulps (2^-8 = 0.0039) of the largest logit: 7.69e-3 on an
# NVIDIA H100 80GB HBM3 at 700 W. The tolerance is about 4x that reading; a
# kernel that dropped or garbled a term is off by O(1).
LOGIT_REL_TOL = 3e-2


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def timed_pair(kernel_fn, plain_fn, iters: int):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return min(k1, k2), min(p1, p2)


class KernelReport:
    """Per-kernel max error, tolerance check and times."""

    def __init__(self):
        self.rows = {}

    def case(self, name, label, got, want, rel_tol):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: non-finite output")
        err = float((got - want).abs().max())
        tol = rel_tol * max(1.0, float(want.abs().max()))
        ok = err <= tol
        print(f"  {name:20s} {label:44s} max_abs_err {err:.3e}  tol {tol:.3e}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        row = self.rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if not ok:
            raise AssertionError(f"{name} {label}: max_abs_err {err} > {tol}")

    def time(self, name, label, kernel_fn, plain_fn, iters=20):
        k, p = timed_pair(kernel_fn, plain_fn, iters)
        print(f"  {name:20s} {label:44s} kernel {k:.4f} ms  plain {p:.4f} ms", flush=True)
        row = self.rows[name]
        row["ms"] = row.get("ms", 0.0) + k
        row["plain_ms"] = row.get("plain_ms", 0.0) + p


def kernel_phase(report: KernelReport, dev):
    from paligemma_tpu_torch.kernels import decode_attention as da
    from paligemma_tpu_torch.kernels import decode_elementwise as el
    from paligemma_tpu_torch.kernels import decode_head as dh
    from paligemma_tpu_torch.kernels import flash_attention as fa
    from paligemma_tpu_torch.kernels import int8_gemv as gv

    rng = np.random.default_rng(SEED)

    def bf(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    def int8_weight(k, n):
        w8 = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(dev)
        s = torch.from_numpy((rng.random(n, dtype=np.float32) + 0.5) / (127.0 * k**0.5)).to(dev)
        return w8, s

    # -- flash attention forward: LM prefill (256 image + 10 text tokens),
    # a causal suffix (prefix < kv_len), the 896 px vision tower's head_dim
    print("kernels: flash_attention_fwd", flush=True)
    for label, (b, s, hq, hkv, d), pfx_gap, timed in [
        ("LM prefill B1 S266 Hq8 Hkv1 D256", (1, 266, 8, 1, 256), 0, True),
        ("prefix<kv_len B2 S266 Hq8 Hkv1 D256", (2, 266, 8, 1, 256), 40, False),
        ("vision B2 S256 H16 D72", (2, 256, 16, 16, 72), 0, False),
    ]:
        q, k, v = bf(b, s, hq, d), bf(b, s, hkv, d), bf(b, s, hkv, d)
        kv_len = torch.tensor([s - 7 * i for i in range(b)], dtype=torch.int32, device=dev)
        pfx = (kv_len - pfx_gap).to(torch.int32)
        got = fa.flash_attention(q, k, v, pfx, kv_len)
        want = fa.reference_attention(q, k, v, pfx, kv_len)
        sync()
        report.case("flash_attention_fwd", label, got, want, 1e-2)
        if timed:
            report.time("flash_attention_fwd", label,
                        lambda: fa.flash_attention(q, k, v, pfx, kv_len),
                        lambda: fa.reference_attention(q, k, v, pfx, kv_len))

    # -- int8 GEMV at the four layer projections and the LM head
    print("kernels: int8_gemv", flush=True)
    shapes = [("qkv", 2048, 2560, {}), ("o+res", 2048, 2048, {"residual": True}),
              ("gateup+GeGLU", 2048, 32768, {"geglu": True}),
              ("down+res", 16384, 2048, {"residual": True}), ("head", 2048, 257152, {})]
    for name, k, n, kw in shapes:
        w8, s = int8_weight(k, n)
        for b in (1, 8, 33):  # 33: no 32-row cap as on the TPU
            x = bf(b, k)
            args = {}
            if kw.get("residual"):
                args["residual"] = bf(b, n)
            if kw.get("geglu"):
                args["geglu"] = True
            got = gv.int8_gemv(x, w8, s, **args)
            want = gv.int8_gemv_reference(x, w8, s, **args)
            sync()
            label = f"{name} B{b} {k}->{n}"
            report.case("int8_gemv", label, got, want, 1e-2)
            # ms in the JSON: one layer's four GEMVs at B=1 (head apart)
            if b == 1 and name != "head":
                report.time("int8_gemv", label, lambda: gv.int8_gemv(x, w8, s, **args),
                            lambda: gv.int8_gemv_reference(x, w8, s, **args))
            elif b == 1:
                k_ms, p_ms = timed_pair(lambda: gv.int8_gemv(x, w8, s),
                                        lambda: gv.int8_gemv_reference(x, w8, s), 5)
                print(f"  {'int8_gemv':20s} {label:44s} kernel {k_ms:.4f} ms  "
                      f"plain {p_ms:.4f} ms (not in the JSON sum)", flush=True)
        del w8, s

    # -- decode attention over one layer's window, ragged validity at B=4
    print("kernels: decode_attention", flush=True)
    for w in (512, 2048):
        for b in (1, 4, 33):
            q = bf(b, 8, 256)
            kc, vc = bf(b, MAX_SEQ, 256), bf(b, MAX_SEQ, 256)
            lens = [1 + (w - 2 - 97 * i) % (w - 1) for i in range(b)]  # in [1, W)
            valid = torch.zeros((b, w), dtype=torch.bool, device=dev)
            for i, n_ok in enumerate(lens):
                valid[i, :n_ok] = True
            if b > 1:
                valid[1, 5:40] = False  # a hole
            got = da.decode_attention(q, kc, vc, valid, 256**-0.5)
            want = da.decode_attention_reference(q, kc, vc, valid, 256**-0.5)
            sync()
            label = f"B{b} W{w} D256 Hq8"
            report.case("decode_attention", label, got, want, 1e-2)
            if b == 1 and w == 2048:
                report.time("decode_attention", label,
                            lambda: da.decode_attention(q, kc, vc, valid, 256**-0.5),
                            lambda: da.decode_attention_reference(q, kc, vc, valid, 256**-0.5))

    # -- RMSNorm and the fused RoPE + cache write
    print("kernels: rms_norm, rope_kv_write", flush=True)
    for b in (1, 8):
        x, wn = bf(b, 2048), bf(2048, scale=0.1)
        got, want = el.rms_norm(x, wn, 1e-6), el.rms_norm_reference(x, wn, 1e-6)
        sync()
        report.case("rms_norm", f"B{b} K2048", got, want, 1e-2)
        if b == 1:
            report.time("rms_norm", f"B{b} K2048", lambda: el.rms_norm(x, wn, 1e-6),
                        lambda: el.rms_norm_reference(x, wn, 1e-6))
        qkv = bf(b, 2560)
        ang = torch.from_numpy(rng.random((b, 256), dtype=np.float32) * 6.28).to(dev)
        cos, sin = ang.cos().to(torch.bfloat16), ang.sin().to(torch.bfloat16)
        pos = torch.tensor([300 + 13 * i for i in range(b)], dtype=torch.int32, device=dev)
        caches = [torch.zeros((b, MAX_SEQ, 256), dtype=torch.bfloat16, device=dev) for _ in range(4)]
        rows = [torch.empty((b, 256), dtype=torch.bfloat16, device=dev) for _ in range(4)]
        kern = (qkv, cos, sin, pos, 8, caches[0], caches[1], rows[0], rows[1])
        plain = (qkv, cos, sin, pos, 8, caches[2], caches[3], rows[2], rows[3])
        qk, _, _ = el.rope_kv_write(*kern)
        qp, _, _ = el.rope_kv_write_reference(*plain)
        sync()
        report.case("rope_kv_write", f"B{b} q", qk, qp, 1e-2)
        report.case("rope_kv_write", f"B{b} k/v cache rows and k_new/v_new",
                    torch.cat([c.flatten() for c in caches[:2] + rows[:2]]),
                    torch.cat([c.flatten() for c in caches[2:] + rows[2:]]), 1e-2)
        if b == 1:
            report.time("rope_kv_write", f"B{b} Hq8 D256",
                        lambda: el.rope_kv_write(*kern),
                        lambda: el.rope_kv_write_reference(*plain))

    # -- LM-head argmax: random inputs, then a planted three-way tie
    print("kernels: head_argmax", flush=True)
    w8, s = int8_weight(2048, 257152)
    head = dh.repack_head({"w8": w8, "s": s})
    for b in (1, 8):
        y = bf(b, 2048)
        ids, mx = dh.head_argmax_fused(y, head, return_max=True)
        logits = gv.int8_gemv(y, w8, s).float()  # the logits path's own head
        plain = ((y.float() @ w8.float()) * s).to(torch.bfloat16).float()
        sync()
        if not (torch.equal(ids.long(), logits.argmax(-1)) and torch.equal(mx, logits.max(-1).values)):
            raise AssertionError("head_argmax: differs from argmax of the int8_gemv logits")
        # against the plain version: the kernel's winner is a maximum of the
        # plain logits up to the bf16 rounding of a reordered fp32 sum
        win_plain = plain.gather(1, ids.long()[:, None])[:, 0]
        report.case("head_argmax", f"B{b} winning logit vs plain max", win_plain,
                    plain.max(-1).values, 1e-2)
        report.case("head_argmax", f"B{b} returned max vs plain", mx, plain.max(-1).values, 1e-2)
        if b == 1:
            report.time("head_argmax", f"B{b} 2048->257152",
                        lambda: dh.head_argmax_fused(y, head),
                        lambda: dh.reference_head_argmax(y, {"w8": w8, "s": s}), iters=5)
    y = bf(1, 2048)
    j0, dups = 1000, (70000, 257000)
    w8[:, j0] = torch.where(y[0] > 0, 127, -127).to(torch.int8)
    s[j0] = 1.0
    for j in dups:
        w8[:, j] = w8[:, j0]
        s[j] = s[j0]
    head = dh.repack_head({"w8": w8, "s": s})
    ids = dh.head_argmax_fused(y, head)
    sync()
    tie = int(ids[0])
    print(f"  {'head_argmax':20s} {'planted tie at ' + str((j0,) + dups):44s} -> id {tie}  "
          f"{'ok' if tie == j0 else 'FAIL'}", flush=True)
    if tie != j0:
        raise AssertionError(f"head_argmax: planted tie resolved to {tie}, not {j0}")
    del w8, s, head


def make_inputs(cfg, dev):
    rng = np.random.default_rng(SEED)
    n_img = cfg.vision_config.num_patches
    ids = np.concatenate([np.full((1, n_img), cfg.image_token_index),
                          rng.integers(2, min(1000, cfg.image_token_index), (1, N_TEXT))], 1).astype(np.int64)
    px = cfg.vision_config.image_size
    pixels = rng.standard_normal((1, 3, px, px), dtype=np.float32)
    return (torch.from_numpy(pixels).to(dev), torch.from_numpy(ids).to(dev),
            torch.ones((1, ids.shape[1]), dtype=torch.int32, device=dev))


def main_path(dev, card):
    from paligemma_tpu_torch import kernels, paligemma_3b_224
    from paligemma_tpu_torch.convert import init_params
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving

    cfg = paligemma_3b_224()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, torch.bfloat16)
    decode = quantize_lm_for_serving(params)
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"main: 3B-224 weights (bf16 {n_bytes / 2**30:.2f} GiB) + int8 decode tree in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    eng = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode)
    if not (eng.use_flash and eng.fused_layer and eng._greedy_head_fused):
        raise AssertionError("kernel engine did not select the kernel paths")
    plain = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode,
                            use_flash=False, fused_layer=False)
    pixels, ids, mask = make_inputs(cfg, dev)

    kernels.reset_launch_counts()
    tok1 = eng.generate(pixels, ids, mask, max_new_tokens=N_NEW, eos_token_id=-1, sync_every=1)
    tok16 = eng.generate(pixels, ids, mask, max_new_tokens=N_NEW, eos_token_id=-1, sync_every=16)
    sync()
    counts = kernels.launch_counts()
    print(f"main: launches during generate(sync_every=1) + generate(sync_every=16): "
          f"{json.dumps(counts)}", flush=True)
    if tok1.shape != (1, N_NEW) or not np.array_equal(tok1, tok16):
        raise AssertionError(f"sync_every=1 vs 16 tokens differ:\n{tok1}\n{tok16}")
    print(f"main: sync_every=1 and 16 emit the same {N_NEW} tokens: {tok1[0, :16].tolist()} ...",
          flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # teacher-force the emitted tokens through both engines
    lk, sk = eng.prefill(pixels, ids, mask)
    lp, sp = plain.prefill(pixels, ids, mask)
    worst, flips = _compare(lk, lp, "prefill", tok1[0, 0])
    for t in range(N_NEW - 1):
        tok = torch.from_numpy(tok1[:, t])
        lk, sk = eng.decode_step(tok, sk)
        lp, sp = plain.decode_step(tok, sp)
        w, f = _compare(lk, lp, f"decode {t}", tok1[0, t + 1])
        worst, flips = max(worst, w), flips + f
    sync()
    print(f"main: teacher-forced logits, kernel vs plain path: max rel err {worst:.3e} "
          f"(tol {LOGIT_REL_TOL}) over prefill + {N_NEW - 1} steps; "
          f"near-tie steps skipped in the token check: {flips}", flush=True)

    # speed: TTFT (prefill incl. vision) and b1 decode tok/s, CUDA events
    perf = {}
    for name, e in (("kernels", eng), ("plain", plain)):
        ttft = sorted(cuda_ms(lambda: e.prefill(pixels, ids, mask), 1) for _ in range(3))[1]
        logits, state = e.prefill(pixels, ids, mask)
        n = 32
        bucket = e.kv_bucket_for(ids.shape[1] + n)
        e.decode_chunk(logits, state, 4, kv_bucket=bucket)  # warm-up
        logits, state = e.prefill(pixels, ids, mask)
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        e.decode_chunk(logits, state, n, kv_bucket=bucket)
        end.record()
        sync()
        step_ms = start.elapsed_time(end) / n
        perf[name] = (ttft, 1000.0 / step_ms)
        print(f"main: {name:7s} TTFT {ttft:.2f} ms  b1 int8 greedy decode "
              f"{1000.0 / step_ms:.1f} tok/s ({step_ms:.3f} ms/step)  [{card}]", flush=True)
    profile_phase(eng, pixels, ids, mask, card)
    return counts


def profile_phase(eng, pixels, ids, mask, card, n_steps=16, top=8):
    """Where the kernel path's time goes: torch.profiler over one prefill
    and over ``n_steps`` greedy decode steps at the 512-slot window and at
    the full cache, printing device-busy time against wall time and the
    kernels with the most device time, per prefill or per decode step."""
    from torch.profiler import ProfilerActivity, profile

    def run(label, setup, fn, per):
        fn(setup())  # warm-up at this shape
        arg = setup()
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(arg)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [k for k in prof.key_averages() if k.self_device_time_total > 0]
        busy = sum(k.self_device_time_total for k in rows) / 1e3
        if not rows:
            print(f"profile: {label}: device time not measured (the profiler saw no "
                  f"device activity); wall {wall / per:.3f} ms", flush=True)
            return
        print(f"profile: {label}: per {'step' if per > 1 else 'prefill'} wall "
              f"{wall / per:.3f} ms, device busy {busy / per:.3f} ms "
              f"({100 * busy / wall:.1f} %)  [{card}]", flush=True)
        for k in sorted(rows, key=lambda k: -k.self_device_time_total)[:top]:
            print(f"profile:   {k.key[:48]:48s} {k.count / per:6.1f} calls "
                  f"{k.self_device_time_total / per:9.1f} us  "
                  f"({k.self_device_time_total / k.count:.2f} us each)", flush=True)

    run("prefill B1 266 tokens", lambda: None, lambda _: eng.prefill(pixels, ids, mask), 1)
    for bucket in (512, None):
        run(f"greedy decode B1 W{bucket or MAX_SEQ}, {n_steps} steps",
            lambda: eng.prefill(pixels, ids, mask),
            lambda ls, bucket=bucket: eng.decode_chunk(ls[0], ls[1], n_steps, kv_bucket=bucket),
            n_steps)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _compare(lk, lp, label, emitted):
    """Relative logit error; and the plain path's greedy token must be the
    emitted one wherever its top-2 gap exceeds the tolerance."""
    if not torch.isfinite(lk).all():
        raise AssertionError(f"{label}: non-finite kernel-path logits")
    scale = float(lp.abs().max())
    rel = float((lk - lp).abs().max()) / scale
    if rel > LOGIT_REL_TOL:
        raise AssertionError(f"{label}: kernel vs plain logits rel err {rel} > {LOGIT_REL_TOL}")
    top2 = lp[0].topk(2).values
    if float(top2[0] - top2[1]) > LOGIT_REL_TOL * scale:
        if int(lp[0].argmax()) != int(emitted):
            raise AssertionError(f"{label}: plain greedy {int(lp[0].argmax())} != emitted {emitted}")
        return rel, 0
    return rel, 1


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.parent.name} built/loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    report = KernelReport()
    t0 = time.perf_counter()
    kernel_phase(report, dev)
    sync()
    print(f"kernels: all cases within tolerance ({time.perf_counter() - t0:.1f} s)", flush=True)

    counts = main_path(dev, card)

    src = {
        "flash_attention_fwd": ("cuda", "paligemma_tpu_torch/csrc/flash_attention.cu",
                                "paligemma_tpu/kernels/flash_attention.py:43"),
        "int8_gemv": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv.cu",
                      "paligemma_tpu/kernels/decode_layer.py:95"),
        "decode_attention": ("cuda", "paligemma_tpu_torch/csrc/decode_attention.cu",
                             "paligemma_tpu/kernels/decode_layer.py:95"),
        "rms_norm": ("triton", "paligemma_tpu_torch/kernels/decode_elementwise.py",
                     "paligemma_tpu/kernels/decode_layer.py:95"),
        "rope_kv_write": ("triton", "paligemma_tpu_torch/kernels/decode_elementwise.py",
                          "paligemma_tpu/kernels/decode_layer.py:95"),
        "head_argmax": ("cuda", "paligemma_tpu_torch/csrc/decode_head.cu",
                        "paligemma_tpu/kernels/decode_head.py:35"),
    }
    rows = []
    for name in kernels.WRAPPERS:
        route, source, replaces = src[name]
        r = report.rows[name]
        rows.append({"name": name, "route": route, "source": source, "replaces": replaces,
                     "launches": counts[name], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
