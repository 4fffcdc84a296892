"""The fp32 tiles of two kernels of paligemma_tpu_torch, emulated on the CPU
(the kernels themselves run on the card: tests/test_torch_cuda.py):

- the int8 GEMV tile's fp32 form (``csrc/gemv_tile.cuh``
  ``gemv_tile_sums_f32``): each fp32 element of x split into three bf16
  terms, each step's products of hi, then mid, then lo added into the
  warp's fp32 sums (column g of the ``mma.sync`` B operand is row g of the
  batch tile), then the plan's warps and ranks in order;
- the split decode attention's fp32 pass (``csrc/attention_split.cuh``
  ``attn_split_f32``): each 32-key tile's columns split over a cluster of
  two CTAs, partial scores in four interleaved chains added in rank order,
  the combine in ``SplitPlan.merge_slot``'s order.

Each emulation is held to the plain version within FP32_REL, the card's
tolerance for the fp32 forms.
"""

import numpy as np
import pytest
import torch

from paligemma_tpu_torch.kernels import decode_attention as t_dattn
from paligemma_tpu_torch.kernels import gemv_plan as t_plan
from paligemma_tpu_torch.kernels import int8_gemv as t_gemv

torch.set_num_threads(2)

FP32_REL = 2e-5  # tests/test_torch_cuda.py, chip_smoke.py
F32 = np.float32


def _split3(x):
    """hi, mid, lo: the bf16 terms of fp32 x (gt_split3), as fp32."""
    t = torch.from_numpy(x)
    hi = t.to(torch.bfloat16).float()
    mid = (t - hi).to(torch.bfloat16).float()
    lo = (t - hi - mid).to(torch.bfloat16).float()
    return np.stack([hi.numpy(), mid.numpy(), lo.numpy()])  # (3, B, K)


def _emulate_gemv(x, w, s, plan):
    """The fp32 tile's sums of x (B, K) fp32 against int8 w (K, 128) on one
    column tile, batch tiles of 8 rows: each step's products of a term
    (hi, then mid, then lo) summed exactly and added to the warp's fp32 sum
    (the emulation's stand-in for the tensor core's accumulation); warps in
    order, then ranks; times s."""
    b, k = x.shape
    terms = _split3(x)
    out = np.zeros((b, w.shape[1]), F32)
    for b0 in range(0, b, t_plan.BATCH_TILE):
        nb = min(t_plan.BATCH_TILE, b - b0)
        bop = terms[:, b0:b0 + nb]  # (3, nb, K): the B operand's columns, a term at a time
        ranks = np.zeros((nb, w.shape[1]), F32)
        for kbeg in range(0, k, plan.k_per_cta):
            kend = min(k, kbeg + plan.k_per_cta)
            steps = -(-(kend - kbeg) // t_plan.STEP_K)
            warps = np.zeros((nb, w.shape[1]), F32)
            for wi in range(plan.warps):
                acc = np.zeros((nb, w.shape[1]), F32)
                for st in range(wi, steps, plan.warps):
                    lo_k, hi_k = kbeg + 16 * st, min(kend, kbeg + 16 * st + 16)
                    d = np.einsum("tck,kn->tcn", bop[:, :, lo_k:hi_k].astype(np.float64),
                                  w[lo_k:hi_k].astype(np.float64)).astype(F32)
                    for t in range(3):
                        acc = acc + d[t]
                warps = warps + acc
            ranks = ranks + warps
        out[b0:b0 + nb] = ranks * s
    return out


@pytest.mark.parametrize("k,n", [(2048, 2560), (2048, 2048), (2048, 32768), (16384, 2048)],
                         ids=["qkv", "o", "gateup", "down"])
def test_fp32_gemv_sum_order_holds_fp32_and_a_rows_bits(k, n):
    """The fp32 tile's sum order, emulated on one column tile at Gemma-2B's
    four (K, N) and their plans, within FP32_REL of the plain fp32 GEMV
    (int8_gemv_reference); a row's emulated bits are the same alone as
    inside 8 and 9 rows (9: a last batch tile of one row)."""
    rng = np.random.default_rng(k + n)
    plan = t_plan.GemvPlan.make(k, n)
    w = rng.integers(-127, 128, (k, 128), dtype=np.int8)
    s = ((rng.random(128, dtype=F32) + 0.5) / (127 * k**0.5)).astype(F32)
    x = (rng.standard_normal((9, k), dtype=F32) * 2.0).astype(F32)
    got = {b: _emulate_gemv(x[:b], w, s, plan) for b in (1, 8, 9)}
    want = t_gemv.int8_gemv_reference(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(s)).numpy()
    err = np.abs(got[9] - want).max() / max(1.0, np.abs(want).max())
    assert err <= FP32_REL / 4, err
    for b in (8, 9):
        np.testing.assert_array_equal(got[b][:1], got[1])
    np.testing.assert_array_equal(_emulate_gemv(x[8:9], w, s, plan), got[9][8:])


def test_fp32_split_columns_cover_d_once():
    """The fp32 pass's cluster ranks take consecutive halves of D, fixed by
    D alone (a 16-byte chunk of 4 columns never straddles them)."""
    for d in (8, 64, 72, 128, 256):
        plan = t_dattn.SplitPlan(rows=3, groups=8, head_dim=d, window=100)
        shares = [plan.f32_columns(r) for r in range(t_dattn.F32_CLUSTER)]
        assert shares[0][0] == 0 and shares[-1][1] == d
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        assert all((hi - lo) % 4 == 0 and hi > lo for lo, hi in shares)


def _emulate_split(q, k, v, valid, scale):
    """The fp32 split pass and combine on one row (q (G, D), k / v (W, D),
    valid (W,)), in fp32 step by step."""
    g, d = q.shape
    plan = t_dattn.SplitPlan(rows=1, groups=g, head_dim=d, window=valid.shape[0])
    parts = []
    for sp in range(plan.nsplit):
        k0, k1 = plan.tile(sp)
        n = min(k1, valid.shape[0]) - k0  # the tile's keys inside the window
        on = np.zeros(32, bool)  # visible keys; zeros stand in for the others
        on[:n] = valid[k0:k0 + n]
        kt, vt = np.zeros((32, d), F32), np.zeros((32, d), F32)
        kt[on], vt[on] = k[k0:k0 + n][on[:n]], v[k0:k0 + n][on[:n]]
        if not on.any():
            parts.append((np.full(g, -1e30, F32), np.zeros(g, F32), np.zeros((g, d), F32)))
            continue
        halves = []
        for r in range(t_dattn.F32_CLUSTER):
            lo, hi = plan.f32_columns(r)
            chains = np.zeros((4, g, 32), F32)
            for c in range(lo, hi, 4):
                for i in range(4):
                    chains[i] = chains[i] + q[:, c + i, None] * kt[None, :, c + i]
            halves.append((chains[0] + chains[1]) + (chains[2] + chains[3]))
        sc = (halves[0] + halves[1]) * F32(scale)
        m = np.where(on[None], sc, F32(-1e30)).max(-1)
        p = np.where(on[None], np.exp(sc - m[:, None]), F32(0)).astype(F32)
        o = np.zeros((g, d), F32)
        for j in range(32):
            o = o + p[:, j, None] * vt[None, j]
        parts.append((m.astype(F32), p.sum(-1, dtype=F32), o))
    mx = np.max([pm for pm, _, _ in parts], axis=0)
    lanes = [[np.zeros(g, F32), np.zeros((g, d), F32)] for _ in range(t_dattn.MERGE_LANES)]
    for sp in sorted(range(plan.nsplit), key=plan.merge_slot):
        lane, _ = plan.merge_slot(sp)
        pm, pl, po = parts[sp]
        wgt = np.exp(pm - mx).astype(F32)
        lanes[lane][0] = lanes[lane][0] + wgt * pl
        lanes[lane][1] = lanes[lane][1] + wgt[:, None] * po
    den, num = np.zeros(g, F32), np.zeros((g, d), F32)
    for lane_den, lane_num in lanes:
        den, num = den + lane_den, num + lane_num
    return num * np.where(den > 0, 1 / np.where(den > 0, den, 1), 0).astype(F32)[:, None]


@pytest.mark.parametrize("w,d", [(80, 64), (200, 256), (2048, 256)])
def test_fp32_split_and_combine_hold_fp32(w, d):
    """The fp32 split pass's order (column halves in rank order, four chains
    a half) and the combine's, emulated, within FP32_REL of
    decode_attention_reference; a hole in the window and a partial last
    tile included."""
    rng = np.random.default_rng(w + d)
    g = 8
    q = rng.standard_normal((1, g, d), dtype=F32)
    k, v = (rng.standard_normal((1, w, d), dtype=F32) for _ in range(2))
    valid = np.ones((1, w), bool)
    valid[0, 5:40] = False
    got = _emulate_split(q[0], k[0], v[0], valid[0], d**-0.5)
    want = t_dattn.decode_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                              torch.from_numpy(v), torch.from_numpy(valid),
                                              d**-0.5).numpy().reshape(g, d)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= FP32_REL / 4, err
