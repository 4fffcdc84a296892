"""The hand-written Hopper kernels against their plain PyTorch versions, on
a CUDA card (marked ``cuda``; skipped without one). Imports no jax, so it
runs where the card is:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from paligemma_tpu_torch.kernels import decode_attention as t_dattn
from paligemma_tpu_torch.kernels import decode_elementwise as t_elem
from paligemma_tpu_torch.kernels import decode_head as t_head
from paligemma_tpu_torch.kernels import flash_attention as t_flash
from paligemma_tpu_torch.kernels import int8_gemv as t_gemv
from paligemma_tpu_torch.kernels import paged_attention as t_paged

torch.set_num_threads(2)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Every hand-written kernel against its plain version at small shapes,
    in bf16 on the card (tolerances: bf16 output rounding, fp32 sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nvcc and triton on its host)")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(2, 40, 4, 72), rnd(2, 40, 2, 72), rnd(2, 40, 2, 72)
    pfx = torch.tensor([20, 38], dtype=torch.int32, device=dev)
    kvl = torch.tensor([30, 40], dtype=torch.int32, device=dev)
    got = t_flash.flash_attention(q, k, v, pfx, kvl)
    want = t_flash.reference_attention(q, k, v, pfx, kvl)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)

    x = rnd(3, 256)
    w8 = torch.randint(-127, 128, (256, 384), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand(384, generator=g, device=dev) * 1e-2
    res = rnd(3, 384)
    for kw in ({}, {"residual": res}, {"geglu": True}):
        torch.testing.assert_close(t_gemv.int8_gemv(x, w8, s, **kw).float(),
                                   t_gemv.int8_gemv_reference(x, w8, s, **kw).float(),
                                   rtol=2e-2, atol=2e-2)

    qd, kc, vc = rnd(2, 4, 128), rnd(2, 600, 128), rnd(2, 600, 128)
    valid = torch.rand(2, 512, generator=g, device=dev) < 0.5
    torch.testing.assert_close(t_dattn.decode_attention(qd, kc, vc, valid, 128**-0.5).float(),
                               t_dattn.decode_attention_reference(qd, kc, vc, valid, 128**-0.5).float(),
                               rtol=2e-2, atol=2e-2)

    # the qkv GEMV with the norm prologue and the RoPE + KV write epilogue
    # against the plain chain it replaced (norm -> GEMV -> RoPE + write)
    w8q = torch.randint(-127, 128, (256, 6 * 128), generator=g, device=dev, dtype=torch.int8)
    sq = torch.rand(6 * 128, generator=g, device=dev) * 1e-2
    norm = (rnd(256) * 0.1, 1e-6)
    ang = torch.rand(2, 128, generator=g, device=dev) * 6.28
    cos, sin = ang.cos().to(torch.bfloat16), ang.sin().to(torch.bfloat16)
    pos = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    bufs = [torch.zeros(2, 16, 128, dtype=torch.bfloat16, device=dev) for _ in range(4)]
    outs = [torch.empty(2, 128, dtype=torch.bfloat16, device=dev) for _ in range(4)]
    xq = x[:2].contiguous()
    qk, _, _ = t_gemv.int8_gemv_rope_kv(xq, w8q, sq, cos, sin, pos, 4, bufs[0], bufs[1], outs[0],
                                        outs[1], norm=norm)
    qp, _, _ = t_gemv.int8_gemv_rope_kv_reference(xq, w8q, sq, cos, sin, pos, 4, bufs[2], bufs[3],
                                                  outs[2], outs[3], norm=norm)
    torch.testing.assert_close(qk.float(), qp.float(), rtol=2e-2, atol=2e-2)
    for got, want in zip(bufs[:2] + outs[:2], bufs[2:] + outs[2:]):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)

    wn = rnd(256)
    torch.testing.assert_close(t_elem.rms_norm(x, wn).float(),
                               t_elem.rms_norm_reference(x, wn).float(), rtol=2e-2, atol=2e-2)

    for n in (384, 300):  # 300: vocab padded to 384, padding never wins
        w8n, sn = w8[:, :n].contiguous(), s[:n].contiguous()
        ids, mx = t_head.head_argmax_fused(x, t_head.repack_head({"w8": w8n, "s": sn}),
                                           return_max=True)
        logits = t_gemv.int8_gemv(x, w8n, sn).float()
        assert torch.equal(ids.long(), logits.argmax(-1))
        assert torch.equal(mx, logits.max(-1).values)


@pytest.mark.cuda
def test_paged_kernels_match_plain_versions_on_card():
    """The paged attention kernel (GQA groupings, a fragmented table, an
    empty row, the layer-stacked pool) and the paged RoPE/KV write against
    their plain versions; and the paged kernel equals decode_attention bit
    for bit where a table maps the same keys as a dense cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nvcc and triton on its host)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    ps, d, n_pages = 16, 128, 12
    table = torch.tensor([[3, 7, 1, 0], [5, 0, 0, 0], [2, 9, 11, 4]], dtype=torch.int32,
                         device=dev)
    kv_len = torch.tensor([37, 0, 64], dtype=torch.int32, device=dev)
    for hq, hkv in ((8, 1), (8, 2), (4, 4)):
        q = rnd(3, hq, d)
        kp, vp = rnd(2, n_pages, ps, hkv, d), rnd(2, n_pages, ps, hkv, d)
        got = t_paged.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=1)
        want = t_paged.reference_paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=1)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
        assert torch.count_nonzero(got[1]) == 0  # kv_len 0 -> exact zeros

    # shared keys: row b's pages are consecutive slices of its dense cache row
    b, s_len, w = 2, 128, 96
    q = rnd(b, 8, d)
    kc, vc = rnd(b, s_len, d), rnd(b, s_len, d)
    lens = torch.tensor([70, 96], dtype=torch.int32, device=dev)
    valid = torch.arange(w, device=dev)[None] < lens[:, None].long()
    pool_k = kc.reshape(b * s_len // ps, ps, 1, d)
    pool_v = vc.reshape(b * s_len // ps, ps, 1, d)
    tab = (torch.arange(w // ps, device=dev)[None] + (s_len // ps) * torch.arange(b, device=dev)[:, None]).to(torch.int32)
    dense = t_dattn.decode_attention(q, kc, vc, valid.contiguous(), d**-0.5)
    paged = t_paged.paged_decode_attention(q, pool_k, pool_v, tab, lens)
    assert torch.equal(dense.reshape(b, 8, d), paged)

    # the qkv GEMV's RoPE epilogue writing into page slots, against the
    # plain chain (norm -> GEMV -> paged RoPE + write)
    xq = rnd(2, 256)
    w8q = torch.randint(-127, 128, (256, 6 * 128), generator=g, device=dev, dtype=torch.int8)
    sq = torch.rand(6 * 128, generator=g, device=dev) * 1e-2
    norm = (rnd(256) * 0.1, 1e-6)
    ang = torch.rand(2, 128, generator=g, device=dev) * 6.28
    cos, sin = ang.cos().to(torch.bfloat16), ang.sin().to(torch.bfloat16)
    pos = torch.tensor([5, 40], dtype=torch.int32, device=dev)
    ptab = torch.tensor([[2, 0, 0], [4, 1, 3]], dtype=torch.int32, device=dev)
    pools = [torch.zeros(5, 16, 128, dtype=torch.bfloat16, device=dev) for _ in range(4)]
    outs = [torch.empty(2, 128, dtype=torch.bfloat16, device=dev) for _ in range(4)]
    qk, _, _ = t_gemv.int8_gemv_rope_kv(xq, w8q, sq, cos, sin, pos, 4, pools[0], pools[1],
                                        outs[0], outs[1], norm=norm, page_table=ptab)
    qp, _, _ = t_gemv.int8_gemv_rope_kv_reference(xq, w8q, sq, cos, sin, pos, 4, pools[2],
                                                  pools[3], outs[2], outs[3], norm=norm,
                                                  page_table=ptab)
    torch.testing.assert_close(qk.float(), qp.float(), rtol=2e-2, atol=2e-2)
    for got, want in zip(pools[:2] + outs[:2], pools[2:] + outs[2:]):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert torch.count_nonzero(pools[0][3, 8]) > 0  # row 1: page 3, slot 40 % 16


@pytest.mark.cuda
def test_flash_backward_kernels_match_plain_version_on_card():
    """The flash forward's lse and the B6 backward kernels (dq, dk/dv with
    the split row sweep) against the plain FA2 backward on the same inputs:
    the training shape (prefix 268 = 256 image + 12 prompt tokens, kv_len
    512 / 400), GQA at S 199 (64-row tiles straddle two query heads),
    prefix-LM MQA with a padded row, GQA at head_dim 72 with a kv_len 0 row
    (exact zeros); a second call gives the same bits (dk/dv partials added
    in a fixed order); and flash_attention's autograd path launches each
    kernel once per backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nvcc and triton on its host)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for b, s, hq, hkv, d, pfx, kvl in ((2, 512, 8, 1, 256, [268, 268], [512, 400]),
                                       (2, 199, 4, 2, 256, [60, 100], [199, 150]),
                                       (2, 70, 8, 1, 256, [30, 41], [70, 52]),
                                       (2, 40, 4, 2, 72, [17, 0], [40, 0])):
        q, k, v, dout = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
        pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
        kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
        out, lse = t_flash.flash_attention_with_lse(q, k, v, pl, kl)
        want_out, want_lse = t_flash._reference_forward(q, k, v, pl, kl, d**-0.5, 0)
        torch.testing.assert_close(out.float(), want_out.float(), rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
        delta = t_flash._delta(out, dout)
        dq = t_flash.flash_attention_bwd_dq(q, k, v, dout, lse, delta, pl, kl, d**-0.5)
        dk, dv = t_flash.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, pl, kl, d**-0.5)
        want = t_flash._reference_backward(q, k, v, dout, lse, delta, pl, kl, d**-0.5, 0)
        for got, ref in zip((dq, dk, dv), want):
            scale = float(ref.float().abs().max())
            assert float((got.float() - ref.float()).abs().max()) <= 2e-2 * max(1.0, scale)
        again = (t_flash.flash_attention_bwd_dq(q, k, v, dout, lse, delta, pl, kl, d**-0.5),
                 *t_flash.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, pl, kl, d**-0.5))
        assert all(torch.equal(x, y) for x, y in zip(again, (dq, dk, dv)))
        if kvl[1] == 0:
            assert not dq[1].any() and not dk[1].any() and not dv[1].any()
            assert not out[1].any() and not lse[1].any()

    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    n_fwd, n_dq, n_dkv = (t_flash.flash_attention.launches, t_flash.flash_attention_bwd_dq.launches,
                          t_flash.flash_attention_bwd_dkv.launches)
    t_flash.flash_attention(q, k, v, pl, kl).float().square().sum().backward()
    assert (t_flash.flash_attention.launches - n_fwd, t_flash.flash_attention_bwd_dq.launches - n_dq,
            t_flash.flash_attention_bwd_dkv.launches - n_dkv) == (1, 1, 1)
    assert q.grad.shape == q.shape and torch.isfinite(q.grad.float()).all()


# B1 cases of chip_smoke.py's kernel phase: (b, sq, skv, hq, hkv, d), prefix_len,
# kv_len, q_offset
FLASH_FWD_CASES = {
    "LM prefill B1 S266 Hq8 Hkv1 D256": ((1, 266, 266, 8, 1, 256), [266], [266], 0),
    "prefix<kv_len B2 S266 Hq8 Hkv1 D256": ((2, 266, 266, 8, 1, 256), [226, 219], [266, 259], 0),
    "train B2 S512 Hq8 Hkv1 D256": ((2, 512, 512, 8, 1, 256), [268, 268], [512, 400], 0),
    "vision B2 S256 H16 D72": ((2, 256, 256, 16, 16, 72), [256, 249], [256, 249], 0),
    "tower B1 S4096 H16 D72": ((1, 4096, 4096, 16, 16, 72), [4096], [4096], 0),
    "GQA B2 S199 Hq4 Hkv2 D64": ((2, 199, 199, 4, 2, 64), [60, 100], [199, 150], 0),
    "q_offset 266 B2 Sq64 Skv330 D256": ((2, 64, 330, 8, 1, 256), [256, 256], [330, 300], 266),
    "kv_len 0 row B2 S128 Hq8 Hkv1 D256": ((2, 128, 128, 8, 1, 256), [40, 0], [128, 0], 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_FWD_CASES))
def test_flash_forward_kernel_matches_plain_version_on_card(case):
    """B1 (mma.sync tiles) against its plain version: out within 1e-2 and
    lse within 1e-4 of max(1, |plain|); a kv_len 0 row gives exact zeros; a
    second call gives the same bits; one launch per call."""
    dev = _card()
    (b, sq, skv, hq, hkv, d), pfx, kvl, q_offset = FLASH_FWD_CASES[case]
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
    kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
    n0 = t_flash.flash_attention.launches
    out, lse = t_flash.flash_attention_with_lse(q, k, v, pl, kl, q_offset=q_offset)
    assert t_flash.flash_attention.launches == n0 + 1
    want_out, want_lse = t_flash._reference_forward(q, k, v, pl, kl, d**-0.5, q_offset)
    _close_rel(out, want_out, 1e-2)
    _close_rel(lse, want_lse, 1e-4)
    again = t_flash.flash_attention_with_lse(q, k, v, pl, kl, q_offset=q_offset)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert torch.equal(t_flash.flash_attention(q, k, v, pl, kl, q_offset=q_offset), out)
    if kvl[-1] == 0:
        assert not out[-1].any() and not lse[-1].any()


@pytest.mark.cuda
def test_tp_kernels_match_plain_versions_on_card():
    """The tensor-parallel kernels on one rank's shard against their plain
    versions: the fp32-partial GEMV epilogue, the decode MLP (B7b) with the
    fp32 and the bf16 output, and the attention half over a dense cache
    (B7) and over a page pool (B8) with 1 and 2 local heads; each wrapper
    counts one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nvcc and triton on its host)")
    from paligemma_tpu_torch.kernels import decode_layer_paged_tp as t_ptp
    from paligemma_tpu_torch.kernels import decode_layer_tp as t_tp
    from paligemma_tpu_torch.kernels import decode_mlp as t_mlp

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def int8(*shape):
        w8 = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        s = torch.rand(shape[:-2] + shape[-1:], generator=g, device=dev)
        return {"w8": w8, "s": (s + 0.5) / (127 * shape[-2] ** 0.5)}

    def close(got, want, rel):
        scale = max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= rel * scale

    b, k, d, n_layers = 2, 256, 128, 2
    x = rnd(b, k)
    w = int8(k, 384)
    n0 = t_gemv.int8_gemv_f32.launches
    part = t_gemv.int8_gemv_f32(x, w["w8"], w["s"])
    assert part.dtype == torch.float32 and t_gemv.int8_gemv_f32.launches == n0 + 1
    close(part, t_gemv.int8_gemv_reference(x, w["w8"], w["s"], out_fp32=True), 1e-4)

    mlp = {"gateup": int8(n_layers, k, 2 * 512), "down": int8(n_layers, 512, k)}
    for out_dtype, rel in ((torch.float32, 1e-3), (None, 2e-2)):
        n0 = t_mlp.mlp_decode_fused.launches
        got = t_mlp.mlp_decode_fused(x[:, None], mlp, 1, out_dtype=out_dtype)
        assert t_mlp.mlp_decode_fused.launches == n0 + 1
        assert got.dtype == (out_dtype or torch.bfloat16) and got.shape == (b, 1, k)
        close(got, t_mlp.reference_mlp(x[:, None], mlp, 1, out_dtype=out_dtype), rel)

    ang = torch.rand(b, d, generator=g, device=dev) * 6.28
    cos, sin = ang.cos().to(torch.bfloat16), ang.sin().to(torch.bfloat16)
    pos = torch.tensor([5, 40], dtype=torch.int32, device=dev)
    ps, seq = 16, 64
    table = torch.tensor([[2, 0, 0, 0], [4, 1, 3, 6]], dtype=torch.int32, device=dev)
    for hl in (1, 2):
        layers = {"input_norm": rnd(n_layers, k),
                  "attn": {"qkv": int8(n_layers, k, (hl + 2) * d), "o": int8(n_layers, hl * d, k)}}
        kc, vc = rnd(n_layers, b, seq, d), rnd(n_layers, b, seq, d)
        valid = (torch.arange(seq, device=dev)[None] <= pos[:, None]).contiguous()
        caches = [(kc.clone(), vc.clone()) for _ in range(2)]
        n0 = t_tp.attn_decode_tp.launches
        got = t_tp.attn_decode_tp(x, layers, *caches[0], 1, valid=valid, cache_pos=pos, cos=cos,
                                  sin=sin, head_dim=d, eps=1e-6)
        want = t_tp.attn_decode_tp_reference(x, layers, *caches[1], 1, valid, pos, cos, sin, d,
                                             1e-6)
        assert t_tp.attn_decode_tp.launches == n0 + 1 and got[0].dtype == torch.float32
        close(got[0], want[0], 2e-2)
        for a, r in zip(got[1:] + caches[0], want[1:] + caches[1]):
            close(a, r, 2e-2)

        kp, vp = rnd(n_layers, 8, ps, d), rnd(n_layers, 8, ps, d)
        pools = [(kp.clone(), vp.clone()) for _ in range(2)]
        n0 = t_ptp.attn_decode_paged_tp.launches
        got = t_ptp.attn_decode_paged_tp(x, layers, *pools[0], 1, page_table=table,
                                         write_pos=pos, cos=cos, sin=sin, pages_bucket=4,
                                         head_dim=d, eps=1e-6)
        want = t_ptp.attn_decode_paged_tp_reference(x, layers, *pools[1], 1, table, pos, cos,
                                                    sin, 4, d, 1e-6)
        assert t_ptp.attn_decode_paged_tp.launches == n0 + 1
        close(got[0], want[0], 2e-2)
        for a, r in zip(got[1:] + pools[0], want[1:] + pools[1]):
            close(a, r, 2e-2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nvcc and triton on its host)")
    return torch.device("cuda")


def _close_rel(got, want, rel=2e-2):
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= rel * scale


@pytest.mark.cuda
def test_vision_attention_kernel_on_card():
    """B12 against its plain version (one launch per call) at B2 S128 H3
    (64-row blocks, two batches in one tensor map); fp32 q beside bf16 k and
    v on the card raises instead of casting or running the plain version
    (all-fp32 inputs take the fp32 form: test_vision_attention_fp32_form_on_card)."""
    from paligemma_tpu_torch.kernels.ablation import vision_attention as t_va

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(2, 128, 3, 72, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    n0 = t_va.vision_attention.launches
    got = t_va.vision_attention(q, k, v)
    assert t_va.vision_attention.launches == n0 + 1
    _close_rel(got, t_va.vision_attention_reference(q, k, v, 72**-0.5), rel=1e-2)
    with pytest.raises(ValueError):
        t_va.vision_attention(q.float(), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 4096, 1024])
def test_vision_attention_streams_long_sequences_on_card(s):
    """B12 at the 224, 896 and 448 px towers' S (H16, D72): the streamed
    softmax holds no row of scores, so S = 4096 runs; 64-row blocks at S256,
    128-row blocks at S1024 and S4096."""
    from paligemma_tpu_torch.kernels.ablation import vision_attention as t_va

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(1, s, 16, 72, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    _close_rel(t_va.vision_attention(q, k, v), t_va.vision_attention_reference(q, k, v, 72**-0.5),
               rel=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(1, 256, 16, 64), (1, 4096, 16, 64), (1, 256, 4, 128),
                                     (2, 2048, 8, 128), (1, 512, 2, 8), (1, 384, 3, 96)])
def test_vision_attention_depths_and_bits_on_card(b, s, h, d):
    """B12 at each depth instantiation (64, 80 via the tests above, 128),
    head dims below an atom (8) and between instantiations (96), with
    64- and 128-row blocks; a second call gives the same bits."""
    from paligemma_tpu_torch.kernels.ablation import vision_attention as t_va

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    got = t_va.vision_attention(q, k, v)
    _close_rel(got, t_va.vision_attention_reference(q, k, v, d**-0.5), rel=1e-2)
    assert torch.equal(t_va.vision_attention(q, k, v), got)


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
def test_lora_shrink_and_gemv_lora_epilogue_on_card(a_dtype):
    """lora_shrink and the three LoRA epilogue modes of int8_gemv against
    their plain versions (rows on the base model, adapter 1 and 2 of a
    rank-4 bank, G 16); base rows only: the epilogue's bits without LoRA."""
    from paligemma_tpu_torch.kernels import lora as t_lora

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(6)
    b, k, n, gcols, rank = 5, 320, 256, 16, 4
    x = torch.randn(b, k, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.tensor([0, 1, 2, 1, 0], dtype=torch.int32, device=dev)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand(n, generator=g, device=dev) * 1e-2
    res = torch.randn(b, n, generator=g, device=dev).to(torch.bfloat16)
    for bounds, kw in (((96, 160), {}), ((), {"residual": res}), ((n // 2,), {"geglu": True})):
        ntarget = len(bounds) + 1
        a = torch.randn(k, ntarget * gcols, generator=g, device=dev).to(a_dtype) * 0.1
        for t in range(ntarget):
            a[:, t * gcols:t * gcols + rank] = 0  # bank row 0: the zero adapter
        lb = torch.randn(gcols, n, generator=g, device=dev).to(a_dtype)
        z = t_lora.lora_shrink(x, a, ids, rank, gcols)
        zp = t_lora.lora_shrink_reference(x, a, ids, rank, gcols)
        _close_rel(z, zp)
        got = t_gemv.int8_gemv(x, w8, s, lora=(z, lb, bounds), **kw)
        _close_rel(got, t_gemv.int8_gemv_reference(x, w8, s, lora=(zp, lb, bounds), **kw))
        plain = t_gemv.int8_gemv(x, w8, s, **kw)
        assert torch.equal(got[ids == 0], plain[ids == 0])
        assert not torch.equal(got[ids != 0], plain[ids != 0])
    with pytest.raises(ValueError, match="x's dtype"):  # no mixed form: fp32 z, bf16 x
        t_gemv.int8_gemv(x, w8, s, lora=(z.float(), lb, bounds), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,bounds,kw", [
    (2048, 2560, (2048, 2304), {}), (2048, 4096, (2048,), {"geglu": True}),
    (16384, 2048, (), {"residual": True})])
def test_int8_gemv_lora_expand_at_3b_plans_on_card(a_dtype, k, n, bounds, kw):
    """The expand at Gemma-2B's plans (16-byte copies of B and z) with a bank
    wider than one staged chunk (G 48: 5 adapters of rank 8 and the zero
    one, two chunks of adapter rows), B 8 and 9 (two batch tiles): within
    1e-2 of the plain version, base rows the GEMV's bits without LoRA, a
    second call the same bits."""
    from paligemma_tpu_torch.kernels import lora as t_lora

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(k + n)
    gcols, rank = 48, 8
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    ntarget = len(bounds) + 1
    a = torch.randn(k, ntarget * gcols, generator=g, device=dev) * k**-0.5
    a[:, torch.arange(ntarget * gcols, device=dev) % gcols < rank] = 0  # the zero adapter
    lb = (torch.randn(gcols, n, generator=g, device=dev) * 0.5).to(a_dtype)
    for b in (8, 9):
        x = torch.randn(b, k, generator=g, device=dev).to(torch.bfloat16)
        ids = (torch.arange(b, device=dev) % (gcols // rank)).to(torch.int32)
        res = torch.randn(b, n, generator=g, device=dev).to(torch.bfloat16)
        gkw = {"residual": res} if kw.get("residual") else dict(kw)
        z = t_lora.lora_shrink(x, a.to(a_dtype), ids, rank, gcols)
        got = t_gemv.int8_gemv(x, w8, s, lora=(z, lb, bounds), **gkw)
        _close_rel(got, t_gemv.int8_gemv_reference(x, w8, s, lora=(z, lb, bounds), **gkw),
                   rel=1e-2)
        assert torch.equal(t_gemv.int8_gemv(x, w8, s, lora=(z, lb, bounds), **gkw), got)
        plain = t_gemv.int8_gemv(x, w8, s, **gkw)
        assert torch.equal(got[ids == 0], plain[ids == 0])
        assert not torch.equal(got[ids != 0], plain[ids != 0])


@pytest.mark.cuda
def test_seg_decode_attention_kernel_on_card():
    """B10 against its plain version with a pad hole, a kv_len at a tile
    edge and GQA; NaN in tiles wholly inside the hole or past kv_len is
    never read; an fp32 q beside a bf16 cache on the card raises (fp32 q and
    cache take the fp32 form: test_seg_decode_attention_fp32_form_on_card)."""
    from paligemma_tpu_torch.kernels.ablation import decode_attention as t_sda

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(3, 8, 128, generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(3, 256, 2, 128, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    segs = [torch.tensor(r, dtype=torch.int32, device=dev)
            for r in ([10, 64, 32], [20, 64, 128], [25, 64, 200])]
    n0 = t_sda.decode_attention.launches
    got = t_sda.decode_attention(q, kc, vc, *segs)
    assert t_sda.decode_attention.launches == n0 + 1
    _close_rel(got, t_sda.reference_decode_attention(q, kc, vc, *segs))
    kp, vp = kc.clone(), vc.clone()
    for t in (kp, vp):
        t[1, 64:] = float("nan")
        t[2, 32:128] = float("nan")
    assert torch.equal(t_sda.decode_attention(q, kp, vp, *segs), got)
    with pytest.raises(ValueError):
        t_sda.decode_attention(q.float(), kc, vc, *segs)


@pytest.mark.cuda
def test_seg_decode_attention_hole_inside_a_tile_never_read_on_card():
    """B10 reads only visible keys, also inside a 32-key tile that the hole
    shares with the prompt (as tests/test_torch_ablation.py's poisoned-hole
    test holds the plain version): NaN in the hole changes no bit."""
    from paligemma_tpu_torch.kernels.ablation import decode_attention as t_sda

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(2, 8, 128, generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(2, 128, 2, 128, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    segs = [torch.tensor(r, dtype=torch.int32, device=dev) for r in ([10, 20], [20, 20], [25, 25])]
    got = t_sda.decode_attention(q, kc, vc, *segs)
    _close_rel(got, t_sda.reference_decode_attention(q, kc, vc, *segs), rel=1e-2)
    kp, vp = kc.clone(), vc.clone()
    kp[0, 10:20] = float("nan")
    vp[0, 10:20] = float("nan")
    kp[:, 25:] = float("nan")  # past kv_len, in the same tile
    vp[:, 25:] = float("nan")
    assert torch.equal(t_sda.decode_attention(q, kp, vp, *segs), got)


@pytest.mark.cuda
@pytest.mark.parametrize("grp", [1, 2, 4, 8])
def test_split_attention_policies_agree_bit_for_bit_on_card(grp):
    """3b (dense), B5 (paged) and B10 (seg) on the same keys give the same
    bits: the paged window is 5 pages of 16 (80 keys, not a multiple of
    the 32-key tile), the dense one 256 (padded past it) and 96; G query
    heads per KV head; a row with no visible key gives zeros; a second call
    gives the same bits."""
    from paligemma_tpu_torch.kernels.ablation import decode_attention as t_sda

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(8 + grp)
    b, d, ps, s_len = 3, 128, 16, 256
    q = torch.randn(b, grp, d, generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(b, s_len, d, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.tensor([37, 0, 80], dtype=torch.int32, device=dev)
    valid = (torch.arange(s_len, device=dev)[None] < lens[:, None].long()).contiguous()
    dense = t_dattn.decode_attention(q, kc, vc, valid, d**-0.5)
    _close_rel(dense, t_dattn.decode_attention_reference(q, kc, vc, valid, d**-0.5), rel=1e-2)
    assert torch.count_nonzero(dense[1]) == 0
    assert torch.equal(t_dattn.decode_attention(q, kc, vc, valid, d**-0.5), dense)
    assert torch.equal(t_dattn.decode_attention(q, kc, vc, valid[:, :96].contiguous(), d**-0.5),
                       dense)
    pool_k = kc.reshape(b * s_len // ps, ps, 1, d)
    pool_v = vc.reshape(b * s_len // ps, ps, 1, d)
    tab = (torch.arange(5, device=dev)[None]
           + (s_len // ps) * torch.arange(b, device=dev)[:, None]).to(torch.int32)
    paged = t_paged.paged_decode_attention(q, pool_k, pool_v, tab, lens, d**-0.5)
    assert torch.equal(paged, dense.reshape(b, grp, d))
    seg = t_sda.decode_attention(q, kc[:, :, None], vc[:, :, None], lens, lens, lens, d**-0.5)
    assert torch.equal(seg, dense.reshape(b, grp, d))


@pytest.mark.cuda
def test_int4_matmul_kernel_on_card():
    """B9 against its plain version at decode and prefill rows, with a
    column count that is not a multiple of the 64-column tile; an fp32 x on
    the card raises."""
    from paligemma_tpu_torch.kernels.ablation import quant4 as t_q4

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(6)
    q = t_q4.quantize_int4(torch.randn(512, 208, generator=g, device=dev) * 0.05)
    for m in (1, 40):
        x = torch.randn(m, 512, generator=g, device=dev).to(torch.bfloat16)
        n0 = t_q4.int4_matmul.launches
        got = t_q4.int4_matmul(x, q["w4p"], q["s"])
        assert t_q4.int4_matmul.launches == n0 + 1
        _close_rel(got, t_q4.int4_matmul_reference(x, q["w4p"], q["s"]))
    with pytest.raises(ValueError):
        t_q4.int4_matmul(x.float(), q["w4p"], q["s"])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 17, 65, 266, 1024])
@pytest.mark.parametrize("k,n", [(2048, 2560), (16384, 2048), (256, 208)])
def test_int4_matmul_rows_on_card(k, n, m):
    """B9 at decode rows (M <= 16: the GEMV tile's int4 form, one launch)
    and above them (csrc/wq_wgmma.cuh) against its plain version within 1e-2
    of max(1, |plain|), at two Gemma-2B projections and a column count that
    is not a multiple of the 128-column tile; a second call gives the same
    bits."""
    from paligemma_tpu_torch.kernels.ablation import quant4 as t_q4

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(k + n + m)
    w4p = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (7.0 * k**0.5)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    n0 = t_q4.int4_matmul.launches
    got = t_q4.int4_matmul(x, w4p, s)
    assert t_q4.int4_matmul.launches == n0 + 1
    _close_rel(got, t_q4.int4_matmul_reference(x, w4p, s), rel=1e-2)
    assert torch.equal(t_q4.int4_matmul(x, w4p, s), got)


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,ng", [(8, 16384, 32), (9, 2048, 96), (2, 40000, 16), (1, 8, 8)])
def test_lora_shrink_cluster_split_on_card(a_dtype, b, k, ng):
    """The shrink in one launch at Gemma-2B's down (a cluster of 8 ranks of
    2048 rows) and qkv groups, over two batch tiles, with x staged in
    chunks (K 40000) and one row: within 1e-2 of its plain version, base
    rows exactly 0, a second call the same bits."""
    from paligemma_tpu_torch.kernels import lora as t_lora

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(b + k + ng)
    gcols, rank = 8 if ng % 16 else 16, 4
    x = (torch.randn(b, k, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    a = (torch.randn(k, ng, generator=g, device=dev) * k**-0.5).to(a_dtype)
    a[:, torch.arange(ng, device=dev) % gcols < rank] = 0  # bank row 0: the zero adapter
    ids = (torch.arange(1, b + 1, device=dev) % (gcols // rank)).to(torch.int32)
    n0 = t_lora.lora_shrink.launches
    z = t_lora.lora_shrink(x, a, ids, rank, gcols)
    assert t_lora.lora_shrink.launches == n0 + 1
    _close_rel(z, t_lora.lora_shrink_reference(x, a, ids, rank, gcols), rel=1e-2)
    assert not z[ids == 0].any() and z[ids != 0].any()
    assert torch.equal(t_lora.lora_shrink(x, a, ids, rank, gcols), z)


def _tiny_int8_layers(dev, g, n_layers, k, n_heads, d, inter):
    def int8(*shape):
        w8 = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        s = torch.rand(shape[0], shape[-1], generator=g, device=dev) + 0.5
        return {"w8": w8, "s": s / (127 * shape[-2]**0.5)}

    norm = torch.randn(n_layers, k, generator=g, device=dev).to(torch.bfloat16) * 0.1
    return {"input_norm": norm, "post_norm": norm.clone(),
            "attn": {"qkv": int8(n_layers, k, (n_heads + 2) * d),
                     "o": int8(n_layers, n_heads * d, k)},
            "mlp": {"gateup": int8(n_layers, k, 2 * inter), "down": int8(n_layers, inter, k)}}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("k", [1024, 8192])
def test_k1_fp32_partial_with_the_expand_on_card(b, k):
    """K1 (int8_gemv_f32_lora) against its plain version on the same basis,
    one launch counted on its own counter; its [base | delta], added as
    decode_layer_tp.add_partial adds them, has the bits of the residual
    GEMV with the expand (one rank's sum is the one-card epilogue)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(19)
    n, gcols = 2048, 32
    x = (torch.randn(b, k, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    h = torch.randn(b, n, generator=g, device=dev).to(torch.bfloat16)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    lb = torch.randn(gcols, n, generator=g, device=dev) * 0.5
    z = (torch.randn(b, gcols, generator=g, device=dev) * 0.3).to(torch.bfloat16)
    n0, f0 = t_gemv.int8_gemv_f32_lora.launches, t_gemv.int8_gemv_f32.launches
    got = t_gemv.int8_gemv_f32(x, w8, s, lora=(z, lb, ()))
    assert t_gemv.int8_gemv_f32_lora.launches == n0 + 1
    assert t_gemv.int8_gemv_f32.launches == f0
    assert got.shape == (b, 2 * n) and got.dtype == torch.float32
    want = t_gemv.int8_gemv_reference(x, w8, s, out_fp32=True, lora=(z, lb, ()))
    _close_rel(got[:, :n], want[:, :n], 1e-3)
    scale = float(want[:, n:].abs().max())
    assert float((got[:, n:] - want[:, n:]).abs().max()) <= 1e-4 * scale
    assert torch.equal(got, t_gemv.int8_gemv_f32(x, w8, s, lora=(z, lb, ())))
    added = (h + got[:, :n].to(h.dtype)) + got[:, n:].to(h.dtype)
    assert torch.equal(added, t_gemv.int8_gemv(x, w8, s, residual=h, lora=(z, lb, ())))


def _tp_chain_with_a_bank(tmp_path, rows_per_cache, dtype):
    """The TP chain at world size 1 with a bank's pack against the one-card
    chain, activations, cache and cos / sin in ``dtype``: the same bits; 4
    shrinks and 2 K1 a layer, counted on the forms of ``dtype``."""
    import torch.distributed as dist

    from paligemma_tpu_torch.core.mesh import make_mesh
    from paligemma_tpu_torch.kernels import decode_layer as t_dl
    from paligemma_tpu_torch.kernels import decode_layer_tp as t_tp
    from paligemma_tpu_torch.kernels import lora as t_lora

    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(12)
    n_layers, k, h, d, inter, n_cache, s_len = 2, 256, 4, 128, 512, 2, 128
    layers = _tiny_int8_layers(dev, g, n_layers, k, h, d, inter)
    for name in ("input_norm", "post_norm"):
        layers[name] = layers[name].to(dtype)
    gcols, rank = 16, 4
    pack = {"g_true": gcols, "rank": rank}
    for name, in_dim, n_t, out_dim in (("qkv", k, 3, (h + 2) * d), ("o", h * d, 1, k),
                                       ("gu", k, 2, 2 * inter), ("down", inter, 1, k)):
        pack[name + "_a"] = torch.randn(n_layers, in_dim, n_t * gcols, generator=g,
                                        device=dev) * in_dim**-0.5
        pack[name + "_b"] = torch.randn(n_layers, gcols, out_dim, generator=g, device=dev) * 0.5
    b = n_cache * rows_per_cache
    ids = (torch.arange(b, device=dev) % 4).to(torch.int32)
    x = torch.randn(b, 1, k, generator=g, device=dev).to(dtype)
    ang = torch.rand(b, d, generator=g, device=dev) * 6.28
    cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
    start = torch.tensor([40, 70], device=dev)
    pos = (start[:, None] + torch.arange(rows_per_cache, device=dev)[None]).reshape(-1)
    pos = pos.to(torch.int32)
    w = 96
    valid = (torch.arange(w, device=dev)[None] <= pos[:, None].long()).contiguous()
    kc = torch.randn(n_layers, n_cache, s_len, d, generator=g, device=dev).to(dtype)
    vc = torch.randn(n_layers, n_cache, s_len, d, generator=g, device=dev).to(dtype)
    caches = [(kc.clone(), vc.clone()) for _ in range(2)]
    one = t_dl.layers_decode_fused(x, layers, *caches[0], pos, valid, cos, sin, w, h, d, 1e-6,
                                   lora_pack=pack, adapter_ids=ids,
                                   rows_per_cache=rows_per_cache)[0]
    fp32 = dtype == torch.float32
    shrink = t_lora.lora_shrink_fp32 if fp32 else t_lora.lora_shrink
    k1 = t_gemv.int8_gemv_f32_lora_fp32 if fp32 else t_gemv.int8_gemv_f32_lora
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        s0, k0 = shrink.launches, k1.launches
        got = t_tp.layers_decode_tp(x, layers, *caches[1], pos, valid, cos, sin, d, 1e-6,
                                    make_mesh(1, 1), lora_pack=pack, adapter_ids=ids,
                                    rows_per_cache=rows_per_cache)
        assert shrink.launches - s0 == 4 * n_layers
        assert k1.launches - k0 == 2 * n_layers
    finally:
        dist.destroy_process_group()
    assert got.dtype == dtype and torch.equal(got, one)
    assert all(torch.equal(a, c) for a, c in zip(caches[0], caches[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_cache", [1, 3])
def test_tp_chain_with_a_bank_is_the_one_card_chain_on_card(tmp_path, rows_per_cache):
    """The TP chain (kernels/decode_layer_tp) at world size 1 with a bank's
    pack (K1 on o and down) has the one-card chain's bits, also at verify
    rows (``rows_per_cache``); 4 shrinks and 2 K1 a layer."""
    _tp_chain_with_a_bank(tmp_path, rows_per_cache, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_cache", [1, 3])
def test_tp_chain_with_a_bank_at_fp32_is_the_one_card_chain_on_card(tmp_path, rows_per_cache):
    """The same at fp32: the fp32 shrink, K1's fp32 form and the fp32
    partial's sum added as (h + base) + delta give the one-card fp32
    chain's bits."""
    _tp_chain_with_a_bank(tmp_path, rows_per_cache, torch.float32)


@pytest.mark.cuda
def test_dense_equals_paged_with_a_lora_bank_on_card():
    """The dense chain (kernels/decode_layer) and the paged one
    (kernels/decode_layer_paged) with the same bank and a table that maps
    the dense cache's keys give the same bits; base rows of the bank have
    the bits of a chain without it; adapter rows move."""
    from paligemma_tpu_torch.kernels import decode_layer as t_dl
    from paligemma_tpu_torch.kernels import decode_layer_paged as t_dlp

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    n_layers, k, h, d, inter, b, s_len, ps = 2, 256, 4, 128, 512, 4, 128, 16
    layers = _tiny_int8_layers(dev, g, n_layers, k, h, d, inter)
    gcols, rank = 16, 4  # the zero adapter and 3 adapters of rank 4

    def bank(in_dim, n_t, out_dim):
        a = torch.randn(n_layers, in_dim, n_t * gcols, generator=g, device=dev) * in_dim**-0.5
        for t in range(n_t):
            a[:, :, t * gcols:t * gcols + rank] = 0
        return a, torch.randn(n_layers, gcols, out_dim, generator=g, device=dev) * 0.5

    pack = {"g_true": gcols, "rank": rank}
    for name, in_dim, n_t, out_dim in (("qkv", k, 3, (h + 2) * d), ("o", h * d, 1, k),
                                       ("gu", k, 2, 2 * inter), ("down", inter, 1, k)):
        pack[name + "_a"], pack[name + "_b"] = bank(in_dim, n_t, out_dim)
    ids = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=dev)
    x = torch.randn(b, 1, k, generator=g, device=dev).to(torch.bfloat16)
    ang = torch.rand(b, d, generator=g, device=dev) * 6.28
    cos, sin = ang.cos().to(torch.bfloat16), ang.sin().to(torch.bfloat16)
    pos = torch.tensor([69, 95, 5, 40], dtype=torch.int32, device=dev)
    w = 96  # six pages of 16
    kc = torch.randn(n_layers, b, s_len, d, generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn(n_layers, b, s_len, d, generator=g, device=dev).to(torch.bfloat16)
    valid = (torch.arange(w, device=dev)[None] <= pos[:, None].long()).contiguous()
    table = (torch.arange(s_len // ps, device=dev)[None]
             + (s_len // ps) * torch.arange(b, device=dev)[:, None]).to(torch.int32)

    def dense(**kw):
        return t_dl.layers_decode_fused(x, layers, kc.clone(), vc.clone(), pos, valid, cos, sin,
                                        w, h, d, 1e-6, **kw)[0]

    def paged(**kw):
        kp = kc.clone().reshape(n_layers, b * s_len // ps, ps, d)
        vp = vc.clone().reshape(n_layers, b * s_len // ps, ps, d)
        return t_dlp.layers_decode_fused_paged(x, layers, kp, vp, table, pos, cos, sin, h, d,
                                               1e-6, pages_bucket=w // ps, **kw)[0]

    with_bank = dense(lora_pack=pack, adapter_ids=ids)
    assert torch.equal(paged(lora_pack=pack, adapter_ids=ids), with_bank)
    base = dense()
    assert torch.equal(base[0], with_bank[0]) and torch.equal(paged()[0], base[0])
    assert not torch.equal(base[1:], with_bank[1:])


@pytest.mark.parametrize("nmajor", [False, True])
@pytest.mark.cuda
def test_int8_matmul_kernels_on_card(nmajor):
    """B11 (both layouts) against the plain version at decode and prefill
    rows, its autograd dx against the fp32 product; an fp32 x on the card
    raises."""
    from paligemma_tpu_torch.kernels.ablation import quant_pallas as t_qp
    from paligemma_tpu_torch.kernels.quant import quantize_int8

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn(256, 144, generator=g, device=dev) * 0.05
    if nmajor:
        q = t_qp.quantize_int8_nmajor(w)
        w8, fn, ref, diff = (q["w8t"], t_qp.int8_matmul_nmajor, t_qp.int8_matmul_nmajor_reference,
                             t_qp._int8_matmul_nmajor_diffable)
        w8_kn = w8.T
    else:
        q = quantize_int8(w)
        w8, fn, ref, diff = q["w8"], t_qp.int8_matmul, t_qp.int8_matmul_reference, \
            t_qp._int8_matmul_diffable
        w8_kn = w8
    for m in (3, 70):
        x = torch.randn(m, 256, generator=g, device=dev).to(torch.bfloat16)
        n0 = fn.launches
        got = fn(x, w8, q["s"])
        assert fn.launches == n0 + 1
        _close_rel(got, ref(x, w8, q["s"]))
    xg = x.clone().requires_grad_(True)
    gout = torch.randn(70, 144, generator=g, device=dev).to(torch.bfloat16)
    diff(xg, w8, q["s"]).backward(gout)
    _close_rel(xg.grad, (gout.float() * q["s"]) @ w8_kn.float().T)
    with pytest.raises(ValueError):
        fn(x.float(), w8, q["s"])


@pytest.mark.cuda
@pytest.mark.parametrize("nmajor", [False, True])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 65, 266, 1024])
@pytest.mark.parametrize("k,n", [(2048, 2560), (16384, 2048), (256, 208)])
def test_int8_matmul_rows_on_card(k, n, m, nmajor):
    """B11 on every route of its plan (kernels/ablation/_wq_gemm.py): (K, N)
    weights on the GEMV tile at M <= 16, (N, K) weights on the wgmma tile's
    16-row form, both on the wgmma tile above (64-, 128-, 136- and 256-row
    tiles, split-K clusters and persistent CTAs), within 1e-2 of max(1, |plain|) at
    ragged rows, two Gemma-2B projections and a column count that is not a
    multiple of the 128-column tile; one launch a call, and a second call
    gives the same bits."""
    from paligemma_tpu_torch.kernels.ablation import quant_pallas as t_qp

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(k + n + m + nmajor)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127.0 * k**0.5)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    fn, w = (t_qp.int8_matmul_nmajor, w8.t().contiguous()) if nmajor else (t_qp.int8_matmul, w8)
    n0 = fn.launches
    got = fn(x, w, s)
    assert fn.launches == n0 + 1
    _close_rel(got, t_qp.int8_matmul_reference(x, w8, s), rel=1e-2)
    assert torch.equal(fn(x, w, s), got)


# (K, N, epilogue, rows of x): the four projections of PaliGemma-3B-224's
# decoder and its LM head, the tensor-parallel shards at m = 8, and ragged
# shapes (K not a multiple of 16, 4 or even; N not a multiple of 128 or 16)
GEMV_TILE_CASES = [
    (2048, 2560, "plain", (1, 2, 5, 8, 9, 33)), (2048, 2048, "residual", (1, 8, 33)),
    (2048, 32768, "geglu", (1, 8)), (16384, 2048, "residual", (1, 8)),
    (2048, 257152, "plain", (1, 8)),
    (2048, 768, "plain", (1, 8)), (256, 2048, "f32", (1, 8)), (2048, 4096, "geglu", (1, 8)),
    (2048, 2048, "f32", (1, 8)), (2048, 32144, "plain", (8,)),
    (1000, 388, "plain", (1, 5, 9)), (2040, 2560, "residual", (2, 8)), (1001, 300, "plain", (3,)),
    (77, 300, "geglu", (2, 8)), (64, 96, "f32", (33,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,epi,rows", GEMV_TILE_CASES)
def test_int8_gemv_tile_on_card(k, n, epi, rows):
    """The tensor-core GEMV (csrc/gemv_tile.cuh) against its plain version
    within 1e-2 of max(1, |plain|) (bf16 output rounding of fp32 sums taken
    in another order); a second call gives the same bits; the fp32
    partial, cast, has the bits of the bf16 epilogue."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    g = torch.Generator(device=dev).manual_seed(k + n)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    for b in rows:
        x = torch.randn(b, k, generator=g, device=dev).to(torch.bfloat16)
        kw = {"residual": torch.randn(b, n, generator=g, device=dev).to(torch.bfloat16)} \
            if epi == "residual" else {"geglu": epi == "geglu"}
        if epi == "f32":
            got, again = t_gemv.int8_gemv_f32(x, w8, s), t_gemv.int8_gemv_f32(x, w8, s)
            want = t_gemv.int8_gemv_reference(x, w8, s, out_fp32=True)
            assert torch.equal(got.to(torch.bfloat16), t_gemv.int8_gemv(x, w8, s))
        else:
            got, again = t_gemv.int8_gemv(x, w8, s, **kw), t_gemv.int8_gemv(x, w8, s, **kw)
            want = t_gemv.int8_gemv_reference(x, w8, s, **kw)
        _close_rel(got, want, 1e-2)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("vocab", [257152, 32144, 4096, 300])
def test_head_argmax_equals_argmax_of_int8_gemv_on_card(vocab):
    """head_argmax_fused == argmax of the logits path's int8_gemv, id and
    logit bit for bit, at B 1, 8, 33 and 2 and again in a second call, over
    the whole vocab, a vocab shard of m = 8 (padded to the tile) and smaller
    ones; then a three-way tie
    planted in one tile's two cluster ranks and in another tile goes to the
    first index."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(vocab)
    w8 = torch.randint(-127, 128, (2048, vocab), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(vocab, generator=g, device=dev) + 0.5) / (127 * 2048**0.5)
    head = t_head.repack_head({"w8": w8, "s": s})
    for b in (1, 8, 33, 2):  # 33: five batch tiles; then B 2 after B 33
        y = torch.randn(b, 2048, generator=g, device=dev).to(torch.bfloat16)
        ids, mx = t_head.head_argmax_fused(y, head, return_max=True)
        logits = t_gemv.int8_gemv(y, w8, s).float()
        assert torch.equal(ids.long(), logits.argmax(-1))
        assert torch.equal(mx, logits.max(-1).values)
        again = t_head.head_argmax_fused(y, head, return_max=True)  # the keys were reset
        assert torch.equal(again[0], ids) and torch.equal(again[1], mx)
    y = torch.randn(1, 2048, generator=g, device=dev).to(torch.bfloat16)
    j0, dups = 5, (100, vocab - 7)
    w8[:, j0] = torch.where(y[0] > 0, 127, -127).to(torch.int8)
    s[j0] = 1.0
    for j in dups:
        w8[:, j], s[j] = w8[:, j0], s[j0]
    assert int(t_head.head_argmax_fused(y, t_head.repack_head({"w8": w8, "s": s}))[0]) == j0


def _norm_operands(dev, g, b, k):
    x = (torch.randn(b, k, generator=g, device=dev) * 3.0).to(torch.bfloat16)
    return x, ((torch.randn(k, generator=g, device=dev) * 0.1).to(torch.bfloat16), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("label,k,n,kw", [
    ("qkv", 2048, 2560, {}), ("gateup", 2048, 32768, {"geglu": True}),
    ("qkv m8", 2048, 768, {}), ("gateup m8", 2048, 4096, {"geglu": True})])
def test_int8_gemv_norm_prologue_on_card(b, label, k, n, kw):
    """The GEMV with the RMSNorm in its prologue against the plain chain
    (ops/norms.rms_norm, then the GEMV's plain version) at Gemma-2B's qkv
    and gateup and one TP rank's shards: within 1e-2, a second call the
    same bits, one launch a call."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11 + n + b)
    x, norm = _norm_operands(dev, g, b, k)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    n0 = t_gemv.int8_gemv.launches
    got = t_gemv.int8_gemv(x, w8, s, norm=norm, **kw)
    assert t_gemv.int8_gemv.launches == n0 + 1
    _close_rel(got, t_gemv.int8_gemv_reference(x, w8, s, norm=norm, **kw), rel=1e-2)
    assert torch.equal(t_gemv.int8_gemv(x, w8, s, norm=norm, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
def test_norm_prologue_gives_one_y_everywhere_on_card(b):
    """Every kernel that reads a normalized row multiplies the same y: the
    GEMV over (2048, 2048), (2048, 4096) and (2048, 32768) identity-like
    weights (three plans: K ranges of 256, 256 and 1024 rows a CTA) returns
    y itself, bit for bit the same in all three, and the LoRA shrink with
    the same norm (a unit basis) returns the same y; y is within 1e-2 of
    ops/norms.rms_norm."""
    from paligemma_tpu_torch.kernels import lora as t_lora
    from paligemma_tpu_torch.ops.norms import rms_norm

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(21 + b)
    k = 2048
    x, norm = _norm_operands(dev, g, b, k)
    eye = torch.eye(k, device=dev, dtype=torch.int8)
    ys = []
    for reps in (1, 2, 16):
        w8 = eye.repeat(1, reps).contiguous()
        out = t_gemv.int8_gemv(x, w8, torch.ones(k * reps, device=dev), norm=norm)
        ys += list(out.split(k, dim=1))
    y = ys[0]
    _close_rel(y, rms_norm(x, *norm), rel=1e-2)
    assert all(torch.equal(t, y) for t in ys)
    ids = torch.zeros(b, dtype=torch.int32, device=dev)
    for c0 in (0, 1000, k - 8):
        a = torch.zeros(k, 8, device=dev, dtype=torch.bfloat16)
        a[torch.arange(c0, c0 + 8, device=dev), torch.arange(8, device=dev)] = 1.0
        z = t_lora.lora_shrink(x, a, ids, 8, 8, norm=norm)
        assert torch.equal(z, y[:, c0:c0 + 8])


def _rope_operands(dev, g, b, hl, d, n_layers_pos=300):
    ang = torch.rand(b, d, generator=g, device=dev) * 6.28
    pos = torch.tensor([n_layers_pos + 37 * i for i in range(b)], dtype=torch.int32, device=dev)
    return ang.cos().to(torch.bfloat16), ang.sin().to(torch.bfloat16), pos


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("hl,d", [(8, 256), (4, 256), (1, 256), (4, 128), (2, 32)])
@pytest.mark.parametrize("bank", [False, True])
def test_int8_gemv_rope_kv_on_card(b, hl, d, bank):
    """The qkv GEMV with the norm prologue and the RoPE + KV write epilogue
    against the plain chain it replaced (norm -> GEMV -> RoPE + write),
    into a dense cache and into a page pool, with and without a LoRA bank:
    within 1e-2; dense == paged bit for bit; its cast q|k|v have mode 0's
    bits (v_new is the plain-epilogue GEMV's v columns, q and k the plain
    rotation of its q and k columns); base rows of the bank the bits
    without one; a second call the same bits."""
    from paligemma_tpu_torch.kernels import decode_elementwise as t_el
    from paligemma_tpu_torch.kernels import lora as t_lora

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(31 + b + hl + d)
    k, n, s_len, ps = 2048, (hl + 2) * d, 1024, 64
    x, norm = _norm_operands(dev, g, b, k)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    cos, sin, pos = _rope_operands(dev, g, b, hl, d)
    lora, ids = None, torch.arange(b, device=dev).to(torch.int32) % 3
    if bank:
        gcols, rank = 24, 8
        a = torch.randn(k, 3 * gcols, generator=g, device=dev) * k**-0.5
        a[:, torch.arange(3 * gcols, device=dev) % gcols < rank] = 0  # the zero adapter
        lb = torch.randn(gcols, n, generator=g, device=dev) * 0.5
        z = t_lora.lora_shrink(x, a, ids, rank, gcols, norm=norm)
        lora = (z, lb, (hl * d, (hl + 1) * d))
    n_pages = b * s_len // ps + 1
    table = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1).to(torch.int32)
    table = table.reshape(b, s_len // ps)

    def run(fn, paged):
        shape = (n_pages, ps, d) if paged else (b, s_len, d)
        kd, vd = (torch.zeros(shape, dtype=torch.bfloat16, device=dev) for _ in range(2))
        kn, vn = (torch.empty(b, d, dtype=torch.bfloat16, device=dev) for _ in range(2))
        q, _, _ = fn(x, w8, s, cos, sin, pos, hl, kd, vd, kn, vn, norm=norm,
                     page_table=table if paged else None, lora=lora)
        rows = torch.arange(b, device=dev)
        if paged:
            slot = table[rows, pos.long() // ps].long(), pos.long() % ps
            krow, vrow = kd[slot], vd[slot]
        else:
            krow, vrow = kd[rows, pos.long()], vd[rows, pos.long()]
        assert torch.equal(krow, kn) and torch.equal(vrow, vn)
        return q, kn, vn

    n0 = t_gemv.int8_gemv_rope_kv.launches
    dense = run(t_gemv.int8_gemv_rope_kv, False)
    paged = run(t_gemv.int8_gemv_rope_kv, True)
    assert t_gemv.int8_gemv_rope_kv.launches == n0 + 2
    for got, want in zip(dense, run(t_gemv.int8_gemv_rope_kv_reference, False)):
        _close_rel(got, want, rel=1e-2)
    assert all(torch.equal(u, v) for u, v in zip(dense, paged))
    assert all(torch.equal(u, v) for u, v in zip(dense, run(t_gemv.int8_gemv_rope_kv, False)))
    qkv = t_gemv.int8_gemv(x, w8, s, norm=norm, lora=lora)  # mode 0's epilogue
    kc, vc = (torch.zeros(b, s_len, d, dtype=torch.bfloat16, device=dev) for _ in range(2))
    kn, vn = (torch.empty(b, d, dtype=torch.bfloat16, device=dev) for _ in range(2))
    want = t_el.rope_kv_write_reference(qkv, cos, sin, pos, hl, kc, vc, kn, vn)
    assert all(torch.equal(u, v) for u, v in zip(dense, want))
    if bank:
        lora = None
        base = run(t_gemv.int8_gemv_rope_kv, False)
        assert all(torch.equal(u[ids == 0], v[ids == 0]) for u, v in zip(dense, base))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_load_hf_model_to_card_equals_cpu_load(tmp_path, dtype):
    """The loader's upload, cast, transposes and stacking on the card give
    the bits of the same steps on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paligemma_tpu_torch import tiny_test_config
    from paligemma_tpu_torch.checkpoints.hf_export import export_hf_checkpoint
    from paligemma_tpu_torch.checkpoints.hf_loader import load_hf_model
    from paligemma_tpu_torch.convert import init_params

    cfg = tiny_test_config()
    export_hf_checkpoint(cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                          torch.float32), str(tmp_path))
    on_card, cfg_card = load_hf_model(str(tmp_path), dtype)
    on_cpu, cfg_cpu = load_hf_model(str(tmp_path), dtype, device="cpu")
    assert cfg_card == cfg_cpu == cfg
    got, want = dict(_leaves(on_card)), dict(_leaves(on_cpu))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype == dtype, k
        assert torch.equal(got[k].cpu(), v), k


@pytest.mark.cuda
def test_preprocess_device_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from paligemma_tpu_torch.processing.images import preprocess_device

    for hw in ((300, 400), (500, 300), (100, 150)):
        raw = np.random.default_rng(0).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
        got = preprocess_device(raw, 224)  # numpy goes to the card
        assert got.device.type == "cuda" and got.shape == (2, 3, 224, 224)
        want = preprocess_device(raw, 224, device="cpu")
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def _serving_model(dev):
    """A tiny MQA model the decode kernels take (head_dim 128, one KV head),
    bf16 weights and its int8 decode tree on the card."""
    from paligemma_tpu_torch.convert import init_params
    from paligemma_tpu_torch.core.config import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving

    cfg = PaliGemmaConfig(
        vision_config=SiglipVisionConfig(image_size=28, patch_size=14, hidden_size=32,
                                         intermediate_size=64, num_hidden_layers=2,
                                         num_attention_heads=4),
        text_config=GemmaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=1, head_dim=128),
        projection_dim=256, hidden_size=256, image_token_index=510, vocab_size=512)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    return cfg, params, quantize_lm_for_serving(params)


def _serving_requests(cfg, n, grammar=None, same=False):
    import numpy as np

    from paligemma_tpu_torch.runtime.serving import Request

    out = []
    for i in range(n):
        rng = np.random.default_rng(0 if same else i)
        ids = np.concatenate([np.full((cfg.vision_config.num_patches,), cfg.image_token_index),
                              rng.integers(3, 100, (6 + (0 if same else i),))]).astype(np.int32)
        out.append(Request(request_id=i, input_ids=ids, max_new_tokens=12, eos_token_id=1,
                           pixel_values=rng.normal(size=(3, 28, 28)).astype(np.float32),
                           grammar=grammar if i % 2 == 0 else None))
    return out


def _served(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return {r.request_id: list(r.tokens) for r in reqs}


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_grammar_kernel_tick_equals_plain_grammar_tick_on_card(engine):
    """A grammar engine on the kernel path (the decode chain with the int8
    logits head, then the mask and the argmax; no argmax head while a
    constrained row is seated) gives the plain grammar tick's tokens;
    constrained rows stay in the grammar."""
    import numpy as np

    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.processing import grammar as t_grammar
    from paligemma_tpu_torch.runtime.serving import ServingEngine
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    dev = _card()
    cfg, params, dq = _serving_model(dev)
    strs = [""] * cfg.vocab_size
    for t in range(100, 140):
        strs[t] = chr(ord("a") + t % 26)
    dfa = t_grammar.compile_regex("[a-m]+(x|y)?")
    gs = {"g": t_grammar.compile_token_dfa(dfa, strs, 1)}
    cls = PagedServingEngine if engine == "paged" else ServingEngine
    kw = dict(max_slots=4, max_seq_len=128, decode_params=dq, grammars=gs, sync_every=4)
    if engine == "paged":
        kw["page_size"] = 16
    kern = cls(params, cfg, **kw)
    plain = cls(params, cfg, fused_decode=False, **kw)
    assert kern.fused_decode
    decide, took = kern._head_argmax_tick, []

    def head_tick(with_sampling):
        t = decide(with_sampling)
        assert not (t and any(r is not None and r.grammar for r in kern.slots))
        took.append(t)
        return t

    kern._head_argmax_tick = head_tick
    n0 = kernels.launch_counts()
    got = _served(kern, _serving_requests(cfg, 6, "g"))
    n1 = kernels.launch_counts()
    assert n1["head_argmax"] - n0["head_argmax"] == sum(took) and not all(took)
    assert n1["int8_gemv"] > n0["int8_gemv"]
    assert got == _served(plain, _serving_requests(cfg, 6, "g"))
    for rid in range(0, 6, 2):
        text = "".join(strs[t] for t in got[rid] if t != 1)
        assert dfa.is_live_prefix(text) and len(text) > 0, (rid, got[rid])
        assert got[rid][-1] != 1 or dfa.matches(text)
    assert all(np.all(np.asarray(got[r]) >= 0) for r in got)


@pytest.mark.cuda
def test_paged_prefix_cache_hit_on_card():
    """A paged kernel engine with the prefix cache: two hits of one prompt
    give the miss's tokens, with one prefill (one flash launch a layer)."""
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    dev = _card()
    cfg, params, dq = _serving_model(dev)
    eng = PagedServingEngine(params, cfg, max_slots=1, max_seq_len=128, page_size=16,
                             decode_params=dq, prefix_cache=True, sync_every=4)
    n0 = kernels.launch_counts()["flash_attention_fwd"]
    got = _served(eng, _serving_requests(cfg, 3, same=True))
    assert eng.cache_hits == 2 and eng.prefill_calls == 1
    fl = kernels.launch_counts()["flash_attention_fwd"] - n0
    assert fl == cfg.text_config.num_hidden_layers, fl
    assert got[1] == got[0] and got[2] == got[0] and len(got[0]) == 12


@pytest.mark.cuda
def test_decode_attention_rows_per_cache_bits_on_card():
    """The verify's dense attention: s query rows per cache row, each its own
    mask row, against its plain version, and the bits of the call on the
    cache rows repeated s times."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    b, s, w, d = 3, 5, 200, 256
    kc, vc = (torch.randn(b, w, d, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn(b * s, 8, d, generator=g, device=dev).to(torch.bfloat16)
    valid = torch.rand(b * s, w, generator=g, device=dev) < 0.6
    got = t_dattn.decode_attention(q, kc, vc, valid, d**-0.5, rows_per_cache=s)
    _close_rel(got, t_dattn.decode_attention_reference(q, kc, vc, valid, d**-0.5, s))
    rep = t_dattn.decode_attention(q, kc.repeat_interleave(s, 0).contiguous(),
                                   vc.repeat_interleave(s, 0).contiguous(), valid, d**-0.5)
    assert torch.equal(got, rep)
    with pytest.raises(ValueError, match="rows_per_cache"):
        t_dattn.decode_attention(q[:4], kc, vc, valid[:4], d**-0.5, rows_per_cache=s)


@pytest.mark.cuda
def test_spec_on_card_keeps_the_decode_steps_tokens():
    """generate_spec and both serving engines with spec_decode on the
    decode kernels give the tokens of the non-speculative kernel path,
    exactly (the verify rows have the decode step's bits); no CUDA tensor
    reaches the plain int8 product."""
    import numpy as np

    from paligemma_tpu_torch.kernels import quant
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import ServingEngine
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    dev = _card()
    cfg, params, dq = _serving_model(dev)
    eng = PaliGemmaEngine(params, cfg, max_seq_len=128, decode_params=dq)
    r = _serving_requests(cfg, 1)[0]
    ids = r.input_ids[None]
    px = torch.from_numpy(r.pixel_values[None]).to(dev)
    want = eng.generate(px, ids, np.ones_like(ids), max_new_tokens=40, eos_token_id=-1,
                        sync_every=8)
    plain = quant._int8_matmul
    quant._int8_matmul = lambda x, *a: (_ for _ in ()).throw(AssertionError("plain int8"))
    try:
        for cf in (0.0, 0.5):
            got = eng.generate_spec(px, ids, np.ones_like(ids), max_new_tokens=40,
                                    eos_token_id=-1, draft_k=6, corrupt_frac=cf)
            assert np.array_equal(got, want)
        base = _served(ServingEngine(params, cfg, max_slots=3, max_seq_len=128,
                                     decode_params=dq, sync_every=4), _serving_requests(cfg, 5))
        for make in (lambda: ServingEngine(params, cfg, max_slots=3, max_seq_len=128,
                                           decode_params=dq, sync_every=4, spec_decode=True,
                                           spec_draft_k=5),
                     lambda: PagedServingEngine(params, cfg, max_slots=3, max_seq_len=128,
                                                page_size=16, decode_params=dq, sync_every=4,
                                                spec_decode=True, spec_draft_k=5)):
            assert _served(make(), _serving_requests(cfg, 5)) == base
    finally:
        quant._int8_matmul = plain


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 16, 16), (129, 48, 48), (266, 2048, 2560),
                                   (300, 2048, 2048), (266, 16384, 256), (640, 256, 384)])
def test_w8a8_kernels_equal_their_plain_versions_on_card(m, k, n):
    """K1 (codes and scales, own amax or a given one) and K2 (bf16 output
    and int32 sums) against their plain versions, bit for bit: ragged M, K
    past a stage, N past a tile, an all-zero row and an outlier."""
    from paligemma_tpu_torch.kernels import w8a8

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = (torch.randn(m, k, generator=g, device=dev)
         * 10.0 ** (torch.rand(m, 1, generator=g, device=dev) * 4 - 2)).to(torch.bfloat16)
    x[-1, k // 2] = 80.0
    x[0] = 0  # (at M 1 the outlier's row too)
    x8, a_s = w8a8.w8a8_quant_rows(x)
    r8, rs = w8a8.quant_rows_reference(x)
    assert torch.equal(x8, r8) and torch.equal(a_s, rs)
    amax = torch.rand(m, generator=g, device=dev) * 100 + x.float().abs().amax(-1)
    assert all(torch.equal(a, b) for a, b in zip(w8a8.w8a8_quant_rows(x, amax),
                                                 w8a8.quant_rows_reference(x, amax)))
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand(n, generator=g, device=dev) * 1e-2
    for dtype in (torch.bfloat16, torch.int32):
        got = w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=dtype)
        want = w8a8.gemm_reference(x8, w8, a_s, s, out_dtype=dtype)
        assert torch.equal(got, want), dtype
        assert torch.equal(w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=dtype), got)  # a 2nd call
    assert torch.equal(w8a8.w8a8_matmul(x, w8, s), w8a8.gemm_reference(r8, w8, rs, s))
    assert (got[0] == 0).all()


@pytest.mark.cuda
def test_w8a8_routes_raise_on_bad_inputs_on_card():
    """On the card the W8A8 route and the weight-only route below its gate
    launch their kernels or raise: no fallback to a plain version. fp16 x
    raises on W8A8 (K1 takes bf16 or fp32); fp32 x takes K1 / K2's fp32
    forms and, below the gate, the GEMV tile's fp32 form."""
    from paligemma_tpu_torch.kernels import quant, w8a8

    dev = _fp32_card()
    w = {"w8": torch.randint(-127, 128, (256, 384), device=dev, dtype=torch.int8),
         "s": torch.rand(384, device=dev) * 1e-2}
    x = torch.randn(300, 256, device=dev)
    with pytest.raises(ValueError):
        quant.matmul_any(x.half(), w, int8_act=True)  # fp16 x, 300 rows: W8A8
    before = (w8a8.w8a8_quant_rows_fp32.launches, w8a8.w8a8_gemm_fp32.launches)
    got = quant.matmul_any(x, w, int8_act=True)  # fp32 x, 300 rows: W8A8's fp32 forms
    assert (w8a8.w8a8_quant_rows_fp32.launches, w8a8.w8a8_gemm_fp32.launches) == (
        before[0] + 1, before[1] + 1) and got.dtype == torch.float32
    assert torch.equal(got, quant._w8a8_matmul(x, w["w8"], w["s"]))
    n0 = t_gemv.int8_gemv_fp32.launches
    got = quant.matmul_any(x[:100], w, int8_act=True)  # below the gate: the GEMV tile
    assert t_gemv.int8_gemv_fp32.launches == n0 + 1 and got.dtype == torch.float32
    assert _rel_err(got, quant._int8_matmul(x[:100], w["w8"], w["s"])) <= FP32_REL
    before = (w8a8.w8a8_quant_rows.launches, w8a8.w8a8_gemm.launches)
    got = quant.matmul_any(x.bfloat16(), w, int8_act=True)
    assert (w8a8.w8a8_quant_rows.launches, w8a8.w8a8_gemm.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    assert torch.equal(got, quant._w8a8_matmul(x.bfloat16(), w["w8"], w["s"]))
    with pytest.raises(ValueError):
        w8a8.w8a8_gemm(torch.zeros(4, 40, dtype=torch.int8, device=dev),
                       torch.zeros(40, 32, dtype=torch.int8, device=dev),
                       torch.ones(4, device=dev), torch.ones(32, device=dev))  # K % 16
    with pytest.raises(ValueError):
        w8a8.w8a8_gemm(torch.zeros(4, 64, dtype=torch.int8, device=dev), w["w8"],
                       torch.ones(4, device=dev), w["s"])  # K differs from the weights'


@pytest.mark.cuda
def test_single_copy_engine_on_card_takes_the_w8a8_kernels():
    """The single-copy engine (params = decode_params = the int8 tree) on
    the card: each prefill of >= 256 rows launches K1 and K2 4 times a
    layer and the head's GEMV once, never the plain int8 product; its
    greedy tokens equal those of the same engine whose W8A8 products run
    their plain version (the kernels' bits are the plain version's)."""
    import numpy as np

    from paligemma_tpu_torch.kernels import int8_gemv, quant, w8a8
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine

    dev = _card()
    cfg, params, dq = _serving_model(dev)
    del params
    rng = np.random.default_rng(0)
    ids = np.concatenate([np.full((2, 4), cfg.image_token_index),
                          rng.integers(3, 100, (2, 140))], 1).astype(np.int32)
    px = torch.from_numpy(rng.normal(size=(2, 3, 28, 28)).astype(np.float32)).to(dev)
    mask = np.ones_like(ids)
    eng = PaliGemmaEngine(dq, cfg, max_seq_len=256, decode_params=dq, int8_act_prefill=True)
    plain = quant._int8_matmul
    quant._int8_matmul = lambda x, *a: (_ for _ in ()).throw(AssertionError("plain int8"))
    try:
        before = (w8a8.w8a8_quant_rows.launches, w8a8.w8a8_gemm.launches,
                  int8_gemv.int8_gemv.launches)
        eng.prefill(px, ids, mask)
        torch.cuda.synchronize()
        grew = (w8a8.w8a8_quant_rows.launches - before[0], w8a8.w8a8_gemm.launches - before[1],
                int8_gemv.int8_gemv.launches - before[2])
        assert grew == (8, 8, 1), grew
        got = eng.generate(px, ids, mask, max_new_tokens=16, eos_token_id=-1, sync_every=8)
    finally:
        quant._int8_matmul = plain
    kernels = quant.w8a8.w8a8_matmul
    quant.w8a8.w8a8_matmul = lambda x, w8, s: quant._w8a8_matmul(x, w8, s)
    try:
        want = eng.generate(px, ids, mask, max_new_tokens=16, eos_token_id=-1, sync_every=8)
    finally:
        quant.w8a8.w8a8_matmul = kernels
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# The fp32 forms (--dtype float32): each held to its plain fp32 version with
# TF32 off. The GEMV tile's three-term split is within ~1.5e-6 of the
# largest element of fp32 x @ W at K = 16384 (tests/test_torch_fp32.py
# models it); a single bf16 or TF32 pass is ~1e-3 off. FP32_REL is ten
# times the former and fifty times below the latter.
FP32_REL = 2e-5


def _fp32_card():
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    return dev


def _rel_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return float((got.float() - want.float()).abs().max()) / max(
        1.0, float(want.float().abs().max()))


def _rel_max(got, want):
    """max |got - want| over max |want| (gradients lie far below 1)."""
    return float((got - want).abs().max()) / float(want.abs().max())


def _fp32_flash_counts():
    """The launches of B1's and B6's fp32 forms, then of their bf16 kernels."""
    return [t_flash.flash_attention_fwd_fp32.launches, t_flash.flash_attention_bwd_dq_fp32.launches,
            t_flash.flash_attention_bwd_dkv_fp32.launches, t_flash.flash_attention.launches,
            t_flash.flash_attention_bwd_dq.launches, t_flash.flash_attention_bwd_dkv.launches]


# B6's fp32 form: (b, s, hq, hkv, d), prefix_len, kv_len; the training shape
# at 8 and at a tensor-parallel rank's 4 query heads, each depth
# instantiation (64, 80, 128, 256), a kv_len 0 row, and the 3xTF32 tiles'
# edges (a key count off the 32-key tile; D72 padded to 80 with heads
# folded across 64-row tiles)
FLASH_BWD_FP32_CASES = {
    "train B2 S512 Hq8 Hkv1 D256": ((2, 512, 8, 1, 256), [268, 268], [512, 400]),
    "train TP-local B2 S512 Hq4 Hkv1 D256": ((2, 512, 4, 1, 256), [268, 268], [512, 400]),
    "GQA B2 S199 Hq4 Hkv2 D64": ((2, 199, 4, 2, 64), [60, 100], [199, 150]),
    "kv_len 0 row B2 S40 Hq4 Hkv2 D72": ((2, 40, 4, 2, 72), [17, 0], [40, 0]),
    "prefix-LM B1 S130 Hq2 Hkv1 D128": ((1, 130, 2, 1, 128), [50], [130]),
    "key tile edge B1 S77 Hq6 Hkv2 D80": ((1, 77, 6, 2, 80), [40], [70]),
    "heads straddle tiles B2 S45 Hq8 Hkv1 D72": ((2, 45, 8, 1, 72), [20, 45], [45, 33]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_BWD_FP32_CASES))
def test_flash_backward_fp32_form_on_card(case):
    """B6's fp32 forms (dq; dk/dv with the fp32-out split sum) against the
    plain fp32 backward on the same inputs (the fp32 forward's lse): dq, dk
    and dv within FP32_REL of the largest element; a second call the same
    bits (fixed-order splits); counted on the fp32 forms only; a kv_len 0
    row exact zeros; the bf16 kernels refuse an fp32 dout beside bf16 q."""
    dev = _fp32_card()
    (b, s, hq, hkv, d), pfx, kvl = FLASH_BWD_FP32_CASES[case]
    g = torch.Generator(device=dev).manual_seed(21)
    q, dout = (torch.randn(b, s, hq, d, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=dev) for _ in range(2))
    pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
    kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
    out, lse = t_flash.flash_attention_with_lse(q, k, v, pl, kl)
    delta = t_flash._delta(out, dout)
    args = (q, k, v, dout, lse, delta, pl, kl, d**-0.5)
    n = _fp32_flash_counts()
    dq = t_flash.flash_attention_bwd_dq(*args)
    dk, dv = t_flash.flash_attention_bwd_dkv(*args)
    assert [b1 - a for a, b1 in zip(n, _fp32_flash_counts())] == [0, 1, 1, 0, 0, 0]
    want = t_flash._reference_backward(*args, 0)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32 and _rel_max(got, ref) <= FP32_REL
    again = (t_flash.flash_attention_bwd_dq(*args), *t_flash.flash_attention_bwd_dkv(*args))
    assert all(torch.equal(x, y) for x, y in zip(again, (dq, dk, dv)))
    if kvl[-1] == 0:
        assert not dq[-1].any() and not dk[-1].any() and not dv[-1].any()
    with pytest.raises(ValueError, match="q's dtype"):
        t_flash.flash_attention_bwd_dq(q.to(torch.bfloat16), k.to(torch.bfloat16),
                                       v.to(torch.bfloat16), dout, lse, delta, pl, kl, d**-0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(1, 256, 16, 72), (1, 1024, 16, 72), (1, 4096, 16, 72),
                                     (2, 128, 3, 64), (1, 256, 4, 128), (1, 512, 2, 8)])
def test_vision_attention_fp32_form_on_card(b, s, h, d):
    """B12's fp32 form (the fp32 flash forward with every key visible) at
    the 224, 448 and 896 px towers' S and at each depth instantiation,
    against the one-shot fp32 softmax within FP32_REL; a second call the
    same bits; counted on vision_attention_fp32 only; mixed dtypes raise."""
    from paligemma_tpu_torch.kernels.ablation import vision_attention as t_va

    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev) for _ in range(3))
    n32, n16 = t_va.vision_attention_fp32.launches, t_va.vision_attention.launches
    got = t_va.vision_attention(q, k, v)
    assert (t_va.vision_attention_fp32.launches - n32, t_va.vision_attention.launches) == (1, n16)
    assert got.dtype == torch.float32
    assert _rel_err(got, t_va.vision_attention_reference(q, k, v, d**-0.5)) <= FP32_REL
    assert torch.equal(t_va.vision_attention(q, k, v), got)
    with pytest.raises(ValueError, match="q's dtype"):
        t_va.vision_attention(q, k.to(torch.bfloat16), v)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv", [(1, 8, 1), (8, 8, 1), (8, 4, 2)])
def test_seg_decode_attention_fp32_form_on_card(b, hq, hkv):
    """B10's fp32 form (the fp32 split pass over SegKV<float>) at the Gemma-2B
    cache (S 2048, D 256) with pad holes and kv_len at tile edges, against
    the plain fp32 version within FP32_REL; NaN in tiles wholly inside a
    hole or past kv_len is never read; counted on the fp32 form only."""
    from paligemma_tpu_torch.kernels.ablation import decode_attention as t_sda

    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(b * 10 + hkv)
    q = torch.randn(b, hq, 256, generator=g, device=dev)
    kc, vc = (torch.randn(b, 2048, hkv, 256, generator=g, device=dev) for _ in range(2))
    rows = ([2048, 64, 250, 256, 300, 33, 97, 700], [2048, 64, 266, 640, 300, 33, 1200, 700],
            [2048, 64, 1000, 1024, 300, 33, 1500, 700])
    segs = [torch.tensor(r[:b], dtype=torch.int32, device=dev) for r in rows]
    n32, n16 = t_sda.decode_attention_fp32.launches, t_sda.decode_attention.launches
    got = t_sda.decode_attention(q, kc, vc, *segs)
    assert (t_sda.decode_attention_fp32.launches - n32, t_sda.decode_attention.launches) == (1, n16)
    assert got.dtype == torch.float32
    assert _rel_err(got, t_sda.reference_decode_attention(q, kc, vc, *segs)) <= FP32_REL
    if b > 1:
        kp, vp = kc.clone(), vc.clone()
        for t in (kp, vp):
            t[3, 256:640] = float("nan")
            t[1, 64:] = float("nan")
        assert torch.equal(t_sda.decode_attention(q, kp, vp, *segs), got)
    with pytest.raises(ValueError, match="q's dtype"):
        t_sda.decode_attention(q, kc.to(torch.bfloat16), vc.to(torch.bfloat16), *segs)


# The fp32 forward's tile edges ((b, sq, skv, hq, hkv, d), prefix_len,
# kv_len, q_offset): folded rows at and around its row blocks (16 rows at
# D256, 32 at D128, 64 at D64 / D72), key counts at and around its 32-key
# tile, each depth instantiation, a query offset, GQA at Hkv 2, a kv_len 0
# row
FLASH_FWD_FP32_EDGES = {
    "one 16-row block B1 S2 Hq8 Hkv1 D256": ((1, 2, 2, 8, 1, 256), [2], [2], 0),
    "16-row blocks + 8 B1 S3 Hq8 Hkv1 D256": ((1, 3, 3, 8, 1, 256), [3], [3], 0),
    "rows 2128 + keys 33 B1 S266 Hq8 Hkv1 D256": ((1, 266, 33, 8, 1, 256), [33], [33], 233),
    "rows 63 keys 32 B1 S63 H16 D72": ((1, 63, 63, 16, 16, 72), [32], [32], 0),
    "rows 65 keys 31 B2 S65 H4 D72": ((2, 65, 65, 4, 4, 72), [31, 65], [31, 64], 0),
    "rows 64 GQA Hkv2 B1 S32 Hq4 D64": ((1, 32, 32, 4, 2, 64), [10], [32], 0),
    "32-row blocks D128 B2 S33 Hq2 Hkv1": ((2, 33, 33, 2, 1, 128), [5, 33], [33, 20], 0),
    "D80 as D128 B1 S77 Hq6 Hkv2": ((1, 77, 77, 6, 2, 80), [40], [70], 0),
    "q_offset 300 keys 352 B1 Sq16 Hq8 Hkv1 D256": ((1, 16, 352, 8, 1, 256), [200], [316], 300),
    "kv_len 0 row GQA B2 S40 Hq4 Hkv2 D72": ((2, 40, 40, 4, 2, 72), [17, 0], [40, 0], 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_FWD_CASES) + list(FLASH_FWD_FP32_EDGES))
def test_flash_forward_fp32_form_on_card(case):
    """B1's fp32 form against the plain fp32 forward: out within FP32_REL
    and lse within 1e-5 of max(1, |plain|); one launch counted on the fp32
    form per call, none on the bf16 kernel; a second call the same bits; a
    kv_len 0 row exact zeros; fp32 inputs that require grad run the fp32
    backward kernels (one launch each), dq, dk and dv within FP32_REL of
    the largest element of the plain backward's."""
    dev = _fp32_card()
    (b, sq, skv, hq, hkv, d), pfx, kvl, q_offset = {**FLASH_FWD_CASES,
                                                     **FLASH_FWD_FP32_EDGES}[case]
    g = torch.Generator(device=dev).manual_seed(17)
    q, k, v = (torch.randn(shape, generator=g, device=dev)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
    kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
    n0, n16 = t_flash.flash_attention_fwd_fp32.launches, t_flash.flash_attention.launches
    out, lse = t_flash.flash_attention_with_lse(q, k, v, pl, kl, q_offset=q_offset)
    assert t_flash.flash_attention_fwd_fp32.launches == n0 + 1
    assert t_flash.flash_attention.launches == n16 and out.dtype == torch.float32
    want_out, want_lse = t_flash._reference_forward(q, k, v, pl, kl, d**-0.5, q_offset)
    assert _rel_err(out, want_out) <= FP32_REL
    assert _rel_err(lse, want_lse) <= 1e-5
    again = t_flash.flash_attention_with_lse(q, k, v, pl, kl, q_offset=q_offset)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert torch.equal(t_flash.flash_attention(q, k, v, pl, kl, q_offset=q_offset), out)
    if kvl[-1] == 0:
        assert not out[-1].any() and not lse[-1].any()
    dout = torch.randn(out.shape, generator=g, device=dev)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    n = _fp32_flash_counts()
    t_flash.flash_attention(qg, kg, vg, pl, kl, q_offset=q_offset).backward(dout)
    assert [b - a for a, b in zip(n, _fp32_flash_counts())] == [1, 1, 1, 0, 0, 0]
    want = t_flash.reference_attention_backward(q, k, v, want_out, want_lse, dout, pl, kl,
                                                d**-0.5, q_offset)
    for got, ref in zip((qg.grad, kg.grad, vg.grad), want):
        assert _rel_max(got, ref) <= FP32_REL
    with pytest.raises(ValueError, match="all bf16 or all fp32"):
        t_flash.flash_attention(q.detach().to(torch.bfloat16), k, v, pl, kl)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 2560), (2048, 2048), (2048, 32768), (16384, 2048),
                                 (256, 208), (72, 100)])
@pytest.mark.parametrize("epi", ["plain", "residual", "geglu", "norm"])
def test_int8_gemv_fp32_form_on_card(k, n, epi):
    """The GEMV tile's fp32 form (three bf16 terms of x) at Gemma-2B's four
    projections and ragged shapes, B 1, 8, 9 and 72, against the plain fp32
    version within FP32_REL; fp32 out; a second call the same bits; counted
    on int8_gemv_fp32; the fp32 partial (mode 3) has mode 0's bits. Prints
    the case's worst error (``-s``)."""
    dev = _fp32_card()
    if epi == "norm" and k % 4:
        pytest.skip("the fp32 prologue takes K % 4 == 0")
    g = torch.Generator(device=dev).manual_seed(k * 7 + n)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    worst = 0.0
    for b in (1, 8, 9, 72):
        x = torch.randn(b, k, generator=g, device=dev) * 2.0
        kw = {}
        if epi == "residual":
            kw["residual"] = torch.randn(b, n, generator=g, device=dev)
        elif epi == "geglu":
            kw["geglu"] = True
        elif epi == "norm":
            kw["norm"] = (torch.randn(k, generator=g, device=dev) * 0.1, 1e-6)
        n0 = t_gemv.int8_gemv_fp32.launches
        got = t_gemv.int8_gemv(x, w8, s, **kw)
        assert t_gemv.int8_gemv_fp32.launches == n0 + 1 and got.dtype == torch.float32
        want = t_gemv.int8_gemv_reference(x, w8, s, **kw)
        worst = max(worst, _rel_err(got, want))
        assert _rel_err(got, want) <= FP32_REL, (b, _rel_err(got, want))
        assert torch.equal(t_gemv.int8_gemv(x, w8, s, **kw), got)
    print(f"fp32 GEMV worst error K {k} N {n} {epi}: {worst:.3e} (FP32_REL {FP32_REL})")
    if epi == "plain":
        n0 = t_gemv.int8_gemv_f32_fp32.launches
        assert torch.equal(t_gemv.int8_gemv_f32(x, w8, s), got)
        assert t_gemv.int8_gemv_f32_fp32.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,bounds,kw", [
    (2048, 2560, (2048, 2304), {"norm": True}), (2048, 2048, (), {"residual": True}),
    (2048, 32768, (16384,), {"geglu": True, "norm": True}), (16384, 2048, (), {"residual": True})])
def test_lora_shrink_and_expand_fp32_forms_on_card(a_dtype, k, n, bounds, kw):
    """F1 and F2 at Gemma-2B's four targets with a [base, a, b, c] rank-8 bank
    (G 32), B 1 and 8 (qkv and gate | up with the norm): the fp32 shrink
    (z fp32, A in fp32 or bf16) and the fp32 GEMV with the expand against
    their plain versions within FP32_REL; counted on lora_shrink_fp32 and
    int8_gemv_fp32; base rows the fp32 GEMV's bits without the bank; a
    second call the same bits; a bf16 basis beside fp32 x raises."""
    from paligemma_tpu_torch.kernels import lora as t_lora

    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(k + n + 3)
    gcols, rank = 32, 8
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    ntarget = len(bounds) + 1
    a = torch.randn(k, ntarget * gcols, generator=g, device=dev) * k**-0.5
    a[:, torch.arange(ntarget * gcols, device=dev) % gcols < rank] = 0  # the zero adapter
    a = a.to(a_dtype)
    lb = (torch.randn(gcols, n, generator=g, device=dev) * 0.5).to(a_dtype)
    for b in (1, 8):
        x = torch.randn(b, k, generator=g, device=dev)
        ids = (torch.arange(b, device=dev) % 4).to(torch.int32)
        gkw = {"geglu": True} if kw.get("geglu") else {}
        if kw.get("residual"):
            gkw["residual"] = torch.randn(b, n, generator=g, device=dev)
        norm = (torch.randn(k, generator=g, device=dev) * 0.1, 1e-6) if kw.get("norm") else None
        s0, g0 = t_lora.lora_shrink_fp32.launches, t_gemv.int8_gemv_fp32.launches
        z = t_lora.lora_shrink(x, a, ids, rank, gcols, norm=norm)
        zp = t_lora.lora_shrink_reference(x, a, ids, rank, gcols, norm=norm)
        assert z.dtype == torch.float32 and _rel_err(z, zp) <= FP32_REL
        assert torch.equal(t_lora.lora_shrink(x, a, ids, rank, gcols, norm=norm), z)
        got = t_gemv.int8_gemv(x, w8, s, lora=(z, lb, bounds), norm=norm, **gkw)
        want = t_gemv.int8_gemv_reference(x, w8, s, lora=(zp, lb, bounds), norm=norm, **gkw)
        assert got.dtype == torch.float32 and _rel_err(got, want) <= FP32_REL
        assert torch.equal(t_gemv.int8_gemv(x, w8, s, lora=(z, lb, bounds), norm=norm, **gkw),
                           got)
        assert (t_lora.lora_shrink_fp32.launches - s0, t_gemv.int8_gemv_fp32.launches - g0) == (
            2, 2)
        plain = t_gemv.int8_gemv(x, w8, s, norm=norm, **gkw)
        assert torch.equal(got[ids == 0], plain[ids == 0])
        if b > 1:
            assert not torch.equal(got[ids != 0], plain[ids != 0])
        with pytest.raises(ValueError, match="x's dtype"):
            t_gemv.int8_gemv(x, w8, s, lora=(z.bfloat16(), lb, bounds), norm=norm, **gkw)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("k", [2048, 8192])
def test_fp32_partial_and_k1_fp32_forms_on_card(b, k):
    """F3: the fp32 partial (mode 3) of fp32 x has mode 0's bits; K1's fp32
    form against its plain version within FP32_REL, and its [base | delta]
    added as decode_layer_tp.add_partial adds them has the bits of the fp32
    residual GEMV with the expand (one rank is one card); each counted on
    its own fp32 counter."""
    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(23 + b)
    n, gcols = 2048, 32
    x = torch.randn(b, k, generator=g, device=dev) * 0.5
    h = torch.randn(b, n, generator=g, device=dev)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    lb = torch.randn(gcols, n, generator=g, device=dev) * 0.5
    z = torch.randn(b, gcols, generator=g, device=dev) * 0.3
    f0, l0 = t_gemv.int8_gemv_f32_fp32.launches, t_gemv.int8_gemv_f32_lora_fp32.launches
    part = t_gemv.int8_gemv_f32(x, w8, s)
    assert torch.equal(part, t_gemv.int8_gemv(x, w8, s))
    got = t_gemv.int8_gemv_f32(x, w8, s, lora=(z, lb, ()))
    assert (t_gemv.int8_gemv_f32_fp32.launches - f0,
            t_gemv.int8_gemv_f32_lora_fp32.launches - l0) == (1, 1)
    assert got.shape == (b, 2 * n) and got.dtype == torch.float32
    want = t_gemv.int8_gemv_reference(x, w8, s, out_fp32=True, lora=(z, lb, ()))
    assert _rel_err(got, want) <= FP32_REL
    assert torch.equal(got[:, :n], part)
    assert torch.equal(got, t_gemv.int8_gemv_f32(x, w8, s, lora=(z, lb, ())))
    assert torch.equal((h + got[:, :n]) + got[:, n:],
                       t_gemv.int8_gemv(x, w8, s, residual=h, lora=(z, lb, ())))


@pytest.mark.cuda
@pytest.mark.parametrize("proj", ["qkv", "o", "gateup", "down"])
@pytest.mark.parametrize("m", [1, 16, 255, 256, 266, 267, 2560])
def test_w8a8_gemm_plans_on_card(m, proj):
    """K2 at one Gemma-2B layer's four projections and the rows around its
    row tiles (16, 256, 272 = 144 + 128) and K splits (4 and 6 ranks at M266,
    persistent CTAs at M2560): bf16, fp32 and int32 out bit for bit the plain
    version's (the int32 sums int_sums_reference's), the same bits on a
    second call, one launch a call."""
    from paligemma_tpu_torch.kernels import w8a8

    k, n = {"qkv": (2048, 2560), "o": (2048, 2048), "gateup": (2048, 32768),
            "down": (16384, 2048)}[proj]
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(m * 7 + k + n)
    x = (torch.randn(m, k, generator=g, device=dev)
         * 10.0 ** (torch.rand(m, 1, generator=g, device=dev) * 4 - 2)).to(torch.bfloat16)
    x[-1, k // 3] = 80.0
    x[0] = 0
    x8, a_s = w8a8.w8a8_quant_rows(x)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand(n, generator=g, device=dev) * 1e-2
    exact = w8a8.int_sums_reference(x8, w8)
    n0 = (w8a8.w8a8_gemm.launches, w8a8.w8a8_gemm_fp32.launches)
    acc = w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=torch.int32)
    assert torch.equal(acc, exact)
    for dtype in (torch.bfloat16, torch.float32):
        got = w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, w8a8.scale_sums(exact, a_s, s, dtype))
        assert torch.equal(w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=dtype), got)
    assert (w8a8.w8a8_gemm.launches - n0[0], w8a8.w8a8_gemm_fp32.launches - n0[1]) == (3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 16, 16), (129, 48, 48), (266, 2048, 2560),
                                   (266, 16384, 256), (640, 256, 384)])
def test_w8a8_fp32_forms_on_card(m, k, n):
    """F4: K1 reading fp32 rows (own amax or a given one) and K2 writing
    fp32 against their plain versions bit for bit; w8a8_matmul of fp32 x
    equals the plain W8A8; counted on the fp32 counters only."""
    from paligemma_tpu_torch.kernels import w8a8

    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(m + k + n + 1)
    x = (torch.randn(m, k, generator=g, device=dev)
         * 10.0 ** (torch.rand(m, 1, generator=g, device=dev) * 4 - 2))
    x[-1, k // 2] = 80.0
    x[0] = 0
    before = {f: f.launches for f in (w8a8.w8a8_quant_rows, w8a8.w8a8_gemm,
                                      w8a8.w8a8_quant_rows_fp32, w8a8.w8a8_gemm_fp32)}
    x8, a_s = w8a8.w8a8_quant_rows(x)
    r8, rs = w8a8.quant_rows_reference(x)
    assert torch.equal(x8, r8) and torch.equal(a_s, rs)
    amax = torch.rand(m, generator=g, device=dev) * 100 + x.abs().amax(-1)
    assert all(torch.equal(a, b) for a, b in zip(w8a8.w8a8_quant_rows(x, amax),
                                                 w8a8.quant_rows_reference(x, amax)))
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand(n, generator=g, device=dev) * 1e-2
    got = w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, w8a8.gemm_reference(x8, w8, a_s, s, out_dtype=torch.float32))
    assert torch.equal(w8a8.w8a8_matmul(x, w8, s), got)
    grew = {f.__name__: f.launches - n0 for f, n0 in before.items()}
    assert grew == {"w8a8_quant_rows": 0, "w8a8_gemm": 0, "w8a8_quant_rows_fp32": 3,
                    "w8a8_gemm_fp32": 2}, grew
    assert (got[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("paged", [False, True])
def test_int8_gemv_rope_kv_fp32_form_on_card(b, paged):
    """The qkv GEMV's fp32 form with the norm prologue and the RoPE + KV
    write epilogue (Gemma-2B's K 2048, 8 heads of 256) against the plain
    chain it replaces, dense rows and page slots; counted on
    int8_gemv_rope_kv_fp32."""
    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(31 + b)
    k, h, d, ps = 2048, 8, 256, 64
    n = (h + 2) * d
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    x = torch.randn(b, k, generator=g, device=dev) * 3.0
    norm = (torch.randn(k, generator=g, device=dev) * 0.1, 1e-6)
    ang = torch.rand(b, d, generator=g, device=dev) * 6.28
    cos, sin = ang.cos(), ang.sin()
    pos = torch.randint(0, 300, (b,), generator=g, device=dev, dtype=torch.int32)
    table = None
    if paged:
        table = (torch.randperm(b * 8, generator=g, device=dev).reshape(b, 8) + 1).to(torch.int32)
        shape = (b * 8 + 1, ps, d)
    else:
        shape = (b, 512, d)
    outs = []
    for fn in (t_gemv.int8_gemv_rope_kv, t_gemv.int8_gemv_rope_kv_reference):
        kc, vc = torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)
        kn, vn = torch.empty(b, d, device=dev), torch.empty(b, d, device=dev)
        n0 = t_gemv.int8_gemv_rope_kv_fp32.launches
        q, _, _ = fn(x, w8, s, cos, sin, pos, h, kc, vc, kn, vn, norm=norm, page_table=table)
        if fn is t_gemv.int8_gemv_rope_kv:
            assert t_gemv.int8_gemv_rope_kv_fp32.launches == n0 + 1
        outs.append((q, kc, vc, kn, vn))
    for got, want in zip(*outs):
        assert got.dtype == torch.float32 and _rel_err(got, want) <= FP32_REL


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,kw", [(2048, 2560, {"norm": True}), (2048, 2048, {"residual": True}),
                                    (2048, 32768, {"geglu": True, "norm": True}),
                                    (16384, 2048, {"residual": True}), (2048, 257152, {})],
                         ids=["qkv", "o", "gateup", "down", "head"])
def test_fp32_gemv_row_has_the_same_bits_at_every_batch_on_card(k, n, kw):
    """At fp32 a row's GEMV output (the four projections of Gemma-2B with
    their epilogues, and the logits) and its B3 id and logit are the same
    bits alone (B1) as inside B2, B8, B9 and B72 (a last batch tile of one
    row): the tile's sum order depends on (K, N) alone, whichever column of
    the B operand holds the row."""
    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(k + n)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    x = torch.randn(72, k, generator=g, device=dev) * 2.0
    args = dict(kw)
    if "norm" in args:
        args["norm"] = (torch.randn(k, generator=g, device=dev) * 0.1, 1e-6)
    res = torch.randn(72, n, generator=g, device=dev) if "residual" in args else None
    head = t_head.repack_head({"w8": w8, "s": s}) if n == 257152 else None

    def run(rows):
        if res is not None:
            args["residual"] = res[rows].contiguous()
        out = t_gemv.int8_gemv(x[rows].contiguous(), w8, s, **args)
        if head is None:
            return out, None
        return out, t_head.head_argmax_fused(x[rows].contiguous(), head, return_max=True)

    whole = {b: run(slice(0, b)) for b in (2, 8, 9, 72)}
    for r in (0, 1, 5, 8, 71):
        alone, ids = run(slice(r, r + 1))
        for b, (out, b_ids) in whole.items():
            if r < b:
                assert torch.equal(out[r], alone[0]), (r, b)
                if ids is not None:
                    assert torch.equal(b_ids[0][r], ids[0][0]) and torch.equal(b_ids[1][r],
                                                                            ids[1][0]), (r, b)


@pytest.mark.cuda
@pytest.mark.parametrize("vocab", [257152, 4096, 300])
def test_head_argmax_fp32_form_equals_argmax_of_the_fp32_logits_on_card(vocab):
    """The head's fp32 form == argmax of the fp32 logits path's GEMV
    (int8_gemv_fp32 over the unpadded vocab), id and logit bit for bit, at
    B 1, 8 and 33, counted on head_argmax_fp32; the logits within FP32_REL
    of the plain fp32 head."""
    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(vocab + 1)
    w8 = torch.randint(-127, 128, (2048, vocab), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(vocab, generator=g, device=dev) + 0.5) / (127 * 2048**0.5)
    head = t_head.repack_head({"w8": w8, "s": s})
    for b in (1, 8, 33):
        y = torch.randn(b, 2048, generator=g, device=dev)
        n0 = t_head.head_argmax_fp32.launches
        ids, mx = t_head.head_argmax_fused(y, head, return_max=True)
        assert t_head.head_argmax_fp32.launches == n0 + 1
        logits = t_gemv.int8_gemv(y, w8, s)
        assert logits.dtype == torch.float32
        assert torch.equal(ids.long(), logits.argmax(-1))
        assert torch.equal(mx, logits.max(-1).values)
        assert _rel_err(logits, (y @ w8.float()) * s) <= FP32_REL


@pytest.mark.cuda
@pytest.mark.parametrize("grp", [1, 8])
def test_split_attention_fp32_form_dense_equals_paged_on_card(grp):
    """3b's and B5's fp32 forms against the plain fp32 versions within
    FP32_REL, and on the same keys the same bits (a 5-page window of 16
    against a padded dense window); a row with no visible key gives zeros;
    W 2048 at B 8; counted on the fp32 forms."""
    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(40 + grp)
    for b, d, ps, s_len, lens in ((3, 128, 16, 256, [37, 0, 80]),
                                  (8, 256, 64, 2048, [2048, 1, 700, 1500, 64, 65, 2000, 333])):
        q = torch.randn(b, grp, d, generator=g, device=dev)
        kc, vc = (torch.randn(b, s_len, d, generator=g, device=dev) for _ in range(2))
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        valid = (torch.arange(s_len, device=dev)[None] < ln[:, None].long()).contiguous()
        n0 = t_dattn.decode_attention_fp32.launches
        dense = t_dattn.decode_attention(q, kc, vc, valid, d**-0.5)
        assert t_dattn.decode_attention_fp32.launches == n0 + 1 and dense.dtype == torch.float32
        assert _rel_err(dense, t_dattn.decode_attention_reference(q, kc, vc, valid,
                                                                  d**-0.5)) <= FP32_REL
        assert torch.equal(t_dattn.decode_attention(q, kc, vc, valid, d**-0.5), dense)
        if 0 in lens:
            assert torch.count_nonzero(dense[lens.index(0)]) == 0
        pool_k = kc.reshape(b * s_len // ps, ps, 1, d)
        pool_v = vc.reshape(b * s_len // ps, ps, 1, d)
        n_p = max(lens) // ps + 1
        tab = (torch.arange(n_p, device=dev)[None]
               + (s_len // ps) * torch.arange(b, device=dev)[:, None]).to(torch.int32)
        tab = torch.minimum(tab, torch.tensor(b * s_len // ps - 1, device=dev)).to(torch.int32)
        n0 = t_paged.paged_decode_attention_fp32.launches
        paged = t_paged.paged_decode_attention(q, pool_k, pool_v, tab, ln, d**-0.5)
        assert t_paged.paged_decode_attention_fp32.launches == n0 + 1
        assert torch.equal(paged, dense.reshape(b, grp, d))
        assert _rel_err(paged, t_paged.reference_paged_decode_attention(
            q, pool_k, pool_v, tab, ln, d**-0.5)) <= FP32_REL


@pytest.mark.cuda
def test_decode_attention_fp32_rows_per_cache_bits_on_card():
    """The verify's dense attention at fp32: s query rows per cache row give
    the bits of the call on the cache rows repeated s times."""
    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(12)
    b, s, w, d = 3, 5, 200, 256
    kc, vc = (torch.randn(b, w, d, generator=g, device=dev) for _ in range(2))
    q = torch.randn(b * s, 8, d, generator=g, device=dev)
    valid = torch.rand(b * s, w, generator=g, device=dev) < 0.6
    got = t_dattn.decode_attention(q, kc, vc, valid, d**-0.5, rows_per_cache=s)
    assert _rel_err(got, t_dattn.decode_attention_reference(q, kc, vc, valid, d**-0.5,
                                                            s)) <= FP32_REL
    rep = t_dattn.decode_attention(q, kc.repeat_interleave(s, 0).contiguous(),
                                   vc.repeat_interleave(s, 0).contiguous(), valid, d**-0.5)
    assert torch.equal(got, rep)


@pytest.mark.cuda
def test_rms_norm_fp32_form_on_card():
    """The final norm on fp32 rows: fp32 out within 1e-6 of the plain
    version, counted on rms_norm_fp32."""
    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(8, 2048, generator=g, device=dev) * 4.0
    w = torch.randn(2048, generator=g, device=dev) * 0.1
    n0 = t_elem.rms_norm_fp32.launches
    got = t_elem.rms_norm(x, w, 1e-6)
    assert t_elem.rms_norm_fp32.launches == n0 + 1 and got.dtype == torch.float32
    assert _rel_err(got, t_elem.rms_norm_reference(x, w, 1e-6)) <= 1e-6


def _serving_model_fp32(dev):
    """:func:`_serving_model`'s tiny MQA model in fp32, and its int8 tree."""
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving

    cfg, params, _ = _serving_model(dev)
    params = _to_fp32(params)
    return cfg, params, quantize_lm_for_serving(params)


def _to_fp32(tree):
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    return tree.float() if torch.is_tensor(tree) and tree.is_floating_point() else tree


@pytest.mark.cuda
def test_fp32_engines_on_card_spec_equals_greedy_dense_equals_paged():
    """The fp32 kernel path end to end at a tiny MQA config: every fp32 form
    launches; generate_spec gives generate's tokens exactly (the verify
    rows have the decode step's bits); the dense and the paged serving
    engines give the same tokens, with and without spec_decode; the prefill
    logits within 1e-3 of the torch-ops engine's max |logit|; an fp16 cache
    (no kernel form takes it) raises."""
    import numpy as np

    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import ServingEngine
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    dev = _fp32_card()
    cfg, params, dq = _serving_model_fp32(dev)
    with pytest.raises(ValueError, match="KV cache"):
        PaliGemmaEngine(params, cfg, max_seq_len=128, decode_params=dq,
                        cache_dtype=torch.float16)
    eng = PaliGemmaEngine(params, cfg, max_seq_len=128, decode_params=dq)
    ref = PaliGemmaEngine(params, cfg, max_seq_len=128, decode_params=dq, use_flash=False,
                          fused_layer=False)
    r = _serving_requests(cfg, 1)[0]
    ids = r.input_ids[None]
    px = torch.from_numpy(r.pixel_values[None]).to(dev)
    lk, _ = eng.prefill(px, ids, np.ones_like(ids))
    lp, _ = ref.prefill(px, ids, np.ones_like(ids))
    assert float((lk - lp).abs().max()) <= 1e-3 * float(lp.abs().max())
    kernels.reset_launch_counts()
    want = eng.generate(px, ids, np.ones_like(ids), max_new_tokens=40, eos_token_id=-1,
                        sync_every=8)
    counts = kernels.launch_counts()
    for name in ("flash_attention_fwd_fp32", "int8_gemv_fp32", "int8_gemv_rope_kv_fp32",
                 "head_argmax_fp32", "decode_attention_fp32", "rms_norm_fp32"):
        assert counts[name] > 0, name
    for name in ("flash_attention_fwd", "int8_gemv", "int8_gemv_rope_kv", "head_argmax",
                 "decode_attention", "rms_norm"):
        assert counts[name] == 0, name
    got = eng.generate_spec(px, ids, np.ones_like(ids), max_new_tokens=40, eos_token_id=-1,
                            draft_k=6)
    assert np.array_equal(got, want)
    kw = dict(max_slots=3, max_seq_len=128, decode_params=dq, sync_every=4)
    dense = _served(ServingEngine(params, cfg, **kw), _serving_requests(cfg, 5))
    kernels.reset_launch_counts()
    paged = _served(PagedServingEngine(params, cfg, page_size=16, **kw),
                    _serving_requests(cfg, 5))
    assert kernels.launch_counts()["paged_decode_attention_fp32"] > 0
    assert paged == dense
    for cls, extra in ((ServingEngine, {}), (PagedServingEngine, {"page_size": 16})):
        spec = _served(cls(params, cfg, spec_decode=True, spec_draft_k=5, **kw, **extra),
                       _serving_requests(cfg, 5))
        assert spec == dense


# -- the mixed forms: a KV cache whose dtype is not the activations' -------
# (activations, cache) pairs; the bf16 forms keep the bf16 tolerance, the
# fp32 forms FP32_REL
MIXED = [(torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


def _mixed_tol(act):
    return 1e-2 if act == torch.bfloat16 else FP32_REL


@pytest.mark.cuda
@pytest.mark.parametrize("act,cache", MIXED)
@pytest.mark.parametrize("b,paged,bank", [(1, False, False), (8, False, True),
                                          (8, True, False), (8, True, True)])
def test_int8_gemv_rope_kv_mixed_forms_on_card(act, cache, b, paged, bank):
    """The qkv GEMV's mixed forms (Gemma-2B's K 2048, 8 heads of 256, dense
    rows or page slots, with and without a LoRA bank): q is the uniform
    form's bit for bit, and the cache rows and k_new / v_new are the uniform
    form's converted to the cache dtype (.to(): widened exactly, or rounded
    to nearest even); within the form's tolerance of the plain chain (a
    bf16 output within the bf16 forms'); counted on the mixed form's
    counter only."""
    from paligemma_tpu_torch.kernels import lora as t_lora

    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(51 + b + paged + bank)
    k, h, d, ps, s_len = 2048, 8, 256, 64, 512
    n = (h + 2) * d
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127 * k**0.5)
    x = (torch.randn(b, k, generator=g, device=dev) * 3.0).to(act)
    norm = ((torch.randn(k, generator=g, device=dev) * 0.1).to(act), 1e-6)
    ang = torch.rand(b, d, generator=g, device=dev) * 6.28
    cos, sin = ang.cos().to(act), ang.sin().to(act)
    pos = torch.randint(0, 300, (b,), generator=g, device=dev, dtype=torch.int32)
    lora = None
    if bank:
        ids = torch.arange(b, device=dev).to(torch.int32) % 3
        a = (torch.randn(k, 3 * 24, generator=g, device=dev) * k**-0.5).to(act)
        lb = torch.randn(24, n, generator=g, device=dev) * 0.5
        lora = (t_lora.lora_shrink(x, a, ids, 8, 24, norm=norm), lb, (h * d, (h + 1) * d))
    table, shape = None, (b, s_len, d)
    if paged:
        table = (torch.randperm(b * 8, generator=g, device=dev).reshape(b, 8) + 1).to(torch.int32)
        shape = (b * 8 + 1, ps, d)

    def run(fn, cdtype):
        kc, vc = (torch.zeros(shape, dtype=cdtype, device=dev) for _ in range(2))
        kn, vn = (torch.empty(b, d, dtype=cdtype, device=dev) for _ in range(2))
        q, _, _ = fn(x, w8, s, cos, sin, pos, h, kc, vc, kn, vn, norm=norm, page_table=table,
                     lora=lora)
        return q, kc, vc, kn, vn

    form = getattr(t_gemv, "int8_gemv_rope_kv_cache_fp32" if act == torch.bfloat16
                   else "int8_gemv_rope_kv_fp32_cache_bf16")
    uniform = t_gemv.int8_gemv_rope_kv if act == torch.bfloat16 else t_gemv.int8_gemv_rope_kv_fp32
    n0, u0 = form.launches, uniform.launches
    got = run(t_gemv.int8_gemv_rope_kv, cache)
    assert form.launches == n0 + 1 and uniform.launches == u0
    same = run(t_gemv.int8_gemv_rope_kv, act)
    assert torch.equal(got[0], same[0])
    for mixed, one in zip(got[1:], same[1:]):
        assert mixed.dtype == cache and torch.equal(mixed, one.to(cache))
    for g_, w_ in zip(got, run(t_gemv.int8_gemv_rope_kv_reference, cache)):
        # a bf16 output may round either side of its plain value's tie
        assert _rel_err(g_, w_) <= _mixed_tol(act if g_.dtype == torch.float32 else torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("act,cache", MIXED)
@pytest.mark.parametrize("grp", [1, 8])
def test_split_attention_mixed_forms_dense_equals_paged_on_card(act, cache, grp):
    """3b's and B5's mixed forms against their plain versions (the window
    cast to q's dtype first) within the form's tolerance; bit for bit the
    uniform form on the cache converted to q's dtype (the tile is converted
    as it is staged: the same arithmetic); dense == paged bit for bit; a row
    with no visible key gives zeros; counted on the mixed forms. The fp32
    cache holds values bf16 cannot represent."""
    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(60 + grp)
    uniform = {torch.bfloat16: (t_dattn.decode_attention, t_paged.paged_decode_attention),
               torch.float32: (t_dattn.decode_attention_fp32,
                               t_paged.paged_decode_attention_fp32)}[act]
    forms = ((t_dattn.decode_attention_cache_fp32, t_paged.paged_decode_attention_cache_fp32)
             if act == torch.bfloat16 else
             (t_dattn.decode_attention_fp32_cache_bf16,
              t_paged.paged_decode_attention_fp32_cache_bf16))
    for b, d, ps, s_len, lens in ((3, 128, 16, 256, [37, 0, 80]),
                                  (8, 256, 64, 2048, [2048, 1, 700, 1500, 64, 65, 2000, 333])):
        q = torch.randn(b, grp, d, generator=g, device=dev).to(act)
        kc, vc = (torch.randn(b, s_len, d, generator=g, device=dev).to(cache) for _ in range(2))
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        valid = (torch.arange(s_len, device=dev)[None] < ln[:, None].long()).contiguous()
        n0, u0 = forms[0].launches, uniform[0].launches
        dense = t_dattn.decode_attention(q, kc, vc, valid, d**-0.5)
        assert forms[0].launches == n0 + 1 and uniform[0].launches == u0
        assert dense.dtype == act
        assert _rel_err(dense, t_dattn.decode_attention_reference(q, kc, vc, valid,
                                                                  d**-0.5)) <= _mixed_tol(act)
        assert torch.equal(dense, t_dattn.decode_attention(q, kc.to(act), vc.to(act), valid,
                                                           d**-0.5))
        if 0 in lens:
            assert torch.count_nonzero(dense[lens.index(0)]) == 0
        pool_k = kc.reshape(b * s_len // ps, ps, 1, d)
        pool_v = vc.reshape(b * s_len // ps, ps, 1, d)
        n_p = max(lens) // ps + 1
        tab = (torch.arange(n_p, device=dev)[None]
               + (s_len // ps) * torch.arange(b, device=dev)[:, None]).to(torch.int32)
        tab = torch.minimum(tab, torch.tensor(b * s_len // ps - 1, device=dev)).to(torch.int32)
        n0 = forms[1].launches
        paged = t_paged.paged_decode_attention(q, pool_k, pool_v, tab, ln, d**-0.5)
        assert forms[1].launches == n0 + 1
        assert torch.equal(paged, dense.reshape(b, grp, d))
        assert _rel_err(paged, t_paged.reference_paged_decode_attention(
            q, pool_k, pool_v, tab, ln, d**-0.5)) <= _mixed_tol(act)


@pytest.mark.cuda
@pytest.mark.parametrize("act,cache", MIXED)
def test_decode_attention_mixed_rows_per_cache_bits_on_card(act, cache):
    """The verify's dense attention over a cache of the other dtype: s query
    rows per cache row give the bits of the call on the cache rows repeated
    s times."""
    dev = _fp32_card()
    g = torch.Generator(device=dev).manual_seed(13)
    b, s, w, d = 3, 5, 200, 256
    kc, vc = (torch.randn(b, w, d, generator=g, device=dev).to(cache) for _ in range(2))
    q = torch.randn(b * s, 8, d, generator=g, device=dev).to(act)
    valid = torch.rand(b * s, w, generator=g, device=dev) < 0.6
    got = t_dattn.decode_attention(q, kc, vc, valid, d**-0.5, rows_per_cache=s)
    assert _rel_err(got, t_dattn.decode_attention_reference(q, kc, vc, valid, d**-0.5,
                                                            s)) <= _mixed_tol(act)
    rep = t_dattn.decode_attention(q, kc.repeat_interleave(s, 0).contiguous(),
                                   vc.repeat_interleave(s, 0).contiguous(), valid, d**-0.5)
    assert torch.equal(got, rep)


@pytest.mark.cuda
@pytest.mark.parametrize("act,cache", MIXED)
def test_mixed_cache_engines_on_card(act, cache):
    """Both mixed pairs end to end at a tiny MQA config: generate launches
    the mixed forms and no uniform form of the GEMV's cache write or the
    attention; the prefill logits are the uniform engine's bit for bit
    (prefill attends over the fresh k / v); bf16 over an fp32 cache gives
    the bf16 cache's tokens exactly (widening is exact); generate_spec ==
    generate; the dense and the paged serving engines give the same tokens,
    with spec_decode too."""
    import numpy as np

    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import ServingEngine
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    dev = _fp32_card()
    cfg, params, dq = _serving_model_fp32(dev) if act == torch.float32 else _serving_model(dev)
    eng = PaliGemmaEngine(params, cfg, max_seq_len=128, decode_params=dq, cache_dtype=cache)
    one = PaliGemmaEngine(params, cfg, max_seq_len=128, decode_params=dq)
    r = _serving_requests(cfg, 1)[0]
    ids = r.input_ids[None]
    px = torch.from_numpy(r.pixel_values[None]).to(dev)
    lk, _ = eng.prefill(px, ids, np.ones_like(ids))
    lu, _ = one.prefill(px, ids, np.ones_like(ids))
    assert torch.equal(lk, lu)
    kernels.reset_launch_counts()
    want = eng.generate(px, ids, np.ones_like(ids), max_new_tokens=40, eos_token_id=-1,
                        sync_every=8)
    counts = kernels.launch_counts()
    tag = "cache_fp32" if act == torch.bfloat16 else "fp32_cache_bf16"
    for name in (f"int8_gemv_rope_kv_{tag}", f"decode_attention_{tag}"):
        assert counts[name] > 0, name
    for name in ("int8_gemv_rope_kv", "int8_gemv_rope_kv_fp32", "decode_attention",
                 "decode_attention_fp32"):
        assert counts[name] == 0, name
    if act == torch.bfloat16:
        assert np.array_equal(want, one.generate(px, ids, np.ones_like(ids), max_new_tokens=40,
                                                 eos_token_id=-1, sync_every=8))
    got = eng.generate_spec(px, ids, np.ones_like(ids), max_new_tokens=40, eos_token_id=-1,
                            draft_k=6)
    assert np.array_equal(got, want)
    kw = dict(max_slots=3, max_seq_len=128, decode_params=dq, sync_every=4, cache_dtype=cache)
    dense = _served(ServingEngine(params, cfg, **kw), _serving_requests(cfg, 5))
    kernels.reset_launch_counts()
    paged = _served(PagedServingEngine(params, cfg, page_size=16, **kw),
                    _serving_requests(cfg, 5))
    assert kernels.launch_counts()[f"paged_decode_attention_{tag}"] > 0
    assert paged == dense
    for cls, extra in ((ServingEngine, {}), (PagedServingEngine, {"page_size": 16})):
        spec = _served(cls(params, cfg, spec_decode=True, spec_draft_k=5, **kw, **extra),
                       _serving_requests(cfg, 5))
        assert spec == dense
