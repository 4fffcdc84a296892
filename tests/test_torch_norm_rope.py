"""The decode layer's RMSNorm as the int8 GEMV's prologue and its RoPE +
KV write as the qkv GEMV's epilogue (kernels/int8_gemv ``norm=``,
``int8_gemv_rope_kv``), on the CPU.

* The RoPE epilogue's pairing map (kernels/gemv_plan ``rope_quad_col``,
  ``epilogue_share``, the mirror of csrc/int8_gemv.cu mode 4): every qkv
  column is read exactly once, and columns j and j + D/2 of a head share a
  tile and a cluster rank's share, at Gemma-2B's heads and one TP rank's.
* The fused wrappers' plain versions equal, bit for bit, the chain they
  replace (ops/norms.rms_norm -> int8_gemv_reference -> the plain RoPE +
  cache write), dense and paged, with and without a LoRA bank.
* One decode layer through the new wrappers against the JAX package's
  ``layers_decode_fused`` and ``layers_decode_fused_paged`` (Pallas in
  interpret mode), at the tolerance of the whole-chain tests
  (tests/test_torch_kernels.py, tests/test_torch_paged.py: 1e-4 relative in
  fp32).

The kernels themselves run on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import GemmaConfig
from paligemma_tpu.kernels import decode_layer as j_layer
from paligemma_tpu.kernels import decode_layer_paged as j_dlp
from paligemma_tpu.models import gemma as j_gemma
from paligemma_tpu.ops import rope as j_rope
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.kernels import decode_attention as t_dattn
from paligemma_tpu_torch.kernels import decode_elementwise as t_el
from paligemma_tpu_torch.kernels import decode_mlp as t_mlp
from paligemma_tpu_torch.kernels import gemv_plan as t_plan
from paligemma_tpu_torch.kernels import int8_gemv as t_gemv
from paligemma_tpu_torch.kernels import lora as t_lora
from paligemma_tpu_torch.kernels import paged_attention as t_pa
from paligemma_tpu_torch.ops.norms import rms_norm

torch.set_num_threads(2)

HIDDEN, HEADS = 2048, 8


# ------------------------------------------------------------ pairing map ----
def _tile_columns(tile, hl, d):
    """The 128 weight columns tile-local columns 0..127 of the RoPE tile
    hold (quad q's 16 columns from rope_quad_col; None past the last pair)."""
    cols = []
    for quad in range(8):
        c0 = t_plan.rope_quad_col(tile, quad, hl, d)
        cols += [None] * 16 if c0 is None else list(range(c0, c0 + 16))
    return cols


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_rope_pairing_reads_each_column_once_and_keeps_pairs(d, m):
    """qkv over Hl = H/m local query heads + k + v: every column is read by
    exactly one quad of one tile; tile-local column c < 64 and c + 64 are
    j and j + D/2 of one head; each cluster rank of the plan of (K, N)
    finishes whole pairs, the ranks' shares partition the tile's 64."""
    hl = HEADS // m
    n, half = (hl + 2) * d, d // 2
    tiles = -(-n // t_plan.TILE_N)  # 64 pairs a tile: N / 128 tiles
    seen = []
    for tile in range(tiles):
        cols = _tile_columns(tile, hl, d)
        seen += [c for c in cols if c is not None]
        for c in range(64):
            lo, hi = cols[c], cols[c + 64]
            assert (lo is None) == (hi is None)
            if lo is not None:
                assert lo % d < half and hi == lo + half and lo // d == hi // d
                assert lo // d < hl + 2
    assert sorted(seen) == list(range(n))
    cluster = t_plan.GemvPlan.make(HIDDEN, n).cluster
    shares = t_plan.epilogue_share(cluster)
    covered = [c for lo, hi in shares for c in range(lo, hi)]
    assert covered == list(range(64))  # each pair once, whole, by one rank


@pytest.mark.parametrize("d", [32, 128, 256])
def test_rope_quads_read_sixteen_columns_of_one_half(d):
    """A quad's 16 columns (one 16-byte load a weight row) lie inside one
    head's half (D/2 a multiple of 16), so they are contiguous."""
    hl, half = HEADS, d // 2
    for tile in range(-(-(hl + 2) * d // t_plan.TILE_N)):
        for quad in range(8):
            c0 = t_plan.rope_quad_col(tile, quad, hl, d)
            if c0 is not None:
                assert (c0 % d) // half == (c0 + 15) % d // half and c0 // d == (c0 + 15) // d


# ---------------------------------------------- plain versions == chain ----
def _operands(seed, b, k, hl, d, dtype):
    rng = np.random.default_rng(seed)
    n = (hl + 2) * d
    x = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32) * 2).to(dtype)
    w8 = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    s = torch.from_numpy((rng.random(n, dtype=np.float32) + 0.5) / (127 * k**0.5))
    wn = torch.from_numpy(rng.normal(size=k).astype(np.float32) * 0.1).to(dtype)
    ang = rng.random((b, d), dtype=np.float32) * 6.28
    cos, sin = (torch.from_numpy(f(ang)).to(dtype) for f in (np.cos, np.sin))
    pos = torch.from_numpy(np.array([5 + 13 * i for i in range(b)], np.int32))
    return x, w8, s, (wn, 1e-6), cos, sin, pos


def _bank(seed, b, k, n, bounds, dtype):
    rng = np.random.default_rng(seed)
    gcols, rank = 16, 4
    a = torch.from_numpy(rng.normal(size=(k, (len(bounds) + 1) * gcols)).astype(np.float32))
    lb = torch.from_numpy(rng.normal(size=(gcols, n)).astype(np.float32) * 0.5)
    ids = torch.from_numpy((np.arange(b) % 3).astype(np.int32))
    return a * k**-0.5, lb, ids, rank, gcols


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bank", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_int8_gemv_rope_kv_plain_equals_the_chain(paged, bank, dtype):
    """int8_gemv_rope_kv on CPU tensors is the chain it replaced, bit for
    bit: rms_norm -> int8_gemv_reference (plus the expand of the shrink of
    the same normalized rows) -> rope_kv_write(_paged)_reference; the
    cache rows (or pool slots) hold the same bits."""
    b, k, hl, d, s_len, ps = 3, 64, 2, 32, 48, 16
    x, w8, s, norm, cos, sin, pos = _operands(1, b, k, hl, d, dtype)
    n = w8.shape[1]
    lora = None
    table = torch.tensor([[3, 1, 5], [2, 0, 0], [4, 6, 7]], dtype=torch.int32)
    if bank:
        a, lb, ids, rank, gcols = _bank(2, b, k, n, (hl * d, (hl + 1) * d), dtype)
        z = t_lora.lora_shrink(x, a, ids, rank, gcols, norm=norm)
        assert torch.equal(z, t_lora.lora_shrink_reference(rms_norm(x, *norm), a, ids, rank,
                                                           gcols))
        lora = (z, lb, (hl * d, (hl + 1) * d))
    shape = (8, ps, d) if paged else (b, s_len, d)
    dst = [torch.zeros(shape, dtype=dtype) for _ in range(4)]
    new = [torch.empty(b, d, dtype=dtype) for _ in range(4)]
    n0 = t_gemv.int8_gemv_rope_kv.launches
    got = t_gemv.int8_gemv_rope_kv(x, w8, s, cos, sin, pos, hl, dst[0], dst[1], new[0], new[1],
                                   norm=norm, page_table=table if paged else None, lora=lora)
    assert t_gemv.int8_gemv_rope_kv.launches == n0  # the plain version launches nothing
    qkv = t_gemv.int8_gemv_reference(rms_norm(x, *norm), w8, s, lora=lora)
    if paged:
        want = t_el.rope_kv_write_paged_reference(qkv, cos, sin, pos, hl, dst[2], dst[3], table,
                                                  new[2], new[3])
    else:
        want = t_el.rope_kv_write_reference(qkv, cos, sin, pos, hl, dst[2], dst[3], new[2],
                                            new[3])
    assert got[0].shape == (b, hl, d)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert torch.equal(dst[0], dst[2]) and torch.equal(dst[1], dst[3])
    assert torch.count_nonzero(dst[0]) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [{}, {"geglu": True}, {"bank": True}])
def test_int8_gemv_and_mlp_with_norm_equal_the_chain(kw, dtype):
    """int8_gemv(norm=) and mlp_decode_fused(norm=) on CPU tensors are
    rms_norm followed by the plain GEMV / MLP, bit for bit (with a bank:
    the shrink and the expand of the same normalized rows)."""
    b, k, n = 3, 64, 96
    x, w8, s, norm, *_ = _operands(3, b, k, 1, 32, dtype)
    w8 = w8[:, :n].contiguous()
    s = s[:n].contiguous()
    y = rms_norm(x, *norm)
    lora = None
    if kw.get("bank"):
        a, lb, ids, rank, gcols = _bank(4, b, k, n, (), dtype)
        lora = (t_lora.lora_shrink(x, a, ids, rank, gcols, norm=norm), lb, ())
    geglu = kw.get("geglu", False)
    got = t_gemv.int8_gemv(x, w8, s, geglu=geglu, lora=lora, norm=norm)
    assert torch.equal(got, t_gemv.int8_gemv_reference(y, w8, s, geglu=geglu, lora=lora))
    mlp = {"gateup": {"w8": w8[None], "s": s[None]},
           "down": {"w8": w8[:n // 2, :k][None].contiguous(), "s": s[:k][None].contiguous()}}
    for out_dtype in (None, torch.float32):
        got = t_mlp.mlp_decode_fused(x, mlp, 0, out_dtype=out_dtype, norm=norm)
        assert torch.equal(got, t_mlp.reference_mlp(y, mlp, 0, out_dtype=out_dtype))


# --------------------------------------------- one layer against Pallas ----
def _one_layer_lm(seed=0):
    cfg = GemmaConfig(vocab_size=256, hidden_size=128, intermediate_size=512,
                      num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=1,
                      head_dim=128, max_position_embeddings=128)
    full = {"lm": j_gemma.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)}
    jlm = j_qserve(full)["lm"]
    return cfg, jlm, params_from_numpy(jax.tree.map(np.asarray, jlm), "cpu")


def _port_layer(h, lay, eps, n_heads, hd, rope, dst, attend):
    """One decode layer through the new wrappers: the qkv GEMV with the
    input norm and the RoPE + KV write, attention, o + residual, gate/up
    with the post-attention norm and the GeGLU, down + residual."""
    attn, mlp = lay["attn"], lay["mlp"]
    b = h.shape[0]
    k_new, v_new = torch.empty(b, hd), torch.empty(b, hd)
    q, _, _ = t_gemv.int8_gemv_rope_kv(h, attn["qkv"]["w8"][0], attn["qkv"]["s"][0], *rope,
                                       n_heads, dst[0], dst[1], k_new, v_new,
                                       norm=(lay["input_norm"][0], eps), page_table=dst[2])
    a = attend(q).reshape(b, -1)
    h = t_gemv.int8_gemv(a, attn["o"]["w8"][0], attn["o"]["s"][0], residual=h)
    t = t_gemv.int8_gemv(h, mlp["gateup"]["w8"][0], mlp["gateup"]["s"][0], geglu=True,
                         norm=(lay["post_norm"][0], eps))
    h = t_gemv.int8_gemv(t, mlp["down"]["w8"][0], mlp["down"]["s"][0], residual=h)
    return h, k_new, v_new


def _close(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) < tol


def test_one_decode_layer_matches_pallas():
    """fp32, the int8 tree JAX quantized, B=2 rows at different cache
    positions with a hole in row 0's window: hidden state and fresh K/V
    within 1e-4 relative of the TPU kernel in interpret mode."""
    cfg, jlm, tlm = _one_layer_lm()
    rng = np.random.default_rng(7)
    b, s_len, w, hd, nh = 2, 32, 16, 128, cfg.num_attention_heads
    x = rng.normal(size=(b, 1, cfg.hidden_size)).astype(np.float32)
    kc = (rng.normal(size=(1, b, s_len, hd)) * 0.5).astype(np.float32)
    vc = (rng.normal(size=(1, b, s_len, hd)) * 0.5).astype(np.float32)
    pos = np.array([7, 11], np.int32)
    valid = np.arange(w)[None] <= pos[:, None]
    valid[0, 3] = False
    cos, sin = j_rope.rope_cos_sin(jnp.asarray(pos + 1)[:, None], hd)
    jh, jk, jv = j_layer.layers_decode_fused(
        jnp.asarray(x), j_layer.repack_layers(jlm["layers"]), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos), jnp.asarray(valid), cos[:, 0], sin[:, 0], w, nh, hd, cfg.rms_norm_eps,
        interpret=True)
    tkc, tvc = torch.from_numpy(kc[0].copy()), torch.from_numpy(vc[0].copy())
    rope = (torch.from_numpy(np.array(cos[:, 0])), torch.from_numpy(np.array(sin[:, 0])),
            torch.from_numpy(pos))
    tvalid = torch.from_numpy(valid)
    h, k_new, v_new = _port_layer(
        torch.from_numpy(x[:, 0]), tlm["layers"], cfg.rms_norm_eps, nh, hd, rope,
        (tkc, tvc, None), lambda q: t_dattn.decode_attention(q, tkc, tvc, tvalid, hd**-0.5))
    _close(h, np.asarray(jh)[:, 0])
    _close(k_new, np.asarray(jk)[0])
    _close(v_new, np.asarray(jv)[0])
    rows = torch.arange(b)
    assert torch.equal(tkc[rows, torch.from_numpy(pos).long()], k_new)


@pytest.mark.parametrize("frag", [False, True])
def test_one_paged_decode_layer_matches_pallas(frag):
    """The same layer over a page pool (page size 16, a fragmented table or
    not): hidden state and fresh K/V within 1e-4 relative of the paged TPU
    kernel in interpret mode; the fresh rows sit in their slots."""
    cfg, jlm, tlm = _one_layer_lm(1)
    rng = np.random.default_rng(8)
    b, ps, hd, n_pages, pb, nh = 2, 16, 128, 8, 2, cfg.num_attention_heads
    x = rng.normal(size=(b, 1, cfg.hidden_size)).astype(np.float32)
    kp = (rng.normal(size=(1, n_pages, ps, hd)) * 0.5).astype(np.float32)
    vp = (rng.normal(size=(1, n_pages, ps, hd)) * 0.5).astype(np.float32)
    table = np.array([[5, 2, 0, 0], [7, 3, 0, 0]] if frag else [[1, 2, 0, 0], [3, 4, 0, 0]],
                     np.int32)
    pos = np.array([5, 17], np.int32)
    cos, sin = j_rope.rope_cos_sin(jnp.asarray(pos + 1)[:, None], hd)
    jh, jk, jv = j_dlp.layers_decode_fused_paged(
        jnp.asarray(x), j_layer.repack_layers(jlm["layers"]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table[:, :pb]), jnp.asarray(pos), cos[:, 0], sin[:, 0], nh, hd,
        cfg.rms_norm_eps, interpret=True)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ttab, tpos = torch.from_numpy(table), torch.from_numpy(pos)
    rope = (torch.from_numpy(np.array(cos[:, 0])), torch.from_numpy(np.array(sin[:, 0])), tpos)
    h, k_new, v_new = _port_layer(
        torch.from_numpy(x[:, 0]), tlm["layers"], cfg.rms_norm_eps, nh, hd, rope,
        (tkp[0], tvp[0], ttab),
        lambda q: t_pa.paged_decode_attention(q, tkp[:, :, :, None], tvp[:, :, :, None],
                                              ttab[:, :pb], tpos + 1, hd**-0.5, layer_idx=0))
    _close(h, np.asarray(jh)[:, 0])
    _close(k_new, np.asarray(jk)[0])
    _close(v_new, np.asarray(jv)[0])
    for r in range(b):
        assert torch.equal(tkp[0, table[r, pos[r] // ps], pos[r] % ps], k_new[r])
