"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode, as the JAX package's own tests do.
tests/test_torch_cuda.py holds the kernels against the plain versions on a
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import GemmaConfig
from paligemma_tpu.kernels import decode_head as j_head
from paligemma_tpu.kernels import decode_layer as j_layer
from paligemma_tpu.kernels import flash_attention as j_flash
from paligemma_tpu.kernels import quant as j_quant
from paligemma_tpu.models import gemma as j_gemma
from paligemma_tpu.ops import activations as j_act
from paligemma_tpu.ops import attention as j_attn
from paligemma_tpu.ops import rope as j_rope
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.kernels import decode_attention as t_dattn
from paligemma_tpu_torch.kernels import decode_head as t_head
from paligemma_tpu_torch.kernels import decode_layer as t_layer
from paligemma_tpu_torch.kernels import flash_attention as t_flash
from paligemma_tpu_torch.kernels import int8_gemv as t_gemv

torch.set_num_threads(2)


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- flash ----
@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,d,prefix_gap,q_offset",
    [
        (1, 16, 16, 2, 1, 64, 0, 0),     # MQA, tiny
        (2, 40, 40, 4, 2, 72, 0, 0),     # GQA, SigLIP head_dim 72
        (1, 300, 300, 8, 1, 256, 0, 0),  # Gemma-2B prefill shape
        (2, 64, 64, 4, 2, 64, 25, 0),    # prefix < kv_len: causal suffix
        (1, 32, 48, 4, 1, 64, 40, 13),   # queries start at position 13
    ],
)
def test_flash_attention_matches_pallas(b, sq, skv, hq, hkv, d, prefix_gap, q_offset):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    kv_len = np.array([skv - 3 - i for i in range(b)], np.int32)
    prefix = (kv_len - prefix_gap).astype(np.int32)
    want = _np(j_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(prefix), jnp.asarray(kv_len),
                                        q_offset=q_offset, block_q=128, block_k=128,
                                        interpret=True))
    got = t_flash.flash_attention(_t(q), _t(k), _t(v), _t(prefix), _t(kv_len),
                                  q_offset=q_offset).numpy()
    for i in range(b):
        rows = np.arange(sq) < kv_len[i]  # padded query rows are don't-care
        np.testing.assert_allclose(got[i][rows], want[i][rows], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,d,prefix_gap,q_offset",
    [
        (1, 16, 16, 2, 1, 64, 0, 0),     # MQA, tiny
        (2, 40, 40, 4, 2, 72, 0, 0),     # GQA, SigLIP head_dim 72
        (1, 300, 300, 8, 1, 256, 0, 0),  # Gemma-2B prefill shape
        (2, 64, 64, 4, 2, 64, 25, 0),    # prefix < kv_len: causal suffix
        (1, 32, 48, 4, 1, 64, 40, 13),   # queries start at position 13
        (2, 99, 99, 8, 2, 128, 30, 0),   # GQA: 64-row tiles straddle two heads
    ],
)
def test_flash_attention_bf16_matches_pallas(b, sq, skv, hq, hkv, d, prefix_gap, q_offset):
    """bf16 inputs: the port's forward (plain version on the CPU) against the
    Pallas forward in interpret mode. Both round p to bf16 before p·V (the
    TPU kernel against its running max, the plain version against the row's
    max): out within 1e-2 of max |JAX| over live rows (at most 3.1e-3
    measured), and the fp32 lse of flash_attention_with_lse within 1e-5
    (4.8e-7 measured)."""
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    kv_len = np.array([skv - 3 - i for i in range(b)], np.int32)
    prefix = (kv_len - prefix_gap).astype(np.int32)
    want, w_lse = j_flash._flash_forward(q, k, v, jnp.asarray(prefix), jnp.asarray(kv_len),
                                         d**-0.5, q_offset, 128, 128, True, return_lse=True)
    want = _np(want.astype(jnp.float32))
    sq_p = -(-sq // 128) * 128
    w_lse = np.asarray(w_lse)[:, :, : (hq // hkv) * sq_p, 0].reshape(b, hkv, hq // hkv, sq_p)
    w_lse = w_lse[..., :sq].reshape(b, hq, sq)

    def bf16(x):  # the same bf16 values on the torch side
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)

    tq, tk, tv = bf16(q), bf16(k), bf16(v)
    got = t_flash.flash_attention(tq, tk, tv, _t(prefix), _t(kv_len), q_offset=q_offset)
    _, lse = t_flash.flash_attention_with_lse(tq, tk, tv, _t(prefix), _t(kv_len),
                                              q_offset=q_offset)
    assert got.dtype == torch.bfloat16
    live = np.arange(sq)[None, :] < kv_len[:, None]  # (B, Sq): padded query rows are don't-care
    err = np.abs(got.float().numpy() - want)[live].max() / np.abs(want[live]).max()
    assert err < 1e-2, err
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[live],
                               w_lse.transpose(0, 2, 1)[live], rtol=1e-5, atol=1e-5)


def test_flash_attention_row_without_keys_is_zero():
    q = torch.ones(1, 4, 2, 8)
    k = torch.ones(1, 4, 1, 8)
    out = t_flash.flash_attention(q, k, k, torch.tensor([0], dtype=torch.int32),
                                  torch.tensor([0], dtype=torch.int32))
    assert torch.count_nonzero(out) == 0


# ------------------------------------------------------------ int8 gemv ----
@pytest.mark.parametrize("mode", ["plain", "residual", "geglu"])
def test_int8_gemv_plain_matches_jax_math(mode):
    rng = np.random.default_rng(1)
    b, k, n = 3, 64, 96
    x = rng.normal(size=(b, k)).astype(np.float32)
    q = j_quant.quantize_int8(jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)))
    w8, s = np.asarray(q["w8"]), np.asarray(q["s"])
    y = _np(jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w8).astype(jnp.float32),
                                (((1,), (0,)), ((), ())))) * s
    res = rng.normal(size=(b, n)).astype(np.float32)
    if mode == "plain":
        want, got = y, t_gemv.int8_gemv(_t(x), _t(w8), _t(s))
    elif mode == "residual":
        want, got = res + y, t_gemv.int8_gemv(_t(x), _t(w8), _t(s), residual=_t(res))
    else:  # the TPU kernel's GeGLU on fp32 gate/up (decode_layer.py:394-411)
        want = _np(j_act.gelu_tanh(jnp.asarray(y[:, : n // 2]))) * y[:, n // 2:]
        got = t_gemv.int8_gemv(_t(x), _t(w8), _t(s), geglu=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)  # fp32 dot order


# ------------------------------------------------------ decode attention ----
def test_decode_attention_plain_matches_gqa():
    rng = np.random.default_rng(2)
    b, h, d, s_len, w = 3, 4, 32, 40, 24
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, s_len, d)).astype(np.float32)
    vc = rng.normal(size=(b, s_len, d)).astype(np.float32)
    valid = rng.random((b, w)) < 0.6
    valid[:, 0] = True
    mask = j_attn.make_additive_mask(jnp.asarray(valid)[:, None, :])
    want = _np(j_attn.gqa(jnp.asarray(q)[:, None], jnp.asarray(kc[:, :w, None]),
                          jnp.asarray(vc[:, :w, None]), mask, scale=d**-0.5)).reshape(b, h * d)
    got = t_dattn.decode_attention(_t(q), _t(kc), _t(vc), _t(valid), d**-0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- decode layer ----
def _mqa_setup(seed=0):
    # the MQA / head_dim-128 config of tests/test_decode_layer.py
    cfg = GemmaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        head_dim=128, max_position_embeddings=128,
    )
    full = {"lm": j_gemma.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)}
    return cfg, j_qserve(full)["lm"]


def test_layers_decode_fused_matches_pallas():
    """fp32 on the int8 tree JAX quantized, B=2 rows at different cache
    positions with ragged validity: hidden state and fresh K/V to 1e-4
    relative; the port also wrote the fresh rows into its cache."""
    cfg, jlm = _mqa_setup()
    tlm = params_from_numpy(jax.tree.map(np.asarray, jlm), "cpu")
    rng = np.random.default_rng(3)
    n_layers, b, s_len, w, hd = 2, 2, 32, 16, 128
    x = rng.normal(size=(b, 1, cfg.hidden_size)).astype(np.float32)
    kc = (rng.normal(size=(n_layers, b, s_len, hd)) * 0.5).astype(np.float32)
    vc = (rng.normal(size=(n_layers, b, s_len, hd)) * 0.5).astype(np.float32)
    pos = np.array([7, 11], np.int32)
    valid = np.arange(w)[None] <= pos[:, None]
    valid[0, 3] = False  # a hole in row 0's window
    cos, sin = j_rope.rope_cos_sin(jnp.asarray(pos + 1)[:, None], hd)
    jh, jk, jv = j_layer.layers_decode_fused(
        jnp.asarray(x), j_layer.repack_layers(jlm["layers"]), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(pos), jnp.asarray(valid), cos[:, 0], sin[:, 0],
        w, cfg.num_attention_heads, hd, cfg.rms_norm_eps, interpret=True)
    tkc, tvc = _t(kc), _t(vc)
    assert t_layer.supported(cfg, tlm["layers"], b)
    th, tk, tv = t_layer.layers_decode_fused(
        _t(x), t_layer.repack_layers(tlm["layers"]), tkc, tvc, _t(pos), _t(valid),
        _t(np.asarray(cos[:, 0])), _t(np.asarray(sin[:, 0])), w,
        cfg.num_attention_heads, hd, cfg.rms_norm_eps)
    for got, want in ((th, jh), (tk, jk), (tv, jv)):
        want = _np(want)
        assert got.shape == want.shape
        assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) < 1e-4
    rows = torch.arange(b)
    assert torch.equal(tkc[:, rows, _t(pos).long()], tk)
    assert torch.equal(tvc[:, rows, _t(pos).long()], tv)


def test_rope_kv_write_plain_writes_rows():
    """The qkv GEMV's RoPE + KV write (int8_gemv_rope_kv, which replaced
    the separate rope_kv_write) on the CPU: its plain version's q, k and v
    against JAX's apply_rope on the same q|k|v (the GEMV of the normalized
    rows), the rows written at pos."""
    rng = np.random.default_rng(4)
    b, h, d, s_len, k = 2, 3, 32, 10, 24
    x = _t(rng.normal(size=(b, k)).astype(np.float32))
    w8 = torch.from_numpy(rng.integers(-127, 128, (k, (h + 2) * d), dtype=np.int8))
    s = _t((rng.random((h + 2) * d) * 0.02).astype(np.float32))
    norm = (_t(rng.normal(size=k).astype(np.float32) * 0.1), 1e-6)
    qkv = t_gemv.int8_gemv_reference(x, w8, s, norm=norm)
    pos = torch.tensor([4, 9], dtype=torch.int32)
    cos, sin = (t[:, 0] for t in j_rope.rope_cos_sin(jnp.asarray([[5], [10]]), d))
    kc, vc = torch.zeros(b, s_len, d), torch.zeros(b, s_len, d)
    kn, vn = torch.empty(b, d), torch.empty(b, d)
    q, _, _ = t_gemv.int8_gemv_rope_kv(x, w8, s, _t(cos), _t(sin), pos, h, kc, vc, kn, vn,
                                       norm=norm)
    x = np.asarray(qkv).reshape(b, 1, h + 2, d)
    want = _np(j_rope.apply_rope(jnp.asarray(x), cos[:, None], sin[:, None]))[:, 0]
    np.testing.assert_allclose(q.numpy(), want[:, :h], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(kn.numpy(), want[:, h], rtol=1e-6, atol=1e-6)
    assert torch.equal(vn, qkv[:, (h + 1) * d:])
    assert torch.equal(kc[torch.arange(b), pos.long()], kn)
    assert torch.equal(vc[torch.arange(b), pos.long()], vn)
    assert torch.count_nonzero(kc) == kn.numel()


# ------------------------------------------------------------ head argmax ----
def _head(k=128, v=1024, seed=0, dtype=jnp.bfloat16):
    kw, ky = jax.random.split(jax.random.PRNGKey(seed))
    w = jax.random.normal(kw, (k, v), jnp.float32) * 0.05
    q = j_quant.quantize_int8(w)
    y = (jax.random.normal(ky, (2, 1, k), jnp.float32) * 0.3).astype(dtype)
    return {"w8": np.array(q["w8"]), "s": np.array(q["s"])}, y


def _port(head, y):
    th = {"w8": _t(head["w8"]), "s": _t(head["s"])}
    ty = _t(y.astype(jnp.float32))
    return th, ty.to(torch.bfloat16) if y.dtype == jnp.bfloat16 else ty


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("seed,v", [(0, 1024), (1, 1024), (2, 1000)])
def test_head_argmax_matches_pallas(seed, v, dtype):
    """The head on bf16 y and (the fp32 form's plain version) on fp32 y,
    where the TPU kernel's rounding of the logits to y's dtype is the
    identity: ids equal the Pallas kernel's in interpret mode, the winning
    logit the max of the logits rounded to y's dtype."""
    head, y = _head(v=v, seed=seed, dtype=getattr(jnp, dtype))
    jhead = {"w8": jnp.asarray(head["w8"]), "s": jnp.asarray(head["s"])}
    want = np.asarray(j_head.head_argmax_fused(y, j_head.repack_head(jhead), interpret=True))
    th, ty = _port(head, y)
    assert ty.dtype == getattr(torch, dtype)
    packed = t_head.repack_head(th)
    assert packed["w8_blk"].shape[1] % t_gemv.TILE_N == 0
    got, mx = t_head.head_argmax_fused(ty, packed, return_max=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_head.reference_head_argmax(ty, th).numpy(), want)
    logits = (ty.float().reshape(2, -1) @ th["w8"].float() * th["s"]).to(ty.dtype).float()
    np.testing.assert_array_equal(mx.numpy(), logits.max(-1).values.numpy())


def test_head_argmax_planted_tie_goes_to_first_index():
    """Column 70 cloned into 300 and 900 (other 128-column tiles), with its
    scale raised so the three tie for the maximum: id 70 wins."""
    head, y = _head(v=1024, seed=3)
    for dup in (300, 900):
        head["w8"][:, dup] = head["w8"][:, 70]
    head["s"][70] *= 100.0
    head["s"][[300, 900]] = head["s"][70]
    jhead = {"w8": jnp.asarray(head["w8"]), "s": jnp.asarray(head["s"])}
    want = np.asarray(j_head.head_argmax_fused(y, j_head.repack_head(jhead, bs=256),
                                               interpret=True))
    th, ty = _port(head, y)
    got = t_head.head_argmax_fused(ty, t_head.repack_head(th)).numpy()
    np.testing.assert_array_equal(got, want)
    # rows whose column-70 logit is positive have it as the (tied) maximum
    pos_rows = (ty.float().reshape(2, -1) @ th["w8"][:, 70].float()).numpy() > 0
    assert pos_rows.any() and (got[pos_rows] == 70).all()
