"""paligemma_tpu_torch.kernels.ablation against paligemma_tpu.kernels.ablation
on the CPU: the same numpy inputs through the JAX function (Pallas in
interpret mode) and the port's plain path, which is what each wrapper runs
for a CPU tensor. Also siglip.encode(attn="fused") against JAX's, and the
two repairs that came with the port of these kernels (siglip's attn values,
PagedKVCache's default device)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import tiny_test_config
from paligemma_tpu.kernels.ablation import decode_attention as j_da
from paligemma_tpu.kernels.ablation import quant4 as j_q4
from paligemma_tpu.kernels.ablation import quant_pallas as j_qp
from paligemma_tpu.kernels.ablation import vision_attention as j_va
from paligemma_tpu.models import siglip as j_siglip
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.kernels.ablation import decode_attention as t_da
from paligemma_tpu_torch.kernels.ablation import quant4 as t_q4
from paligemma_tpu_torch.kernels.ablation import quant_pallas as t_qp
from paligemma_tpu_torch.kernels.ablation import vision_attention as t_va
from paligemma_tpu_torch.models import siglip
from paligemma_tpu_torch.runtime import paged_cache as t_cache

torch.set_num_threads(2)

# fp32: both sides compute the same fp32 function with reductions in another
# order (the JAX tests' own tolerance); bf16: the outputs round to bf16
# (2^-8 relative) after fp32 sums in another order
F32_TOL = 2e-5
BF16_TOL = 1e-2


def _pair(a: np.ndarray, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(a, jd), torch.from_numpy(a).to(dtype)


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# -- B12: vision-tower attention ---------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("shape", [(1, 256, 16, 72), (2, 128, 4, 72)])
def test_vision_attention_matches_jax(shape, dtype, tol):
    rng = np.random.default_rng(0)
    qkv = [_pair(rng.standard_normal(shape).astype(np.float32), dtype) for _ in range(3)]
    want = j_va.vision_attention(*(j for j, _ in qkv))
    got = t_va.vision_attention(*(t for _, t in qkv))
    assert got.shape == shape and got.dtype == dtype
    _close(got, want, tol)


def test_vision_attention_rejects_unaligned_seq_and_head_block():
    q = np.zeros((1, 100, 4, 64), np.float32)
    with pytest.raises(NotImplementedError):
        j_va.vision_attention(*(jnp.asarray(q),) * 3)
    with pytest.raises(NotImplementedError):
        t_va.vision_attention(*(torch.from_numpy(q),) * 3)
    x = torch.zeros(1, 128, 6, 8)
    with pytest.raises(ValueError):
        t_va.vision_attention(x, x, x, head_block=4)  # 4 does not divide 6


def _tiny_tower():
    """tiny_test_config's tower at 256 patches (32 px, patch 2; head_dim 8):
    the fused kernel needs S % 128 == 0 on both sides."""
    return dataclasses.replace(tiny_test_config().vision_config, image_size=32, patch_size=2)


def test_siglip_encode_fused_matches_jax():
    vcfg = _tiny_tower()
    jp = j_siglip.init_params(jax.random.PRNGKey(0), vcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pixels = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = j_siglip.encode(jp, vcfg, jnp.asarray(pixels), attn="fused")
    got = siglip.encode(tp, vcfg, torch.from_numpy(pixels), attn="fused")
    assert got.shape == (2, 256, vcfg.hidden_size)
    # fp32 through two layers and the final LayerNorm (unit-scale features)
    _close(got, want, 1e-4)
    plain = siglip.encode(tp, vcfg, torch.from_numpy(pixels), attn="xla")
    _close(got, plain.numpy(), 1e-4)


def test_siglip_encode_rejects_unknown_attn():
    vcfg = _tiny_tower()
    jp = j_siglip.init_params(jax.random.PRNGKey(0), vcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with pytest.raises(ValueError, match="attn"):
        siglip.encode(tp, vcfg, torch.zeros(1, 3, 32, 32), attn="fussed")


def test_paged_cache_defaults_to_the_card():
    """Without ``device`` the pool is made on CUDA, never quietly on the CPU
    (here, with no CUDA build of torch, making it raises)."""
    tcfg = tiny_test_config().text_config
    cpu = t_cache.PagedKVCache(tcfg, n_pages=4, page_size=16, max_slots=1,
                               max_pages_per_slot=2, device="cpu")
    assert cpu.pool["k"].device.type == "cpu"
    if torch.cuda.is_available():
        c = t_cache.PagedKVCache(tcfg, n_pages=4, page_size=16, max_slots=1,
                                 max_pages_per_slot=2)
        assert c.pool["k"].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            t_cache.PagedKVCache(tcfg, n_pages=4, page_size=16, max_slots=1,
                                 max_pages_per_slot=2)


# -- B10: length-aware decode attention ---------------------------------------


def _decode_inputs(b, s_max, hq, hkv, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(shape).astype(np.float32), dtype)
            for shape in ((b, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d))]


def _segs(*rows):
    return [(jnp.asarray(r, jnp.int32), torch.tensor(r, dtype=torch.int32)) for r in rows]


def _decode_both(qkv, segs):
    want = j_da.decode_attention(*(j for j, _ in qkv), *(j for j, _ in segs))
    ref = j_da.reference_decode_attention(*(j for j, _ in qkv), *(j for j, _ in segs))
    got = t_da.decode_attention(*(t for _, t in qkv), *(t for _, t in segs))
    return got, want, ref


@pytest.mark.parametrize("hq,hkv", [(8, 1), (8, 2), (4, 4)])
def test_decode_attention_contiguous_matches_jax(hq, hkv):
    qkv = _decode_inputs(3, 256, hq, hkv, 128, seed=0)
    kv_len = [5, 200, 256]
    got, want, ref = _decode_both(qkv, _segs(kv_len, kv_len, kv_len))
    assert got.shape == (3, hq, 128)
    _close(got, want, F32_TOL)
    _close(got, ref, F32_TOL)


def test_decode_attention_pad_hole_matches_jax():
    """Prompt [0, seg0), pad hole [seg0, seg1), decode window [seg1, kv_len)."""
    qkv = _decode_inputs(2, 128, 8, 2, 128, seed=1)
    segs = _segs([10, 20], [20, 20], [25, 25])
    got, want, _ = _decode_both(qkv, segs)
    _close(got, want, F32_TOL)


def test_decode_attention_poisoned_hole_changes_nothing():
    qkv = _decode_inputs(2, 128, 8, 2, 128, seed=1)
    segs = _segs([10, 20], [20, 20], [25, 25])
    clean = t_da.decode_attention(*(t for _, t in qkv), *(t for _, t in segs))
    q, k, v = (t.clone() for _, t in qkv)
    k[0, 10:20] = 1e4
    v[0, 10:20] = -1e4
    poisoned = t_da.decode_attention(q, k, v, *(t for _, t in segs))
    _close(poisoned, clean.numpy(), F32_TOL)
    jq, jk, jv = (j for j, _ in qkv)
    want = j_da.decode_attention(jq, jk.at[0, 10:20].set(1e4), jv.at[0, 10:20].set(-1e4),
                                 *(j for j, _ in segs))
    _close(poisoned, want, F32_TOL)


def test_decode_attention_bf16_close():
    qkv = _decode_inputs(2, 256, 8, 1, 256, seed=3, dtype=torch.bfloat16)
    kv_len = [100, 256]
    got, want, _ = _decode_both(qkv, _segs(kv_len, kv_len, kv_len))
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)  # the JAX test's own bf16 tolerance


def test_decode_attention_supported_and_block_k():
    assert t_da.supported(2048, 256) and t_da.supported(100, 72)
    assert not t_da.supported(512, 260) and not t_da.supported(512, 100)
    (q, k, v) = (t for _, t in _decode_inputs(1, 96, 8, 1, 64, seed=4))
    n = torch.tensor([50], dtype=torch.int32)
    with pytest.raises(ValueError, match="block_k"):
        t_da.decode_attention(q, k, v, n, n, n, block_k=64)  # 64 does not divide 96


# -- B9: int4 weight-only matmul ----------------------------------------------


def test_quantize_int4_bits_equal_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 64, 48)).astype(np.float32)  # stacked (L, K, N)
    jq = j_q4.quantize_int4(jnp.asarray(w))
    tq = t_q4.quantize_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(tq["w4p"].numpy(), np.asarray(jq["w4p"]))
    np.testing.assert_array_equal(tq["s"].numpy(), np.asarray(jq["s"]))
    np.testing.assert_array_equal(t_q4.dequantize_int4(tq).numpy(),
                                  np.asarray(j_q4.dequantize_int4(jq)))


@pytest.mark.parametrize("m,k,n", [(1, 64, 96), (4, 256, 200), (16, 512, 384)])
def test_int4_matmul_matches_jax(m, k, n):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq = j_q4.quantize_int4(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.2))
    want = j_q4.int4_matmul(jnp.asarray(x), jq["w4p"], jq["s"])
    got = t_q4.int4_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(jq["w4p"])),
                           torch.from_numpy(np.asarray(jq["s"])))
    assert got.shape == (m, n)
    _close(got, want, 1e-4)  # the JAX test's tolerance: fp32 sums over K


@pytest.mark.parametrize("m", [8, 17, 266])
def test_int4_matmul_reference_matches_jax_at_the_kernels_rows(m):
    """The plain version the card's kernels are held to (the GEMV tile's int4
    form at M <= 16, csrc/wq_wgmma.cuh above) against the TPU kernel in
    interpret mode, at a stored-row count of 128 and a column count that is
    not a multiple of the 128-column tile."""
    rng = np.random.default_rng(m)
    k, n = 256, 208
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq = j_q4.quantize_int4(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.2))
    want = j_q4.int4_matmul(jnp.asarray(x), jq["w4p"], jq["s"], interpret=True)
    got = t_q4.int4_matmul_reference(torch.from_numpy(x),
                                     torch.from_numpy(np.asarray(jq["w4p"])),
                                     torch.from_numpy(np.asarray(jq["s"])))
    assert got.shape == (m, n)
    _close(got, want, 1e-4)  # the JAX test's tolerance: fp32 sums over K


def test_int4_matmul_bf16_and_lead_dims():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    jq = j_q4.quantize_int4(jnp.asarray(rng.standard_normal((256, 128)).astype(np.float32)))
    want = j_q4.int4_matmul(jnp.asarray(x, jnp.bfloat16), jq["w4p"], jq["s"])
    got = t_q4.int4_matmul(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(np.asarray(jq["w4p"])),
                           torch.from_numpy(np.asarray(jq["s"])))
    assert got.shape == (2, 3, 128) and got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


# -- B11: int8 dequant matmuls ------------------------------------------------


def _int8_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.1
    return x, w


@pytest.mark.parametrize("m,k,n", [(3, 256, 128), (17, 320, 200)])
def test_int8_matmul_matches_jax(m, k, n):
    x, w = _int8_case(m, k, n, seed=m)
    jq = j_qp.quantize_int8(jnp.asarray(w))
    want = j_qp.int8_matmul(jnp.asarray(x), jq["w8"], jq["s"])
    got = t_qp.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(jq["w8"])),
                           torch.from_numpy(np.asarray(jq["s"])))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("m,k,n", [(3, 256, 128), (17, 320, 200)])
def test_int8_matmul_nmajor_matches_jax(m, k, n):
    x, w = _int8_case(m, k, n, seed=m + 1)
    jq = j_qp.quantize_int8_nmajor(jnp.asarray(w))
    tq = t_qp.quantize_int8_nmajor(torch.from_numpy(w))
    # the layout is JAX's; the values are kernels/quant.quantize_int8's,
    # whose scale may differ from jitted JAX's by an ulp (test_torch_quant)
    assert tq["w8t"].shape == (n, k) and tq["w8t"].is_contiguous()
    np.testing.assert_allclose(tq["s"].numpy(), np.asarray(jq["s"]), rtol=1e-6)
    diff = np.abs(tq["w8t"].numpy().astype(np.int32) - np.asarray(jq["w8t"], np.int32))
    assert diff.max() <= 1 and diff.mean() < 1e-3
    want = j_qp.int8_matmul_nmajor(jnp.asarray(x), jq["w8t"], jq["s"])
    got = t_qp.int8_matmul_nmajor(torch.from_numpy(x), torch.from_numpy(np.asarray(jq["w8t"])),
                                  torch.from_numpy(np.asarray(jq["s"])))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("kernel", ["int8_matmul", "int8_matmul_nmajor", "int4_matmul"])
@pytest.mark.parametrize("m", [16, 17, 65])
def test_wq_matmul_boundary_rows_match_jax(kernel, m):
    """B9 and B11 at the rows where the card's plan changes route or tile:
    16 (the last decode row), 17 (the first wgmma row, 64-row tiles) and 65
    (the first 128-row tile), against the TPU kernels in interpret mode, at
    a stored-row count of 128 and a column count that is not a multiple of
    the 128-column tile."""
    k, n = 256, 208
    x, w = _int8_case(m, k, n, seed=m + len(kernel))
    if kernel == "int4_matmul":
        jq = j_q4.quantize_int4(jnp.asarray(w))
        want = j_q4.int4_matmul(jnp.asarray(x), jq["w4p"], jq["s"], interpret=True)
        got = t_q4.int4_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(jq["w4p"])),
                               torch.from_numpy(np.asarray(jq["s"])))
    elif kernel == "int8_matmul":
        jq = j_qp.quantize_int8(jnp.asarray(w))
        want = j_qp.int8_matmul(jnp.asarray(x), jq["w8"], jq["s"], interpret=True)
        got = t_qp.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(jq["w8"])),
                               torch.from_numpy(np.asarray(jq["s"])))
    else:
        jq = j_qp.quantize_int8_nmajor(jnp.asarray(w))
        want = j_qp.int8_matmul_nmajor(jnp.asarray(x), jq["w8t"], jq["s"], interpret=True)
        got = t_qp.int8_matmul_nmajor(torch.from_numpy(x),
                                      torch.from_numpy(np.asarray(jq["w8t"])),
                                      torch.from_numpy(np.asarray(jq["s"])))
    assert got.shape == (m, n)
    _close(got, want, 1e-4)  # the JAX tests' tolerance: fp32 sums over K


@pytest.mark.parametrize("nmajor", [False, True])
def test_int8_matmul_diffable_dx_matches_jax_grad(nmajor):
    """dx of the autograd Functions against jax.grad of the custom-VJP
    wrappers, for a fixed cotangent: dx = (g * s) @ w8^T, no weight grad."""
    x, w = _int8_case(5, 128, 96, seed=7)
    g = np.random.default_rng(8).standard_normal((5, 96)).astype(np.float32)
    if nmajor:
        jq = j_qp.quantize_int8_nmajor(jnp.asarray(w))
        jfn, tfn, key = j_qp._int8_matmul_nmajor_diffable, t_qp._int8_matmul_nmajor_diffable, "w8t"
    else:
        jq = j_qp.quantize_int8(jnp.asarray(w))
        jfn, tfn, key = j_qp._int8_matmul_diffable, t_qp._int8_matmul_diffable, "w8"
    tq = {name: torch.from_numpy(np.asarray(a)) for name, a in jq.items()}
    want = jax.grad(lambda a: jnp.sum(jfn(a, jq[key], jq["s"]) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tfn(xt, tq[key], tq["s"])
    out.backward(torch.from_numpy(g))
    _close(out.detach(), jfn(jnp.asarray(x), jq[key], jq["s"]), 1e-4)
    _close(xt.grad, want, 1e-4)
