"""paligemma_tpu_torch int8 weight-only quantization against
paligemma_tpu.kernels.quant / runtime.quantize (CPU, seeded numpy inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import GemmaConfig
from paligemma_tpu.kernels import quant as j_quant
from paligemma_tpu.models import gemma as j_gemma
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.kernels import quant
from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 40)])
def test_quantize_int8_matches_at_dequant_tolerance(shape):
    """JAX quantizes under jit and may differ from eager math by 1 ulp in
    the scale (paligemma_tpu/kernels/quant.py:67-68), which can move a
    rounding boundary by one step: dequantized weights agree to one
    quantization step (scale) and scales to 1e-6 relative."""
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = quant.quantize_int8(torch.from_numpy(w))
    want = j_quant.quantize_int8(jnp.asarray(w))
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]), rtol=1e-6)
    diff = np.abs(got["w8"].numpy().astype(np.int32) - np.asarray(want["w8"]).astype(np.int32))
    assert diff.max() <= 1
    assert diff.mean() < 1e-3
    deq = quant.dequantize(got).numpy()
    step = np.asarray(want["s"])[..., None, :]
    assert np.all(np.abs(deq - w) <= 0.5 * step + 1e-7)


def test_quantize_int8_chunked_equals_unchunked():
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 16, 300)).astype(np.float32))
    whole = quant.quantize_int8(w)
    stacked = quant.quantize_int8(w, chunk_elems=1000)
    cols = quant.quantize_int8(w[0], chunk_elems=1000)
    assert torch.equal(whole["w8"], stacked["w8"]) and torch.equal(whole["s"], stacked["s"])
    assert torch.equal(whole["w8"][0], cols["w8"]) and torch.equal(whole["s"][0], cols["s"])


def test_matmul_any_on_jax_quantized_weights():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 40)).astype(np.float32)
    jq = j_quant.quantize_int8(jnp.asarray(w))
    tq = params_from_numpy(_np_tree(jq), "cpu")
    want = np.asarray(j_quant.matmul_any(jnp.asarray(x), jq))
    got = quant.matmul_any(torch.from_numpy(x), tq).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # fp32 dot order
    dense = quant.matmul_any(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(dense, x @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_kv,dtype", [(1, jnp.float32), (2, jnp.bfloat16)])
def test_quantize_lm_for_serving_matches(n_kv, dtype):
    cfg = GemmaConfig(vocab_size=96, hidden_size=32, intermediate_size=48,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=n_kv, head_dim=16)
    jp = {"lm": j_gemma.init_params(jax.random.PRNGKey(n_kv), cfg, dtype)}
    want = _np_tree(j_qserve(jp))
    got = quantize_lm_for_serving(params_from_numpy(_np_tree(jp), "cpu"))
    flat_w, tree_w = jax.tree.flatten(want)
    def to_np(t):  # bf16 tensors come back as ml_dtypes bf16 arrays
        return t.float().numpy().astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else t.numpy()

    flat_g, tree_g = jax.tree.flatten(jax.tree.map(to_np, got))
    assert tree_w == tree_g
    for a, b in zip(flat_w, flat_g):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.int8:  # one rounding step at most (see above)
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        else:  # bf16 leaves compare through fp32
            np.testing.assert_allclose(b.astype(np.float32), a.astype(np.float32), rtol=1e-6)
