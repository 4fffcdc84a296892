"""paligemma_tpu_torch.ops against paligemma_tpu.ops on the same seeded
numpy inputs (fp32, CPU). Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.ops import activations as j_act
from paligemma_tpu.ops import attention as j_attn
from paligemma_tpu.ops import norms as j_norms
from paligemma_tpu.ops import rope as j_rope
from paligemma_tpu.ops import sampling as j_sampling
from paligemma_tpu_torch.ops import activations, attention, norms, rope, sampling

torch.set_num_threads(2)

RTOL = ATOL = 1e-5  # fp32 elementwise math, reordered reductions only


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_and_layer_norm():
    rng = _rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32) * 0.1
    bias = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        norms.rms_norm(_t(x), _t(w)).numpy(),
        np.asarray(j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        norms.layer_norm(_t(x), _t(w), _t(bias)).numpy(),
        np.asarray(j_norms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))),
        rtol=RTOL, atol=ATOL)


def test_rope_half_split():
    rng = _rng(1)
    pos = rng.integers(1, 300, size=(2, 7)).astype(np.int32)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    cos, sin = rope.rope_cos_sin(_t(pos), 16)
    jcos, jsin = j_rope.rope_cos_sin(jnp.asarray(pos), 16)
    # positions up to 300 rad: fp32 cos/sin of large arguments, 1e-4
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-4)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-4)
    got = rope.apply_rope(_t(x), cos, sin).numpy()
    want = np.asarray(j_rope.apply_rope(jnp.asarray(x), jcos, jsin))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_gelu_tanh():
    x = _rng(2).normal(size=(1000,)).astype(np.float32) * 4
    np.testing.assert_allclose(
        activations.gelu_tanh(_t(x)).numpy(),
        np.asarray(j_act.gelu_tanh(jnp.asarray(x))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_attention_with_mask(hq, hkv):
    rng = _rng(3)
    b, sq, sk, d = 2, 6, 9, 16
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    valid = rng.random((b, sq, sk)) < 0.7
    valid[..., 0] = True
    mask = attention.make_additive_mask(_t(valid))
    jmask = j_attn.make_additive_mask(jnp.asarray(valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    tol = dict(rtol=1e-5, atol=1e-5)  # fp32 einsum + softmax
    np.testing.assert_allclose(
        attention.gqa(_t(q), _t(k), _t(v), mask).numpy(),
        np.asarray(j_attn.gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask)),
        **tol)
    if hq == hkv:
        np.testing.assert_allclose(
            attention.mha(_t(q), _t(k), _t(v), mask).numpy(),
            np.asarray(j_attn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask)),
            **tol)


def test_greedy_ties_go_to_first_index():
    logits = np.zeros((3, 50), np.float32)
    logits[0, [7, 20]] = 5.0
    logits[1, [3, 4, 49]] = 1.0
    logits[2] = _rng(4).normal(size=50)
    got = sampling.greedy(_t(logits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_sampling.greedy(jnp.asarray(logits))))
    assert got[0] == 7 and got[1] == 3


def test_top_p_mask_probs_shift_by_one():
    probs = np.sort(_rng(5).dirichlet(np.ones(40), size=3).astype(np.float32), -1)[:, ::-1]
    probs = np.ascontiguousarray(probs)
    for p in (0.1, 0.5, 0.9):
        np.testing.assert_allclose(
            sampling.top_p_mask_probs(_t(probs), p).numpy(),
            np.asarray(j_sampling.top_p_mask_probs(jnp.asarray(probs), p)),
            rtol=0, atol=0)


@pytest.mark.parametrize("temperature,top_p", [(0.8, 0.9), (1.0, 0.5), (0.3, 1.0)])
def test_sample_top_p_with_jax_gumbel_noise(temperature, top_p):
    """Same logits and JAX's own Gumbel draws on both sides: the sampled ids
    must be identical."""
    logits = (_rng(6).normal(size=(4, 300)) * 3).astype(np.float32)
    for step in range(5):
        key = jax.random.PRNGKey(step)
        want = np.asarray(j_sampling.sample_top_p(key, jnp.asarray(logits), temperature, top_p))
        noise = np.asarray(jax.random.gumbel(key, logits.shape, dtype=jnp.float32))
        got = sampling.sample(None, _t(logits), temperature, top_p, do_sample=True,
                              noise=_t(noise)).numpy()
        np.testing.assert_array_equal(got, want)


def test_sample_from_generator_stays_in_nucleus():
    logits = _t((_rng(7).normal(size=(2, 100)) * 4).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    probs = torch.softmax(logits, -1)
    srt, idx = torch.sort(probs, -1, descending=True)
    for _ in range(20):
        tok = sampling.sample_top_p(gen, logits, 1.0, 0.5)
        for r in range(2):
            rank = int((idx[r] == tok[r]).nonzero())
            assert float(srt[r, :rank].sum()) <= 0.5  # shift-by-one rule
