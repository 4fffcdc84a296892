"""The port's mask decoder (processing/mask_vae.py) and the public names of
``ops/activations.geglu``, ``runtime/quantize.quantized_bytes`` and the
models' ``init_params`` against the JAX package's (CPU):

* ``reconstruct_masks`` on JAX's random decoder, converted with
  ``convert.params_from_numpy``, within 1e-5 of JAX's logits at fp32 (the
  4 -> 8 -> 16 -> 32 -> 64 geometry of the transposed convs included, and
  one impulse per position through a single transposed conv, which a wrong
  flip, channel swap or padding moves);
* ``load_vae_oid_npz`` on an npz in the official torch key layout gives
  JAX's tree, tensor for tensor, and the same masks;
* ``to_unit_range`` and ``init_params``' geometry;
* ``geglu`` within 1e-5 (fp32) of JAX's; ``quantized_bytes`` equal on the
  int8 and 4-bit trees; the three ``init_params`` give JAX's shapes and
  dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paligemma_tpu_torch
from paligemma_tpu.models import gemma as j_gemma
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.models import siglip as j_siglip
from paligemma_tpu.ops import activations as j_act
from paligemma_tpu.processing import mask_vae as j_vae
from paligemma_tpu.runtime import quantize as j_quant
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.models import gemma as t_gemma
from paligemma_tpu_torch.models import paligemma as t_pg
from paligemma_tpu_torch.models import siglip as t_siglip
from paligemma_tpu_torch.ops import activations as t_act
from paligemma_tpu_torch.processing import mask_vae as t_vae
from paligemma_tpu_torch.runtime import quantize as t_quant

torch.set_num_threads(2)

TOL = 1e-5  # fp32 convolutions summed in another order


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.fixture(scope="module")
def decoder():
    jp = j_vae.init_params(jax.random.PRNGKey(0), embedding_dim=32)
    return jp, params_from_numpy(_np_tree(jp), "cpu")


def test_reconstruct_masks_equals_jax(decoder):
    jp, tp = decoder
    idx = np.random.default_rng(0).integers(0, 128, (3, 16)).astype(np.int32)
    want = np.asarray(j_vae.reconstruct_masks(jp, jnp.asarray(idx)))
    got = t_vae.reconstruct_masks(tp, torch.from_numpy(idx))
    assert got.shape == (3, 64, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(t_vae.to_unit_range(got), j_vae.to_unit_range(got.numpy()))
    assert np.array_equal(t_vae.reconstruct_masks(tp, idx).numpy(), got.numpy())
    with pytest.raises(ValueError, match="16 indices"):
        t_vae.reconstruct_masks(tp, idx[:, :8])


@pytest.mark.parametrize("hw", [4, 8, 16, 32])
def test_conv_transpose_geometry_equals_jax(decoder, hw):
    """One transposed conv of the decoder on impulses at every position of
    an hw x hw grid (and a random input): the output doubles H and W and
    each impulse lands where JAX's lands."""
    jp, tp = decoder
    up = {4: "up0", 8: "up1", 16: "up2", 32: "up3"}[hw]
    cin = tp[up]["kernel"].shape[3]
    rng = np.random.default_rng(hw)
    xs = [rng.standard_normal((1, hw, hw, cin)).astype(np.float32)]
    for i, j in ((0, 0), (hw - 1, hw - 1), (1, hw // 2)):
        x = np.zeros((1, hw, hw, cin), np.float32)
        x[0, i, j, :] = 1.0
        xs.append(x)
    for x in xs:
        want = np.asarray(j_vae._conv_transpose(jnp.asarray(x), jp[up]))
        got = t_vae._conv_transpose(torch.from_numpy(x).permute(0, 3, 1, 2), tp[up])
        assert tuple(got.shape) == (1, want.shape[3], 2 * hw, 2 * hw)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=TOL * max(1.0, np.abs(want).max()))


def _official_npz(path, d, rng):
    """An npz in vae-oid.npz's torch key layout (tests/test_detection.py)."""
    ckpt = {"_vq_vae._embedding": rng.normal(size=(128, d)).astype(np.float32)}

    def conv(name, cin, cout, k):
        ckpt[f"{name}.weight"] = (rng.normal(size=(cout, cin, k, k)) * 0.05).astype(np.float32)
        ckpt[f"{name}.bias"] = (rng.normal(size=(cout,)) * 0.05).astype(np.float32)

    def convt(name, cin, cout):  # torch ConvTranspose2d weight: (in, out, kh, kw)
        ckpt[f"{name}.weight"] = (rng.normal(size=(cin, cout, 4, 4)) * 0.05).astype(np.float32)
        ckpt[f"{name}.bias"] = (rng.normal(size=(cout,)) * 0.05).astype(np.float32)

    conv("decoder.0", d, 128, 1)
    for r in (2, 3):
        conv(f"decoder.{r}.net.0", 128, 128, 3)
        conv(f"decoder.{r}.net.2", 128, 128, 3)
        conv(f"decoder.{r}.net.4", 128, 128, 1)
    cin = 128
    for i, cout in zip((4, 6, 8, 10), (128, 64, 32, 16)):
        convt(f"decoder.{i}", cin, cout)
        cin = cout
    conv("decoder.12", 16, 1, 1)
    np.savez(path, **ckpt)
    return ckpt


def test_load_vae_oid_npz_equals_jax(tmp_path):
    path = tmp_path / "vae-oid.npz"
    ckpt = _official_npz(path, 24, np.random.default_rng(1))
    jp = j_vae.load_vae_oid_npz(str(path))
    tp = t_vae.load_vae_oid_npz(str(path))
    want, got = _np_tree(jp), jax.tree.map(lambda t: t.numpy(), tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    idx = np.random.default_rng(2).integers(0, 128, (2, 16)).astype(np.int32)
    m_j = np.asarray(j_vae.reconstruct_masks(jp, jnp.asarray(idx)))
    m_t = t_vae.reconstruct_masks(tp, idx).numpy()
    np.testing.assert_allclose(m_t, m_j, atol=TOL * max(1.0, np.abs(m_j).max()))
    # the official transposed-conv weight is torch's own ConvTranspose2d(4, 2, 1)
    w = torch.from_numpy(ckpt["decoder.4.weight"])
    conv = torch.nn.ConvTranspose2d(128, 128, 4, 2, 1)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(torch.from_numpy(ckpt["decoder.4.bias"]))
        x = torch.randn(1, 128, 4, 4, generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(t_vae._conv_transpose(x, tp["up0"]), conv(x))


def test_init_params_geometry_equals_jax():
    jp = j_vae.init_params(jax.random.PRNGKey(3), embedding_dim=40)
    tp = t_vae.init_params(torch.Generator().manual_seed(3), embedding_dim=40)
    assert _shapes(tp) == _shapes(_np_tree(jp))
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(tp))
    bf = t_vae.init_params(torch.Generator().manual_seed(3), 40, torch.bfloat16)
    assert bf["up3"]["kernel"].dtype == torch.bfloat16
    out = t_vae.reconstruct_masks(tp, np.zeros((2, 16), np.int32))
    assert out.shape == (2, 64, 64) and torch.isfinite(out).all()
    unit = t_vae.to_unit_range(out)
    assert unit.min() >= 0.0 and unit.max() <= 1.0


def test_geglu_equals_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    g, u = (rng.standard_normal((16, 24)).astype(np.float32) * 0.3 for _ in range(2))
    d = rng.standard_normal((24, 16)).astype(np.float32) * 0.3
    want = np.asarray(j_act.geglu(*map(jnp.asarray, (x, g, u, d))))
    got = t_act.geglu(*map(torch.from_numpy, (x, g, u, d)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * max(1.0, np.abs(want).max()))


def test_quantized_bytes_equals_jax():
    cfg = paligemma_tpu_torch.tiny_test_config()
    jp = _np_tree(j_pg.init_params(jax.random.PRNGKey(0), cfg))
    tp = params_from_numpy(jp, "cpu")
    for jq, tq in (
        (j_quant.quantize_lm_for_serving(jax.tree.map(jnp.asarray, jp)),
         t_quant.quantize_lm_for_serving(tp)),
        (j_quant.quantize_lm_for_training(jax.tree.map(jnp.asarray, jp), "nf4"),
         t_quant.quantize_lm_for_training(tp, "nf4")),
        (jp, tp),
    ):
        assert t_quant.quantized_bytes(tq) == j_quant.quantized_bytes(jq) > 0


def test_models_init_params_follow_jax():
    """The three ``init_params(generator, cfg, dtype)``: JAX's tree shapes
    and dtypes, the generator's device, fp32 by default."""
    cfg = paligemma_tpu_torch.tiny_test_config()
    cases = ((j_siglip, t_siglip, cfg.vision_config), (j_gemma, t_gemma, cfg.text_config),
             (j_pg, t_pg, cfg))
    for j_mod, t_mod, c in cases:
        want = _np_tree(j_mod.init_params(jax.random.PRNGKey(0), c))
        got = t_mod.init_params(torch.Generator().manual_seed(0), c)
        assert _shapes(got) == _shapes(want), t_mod.__name__
        assert all(t.dtype == torch.float32 for t in jax.tree.leaves(got))
        bf = t_mod.init_params(torch.Generator().manual_seed(0), c, torch.bfloat16)
        assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(bf))
    # the same draws as the converter's full-model init
    from paligemma_tpu_torch.convert import init_params

    a = t_pg.init_params(torch.Generator().manual_seed(1), cfg)
    b = init_params(cfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
