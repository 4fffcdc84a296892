"""paligemma_tpu_torch.models against paligemma_tpu.models at
tiny_test_config() in fp32 on the CPU. Logits agree to relative max-abs
1e-4 (fp32, reordered reductions) and greedy tokens are identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import tiny_test_config
from paligemma_tpu.models import gemma as j_gemma
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.models import siglip as j_siglip
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.models import gemma, paligemma, siglip

torch.set_num_threads(2)

CFG = tiny_test_config()
REL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _params(seed=0):
    jp = j_pg.init_params(jax.random.PRNGKey(seed), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(b=2, n_txt=5, seed=0, pad=0):
    rng = np.random.default_rng(seed)
    n_img = CFG.vision_config.num_patches
    ids = np.concatenate(
        [np.full((b, n_img), CFG.image_token_index), rng.integers(3, 100, (b, n_txt))], 1
    ).astype(np.int32)
    mask = np.ones_like(ids)
    if pad:
        ids[-1, -pad:] = CFG.pad_token_id
        mask[-1, -pad:] = 0
    pixels = rng.normal(size=(b, 3, 28, 28)).astype(np.float32)
    return pixels, ids, mask


def test_siglip_encode():
    jp, tp = _params()
    pixels, _, _ = _inputs()
    want = j_siglip.encode(jp["vision"], CFG.vision_config, jnp.asarray(pixels))
    got = siglip.encode(tp["vision"], CFG.vision_config, torch.from_numpy(pixels))
    assert got.shape == want.shape
    assert _rel(got, want) < REL


def test_gemma_forward_prefill_and_bucketed_decode():
    jp, tp = _params(1)
    tc = CFG.text_config
    rng = np.random.default_rng(1)
    b, s, max_seq = 2, 6, 24
    emb = rng.normal(size=(b, s, tc.hidden_size)).astype(np.float32)
    pos = np.tile(np.arange(1, s + 1, dtype=np.int32), (b, 1))
    valid = np.zeros((b, max_seq), bool)
    valid[:, :s] = True
    jc = j_gemma.init_kv_cache(tc, b, max_seq)
    tcache = gemma.init_kv_cache(tc, b, max_seq, torch.float32, device="cpu")
    jl, jc = j_gemma.forward(jp["lm"], tc, jnp.asarray(emb), jnp.asarray(pos), jc,
                             jnp.asarray(0, jnp.int32), jnp.asarray(valid))
    tl, tcache = gemma.forward(tp["lm"], tc, torch.from_numpy(emb), torch.from_numpy(pos),
                               tcache, 0, torch.from_numpy(valid))
    assert _rel(tl, jl) < REL
    assert _rel(tcache["k"], jc["k"]) < REL and _rel(tcache["v"], jc["v"]) < REL
    # one decode step over an 8-slot window
    emb1 = rng.normal(size=(b, 1, tc.hidden_size)).astype(np.float32)
    valid[:, s] = True
    pos1 = np.full((b, 1), s + 1, np.int32)
    jl, jc = j_gemma.forward(jp["lm"], tc, jnp.asarray(emb1), jnp.asarray(pos1), jc,
                             jnp.asarray(s, jnp.int32), jnp.asarray(valid), kv_bucket=8)
    tl, tcache = gemma.forward(tp["lm"], tc, torch.from_numpy(emb1), torch.from_numpy(pos1),
                               tcache, s, torch.from_numpy(valid), kv_bucket=8)
    assert _rel(tl, jl) < REL
    np.testing.assert_array_equal(tl[:, 0].argmax(-1).numpy(), np.argmax(np.asarray(jl)[:, 0], -1))


def test_prefill_then_decode_steps():
    """prefill (last_only, with a padded row) then three decode steps via
    decode_step and decode_step_greedy, teacher-forced with JAX's tokens."""
    jp, tp = _params(2)
    tc = CFG.text_config
    pixels, ids, mask = _inputs(pad=2, seed=2)
    b, s = ids.shape
    max_seq = 32
    jc = j_gemma.init_kv_cache(tc, b, max_seq)
    tcache = gemma.init_kv_cache(tc, b, max_seq, torch.float32, device="cpu")
    jl, jc = j_pg.prefill(jp, CFG, jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask),
                          jc, last_only=True)
    tl, tcache = paligemma.prefill(tp, CFG, torch.from_numpy(pixels), torch.from_numpy(ids),
                                   torch.from_numpy(mask), tcache, last_only=True)
    assert tl.shape == jl.shape
    assert _rel(tl, jl) < REL
    tok = np.argmax(np.asarray(jl)[:, 0], -1).astype(np.int32)
    np.testing.assert_array_equal(tl[:, 0].argmax(-1).numpy(), tok)

    valid = np.zeros((b, max_seq), bool)
    valid[:, :s] = mask.astype(bool)
    pos = mask.sum(-1).astype(np.int32) + 1
    tcache_g = {k: v.clone() for k, v in tcache.items()}
    for step in range(3):
        w = s + step
        valid[:, w] = True
        jl, jc = j_pg.decode_step(jp, CFG, jnp.asarray(tok), jc, jnp.asarray(w, jnp.int32),
                                  jnp.asarray(valid), jnp.asarray(pos))
        tl, tcache = paligemma.decode_step(tp, CFG, torch.from_numpy(tok), tcache, w,
                                           torch.from_numpy(valid), torch.from_numpy(pos))
        tg, tcache_g = paligemma.decode_step_greedy(
            tp, CFG, torch.from_numpy(tok), tcache_g, w, torch.from_numpy(valid),
            torch.from_numpy(pos), fused_layer=False)
        assert _rel(tl, jl) < REL, step
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        np.testing.assert_array_equal(tg.numpy(), nxt)
        tok, pos = nxt, pos + 1


def test_fused_decode_on_dense_gqa_tree_raises():
    """decode_step_greedy defaults to the kernel path; on a tree and config
    the kernels cannot take, gemma.forward raises instead of going plain."""
    _, tp = _params()
    b, max_seq = 2, 16
    cache = gemma.init_kv_cache(CFG.text_config, b, max_seq, torch.float32, device="cpu")
    valid = torch.zeros((b, max_seq), dtype=torch.bool)
    valid[:, :4] = True
    with pytest.raises(ValueError, match="fused_layer"):
        paligemma.decode_step_greedy(tp, CFG, torch.tensor([3, 4]), cache, 3, valid,
                                     torch.tensor([4, 4], dtype=torch.int32))


def test_merge_embeddings_and_positions():
    rng = np.random.default_rng(3)
    ids = np.array([[CFG.image_token_index] * 4 + [5, 6, 0],
                    [CFG.image_token_index] * 4 + [7, 0, 0]], np.int32)
    mask = (ids != 0).astype(np.int32)
    text = rng.normal(size=(2, 7, 64)).astype(np.float32)
    img = rng.normal(size=(2, 4, 64)).astype(np.float32)
    want = j_pg.merge_embeddings(CFG, jnp.asarray(ids), jnp.asarray(text), jnp.asarray(img))
    got = paligemma.merge_embeddings(CFG, torch.from_numpy(ids), torch.from_numpy(text),
                                     torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        paligemma.prefill_position_ids(torch.from_numpy(mask)).numpy(),
        np.asarray(j_pg.prefill_position_ids(jnp.asarray(mask))))


def test_params_from_numpy_dtypes():
    """bf16 arrays (ml_dtypes) arrive exactly; ``dtype`` casts float leaves
    but keeps int8 weights and their fp32 "s" scales."""
    w = np.random.default_rng(4).normal(size=(4, 3)).astype(jnp.bfloat16)
    tree = {"a": w, "q": {"w8": np.ones((2, 2), np.int8), "s": np.ones(2, np.float32)},
            "n": np.arange(3, dtype=np.int32)}
    kept = params_from_numpy(tree, "cpu")
    assert kept["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(kept["a"].float().numpy(), w.astype(np.float32))
    cast = params_from_numpy(tree, "cpu", torch.float32)
    assert cast["a"].dtype == torch.float32 and cast["q"]["w8"].dtype == torch.int8
    assert cast["q"]["s"].dtype == torch.float32 and cast["n"].dtype == torch.int32
    half = params_from_numpy({"q": tree["q"], "x": np.ones(2, np.float32)}, "cpu", torch.bfloat16)
    assert half["q"]["s"].dtype == torch.float32 and half["x"].dtype == torch.bfloat16
