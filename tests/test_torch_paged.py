"""The port's paged KV pieces against the JAX package (CPU, seeded inputs):
the page allocator and cache, the paged attention kernel's plain version,
the paged decode layer chain and the paged model steps. On the CPU each
wrapper runs its plain PyTorch version; the JAX side runs its Pallas kernels
in interpret mode or through its plain reference, as its own tests do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import GemmaConfig, PaliGemmaConfig, tiny_test_config
from paligemma_tpu.kernels import decode_layer as j_layer
from paligemma_tpu.kernels import decode_layer_paged as j_dlp
from paligemma_tpu.kernels import paged_attention as j_pa
from paligemma_tpu.models import gemma as j_gemma
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.ops import rope as j_rope
from paligemma_tpu.runtime import paged_cache as j_cache
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.kernels import decode_head as t_head
from paligemma_tpu_torch.kernels import decode_layer as t_layer
from paligemma_tpu_torch.kernels import decode_layer_paged as t_dlp
from paligemma_tpu_torch.kernels import paged_attention as t_pa
from paligemma_tpu_torch.models import gemma as t_gemma
from paligemma_tpu_torch.models import paligemma as t_pg
from paligemma_tpu_torch.runtime import paged_cache as t_cache

torch.set_num_threads(2)


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# ------------------------------------------------------ allocator / cache ----
def test_allocator_and_cache_follow_jax_on_random_sequence():
    """The same random alloc / grow / free / transfer sequence gives the
    same page lists, free counts and page table as the JAX classes."""
    rng = np.random.default_rng(0)
    ja, ta = j_cache.PageAllocator(40, first=1), t_cache.PageAllocator(40, first=1)
    for _ in range(300):
        op, owner = rng.integers(0, 4), int(rng.integers(0, 6))
        if op <= 1:
            n = int(rng.integers(0, 6))
            assert ja.alloc(owner, n) == ta.alloc(owner, n)
        elif op == 2:
            ja.free(owner)
            ta.free(owner)
        elif ja.pages_of(owner):
            n = int(rng.integers(1, len(ja.pages_of(owner)) + 1))
            assert ja.transfer(owner, owner + 10, n) == ta.transfer(owner, owner + 10, n)
        assert ja.free_pages == ta.free_pages
        for o in range(16):
            assert ja.pages_of(o) == ta.pages_of(o)

    tcfg = tiny_test_config().text_config
    jc = j_cache.PagedKVCache(tcfg, n_pages=24, page_size=16, max_slots=3, max_pages_per_slot=6)
    tc = t_cache.PagedKVCache(tcfg, n_pages=24, page_size=16, max_slots=3, max_pages_per_slot=6,
                              dtype=torch.float32, device="cpu")
    assert tuple(tc.pool["k"].shape) == tuple(jc.pool["k"].shape)
    for _ in range(200):
        slot = int(rng.integers(0, 3))
        if rng.random() < 0.75:
            n_tok = int(rng.integers(1, 100))
            assert jc.grow_to(slot, n_tok) == tc.grow_to(slot, n_tok)
        else:
            jc.release(slot)
            tc.release(slot)
        assert jc.alloc.free_pages == tc.alloc.free_pages
        np.testing.assert_array_equal(np.asarray(jc.page_table), tc.page_table.numpy())


def test_page_allocator_alloc_free_reuse():
    a = t_cache.PageAllocator(4)
    assert a.alloc(0, 2) is not None and a.free_pages == 2
    assert a.alloc(1, 3) is None and a.free_pages == 2  # no partial alloc
    assert a.alloc(1, 2) is not None and a.free_pages == 0
    a.free(0)
    assert a.free_pages == 2
    got = a.alloc(2, 2)
    assert got is not None and a.free_pages == 0
    assert set(got) <= set(range(4))


def test_page_allocator_prefers_contiguous_runs():
    a = t_cache.PageAllocator(32, first=1)
    p0 = a.alloc(0, 4)
    assert p0 == list(range(p0[0], p0[0] + 4))
    p1 = a.alloc(1, 4)
    assert p1 == list(range(p1[0], p1[0] + 4)) and not set(p0) & set(p1)
    a.free(1)
    assert a.alloc(0, 2) == [p0[-1] + 1, p0[-1] + 2]  # growth extends the tail run
    b = t_cache.PageAllocator(8, first=1)
    for owner in range(4):
        b.alloc(owner, 1)
    b.free(0)
    b.free(2)  # free pages now {1, 3} + tail {5, 6, 7}
    got = b.alloc(4, 4)  # no 4-run exists; must still succeed
    assert got is not None and len(got) == 4
    for owner in (1, 3, 4):
        b.free(owner)
    assert b.free_pages == 7


def test_paged_cache_grow_and_release():
    tcfg = tiny_test_config().text_config
    c = t_cache.PagedKVCache(tcfg, n_pages=9, page_size=16, max_slots=2, max_pages_per_slot=4,
                             device="cpu")
    assert c.grow_to(0, 33) and len(c.slot_pages(0)) == 3
    assert c.grow_to(0, 40) and len(c.slot_pages(0)) == 3  # no-op
    assert c.grow_to(1, 16 * 4)
    assert not c.grow_to(0, 16 * 4 + 1)  # over max_pages_per_slot
    assert c.alloc.free_pages == 1
    assert c.grow_to(0, 64) and c.alloc.free_pages == 0
    c.release(0)
    assert c.alloc.free_pages == 4
    table = c.page_table.numpy()
    assert table[0].tolist() == [0, 0, 0, 0]  # back to the garbage page
    assert table[1, :4].tolist() == c.slot_pages(1)
    assert 0 not in c.slot_pages(1)


def test_paged_cache_borrowed_prefix():
    """Borrowed prefix pages fill the leading table entries, count toward
    growth, and stay with their owner when the slot is released."""
    tcfg = tiny_test_config().text_config
    c = t_cache.PagedKVCache(tcfg, n_pages=12, page_size=16, max_slots=2, max_pages_per_slot=5,
                             device="cpu")
    shared = c.alloc.alloc(-2, 2)  # a prefix-cache entry's pages
    c.set_borrowed(0, shared)
    assert c.grow_to(0, 40)  # 3 pages: 2 borrowed + 1 owned
    assert c.slot_pages(0) == [shared[-1] + 1]
    assert c.page_table[0, :3].tolist() == shared + c.slot_pages(0)
    c.release(0)
    assert c.alloc.pages_of(-2) == shared and c.alloc.free_pages == 12 - 1 - 2
    assert c.grow_to(1, 16)
    with pytest.raises(ValueError):
        c.set_borrowed(1, shared)  # only before the slot owns pages


# ------------------------------------------------------- paged attention ----
def _pools(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("hq,hkv", [(8, 1), (8, 2), (4, 4)])
def test_paged_attention_matches_jax_reference(hq, hkv):
    """Fragmented table, a kv_len == 0 row and a layer-stacked pool: the
    port (CPU -> plain version) against JAX's reference on the live rows to
    1e-5, exact zeros on the empty row (the kernels' contract)."""
    rng = np.random.default_rng(1)
    ps, d, b = 16, 128, 4
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kp, vp = _pools(2, (3, 12, ps, hkv, d))
    table = np.array([[3, 7, 1, 0], [5, 0, 0, 0], [2, 9, 11, 4], [6, 8, 0, 0]], np.int32)
    kv_len = np.array([37, 5, 64, 0], np.int32)
    want = _np(j_pa.reference_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(kv_len), layer_idx=jnp.asarray(2, jnp.int32)))
    for fn in (t_pa.paged_decode_attention, t_pa.paged_decode_attention_multi,
               t_pa.paged_decode_attention_batched, t_pa.paged_decode_attention_runs,
               t_pa.reference_paged_decode_attention):
        got = fn(_t(q), _t(kp), _t(vp), _t(table), _t(kv_len), layer_idx=2).numpy()
        np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5, atol=1e-5)
        assert np.all(got[3] == 0.0)


def test_paged_attention_matches_pallas_multi_interpret():
    """One small case against the TPU's multi-page kernel in interpret mode
    (8 query heads over 2 KV heads, 3 pages per step, unstacked pool)."""
    rng = np.random.default_rng(3)
    ps, d, b, hq, hkv = 16, 128, 3, 8, 2
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kp, vp = _pools(4, (12, ps, hkv, d))
    table = np.array([[3, 7, 1, 0, 2, 8, 10], [5, 0, 0, 0, 0, 0, 0], [2, 9, 11, 4, 6, 1, 3]],
                     np.int32)
    kv_len = np.array([37, 5, 112], np.int32)
    want = _np(j_pa.paged_decode_attention_multi(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(kv_len), interpret=True, pages_per_step=3))
    got = t_pa.paged_decode_attention_multi(_t(q), _t(kp), _t(vp), _t(table), _t(kv_len))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_paged_attention_deeply_negative_scores():
    """Every visible score below exp's underflow: the exact softmax average,
    not zeros (the JAX kernel's regression case)."""
    ps, d = 16, 128
    q = np.full((2, 4, d), 3.0, np.float32)
    kp = np.full((4, ps, 1, d), -3.0, np.float32)
    vp = np.arange(4 * ps * d, dtype=np.float32).reshape(4, ps, 1, d) / 1e3
    table, kv_len = np.array([[0, 1], [2, 3]], np.int32), np.array([20, 7], np.int32)
    got = t_pa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(kv_len)).numpy()
    want = _np(j_pa.reference_paged_decode_attention(*map(jnp.asarray, (q, kp, vp, table, kv_len))))
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------- paged decode layer ----
def _mqa_lm(seed=0):
    # the MQA / head_dim-128 config of tests/test_paged.py:511, in fp32
    cfg = GemmaConfig(vocab_size=256, hidden_size=128, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
                      head_dim=128, max_position_embeddings=128)
    full = {"lm": j_gemma.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)}
    return cfg, j_qserve(full)["lm"]


@pytest.mark.parametrize("frag", [False, True])
def test_layers_decode_fused_paged_matches_pallas(frag):
    """fp32 on the int8 tree JAX quantized, rows at different positions:
    hidden state and fresh K/V to 1e-4 relative against the TPU kernel in
    interpret mode; the port also wrote the fresh rows into their slots."""
    cfg, jlm = _mqa_lm()
    tlm = _to_port(jlm)
    rng = np.random.default_rng(5)
    n_layers, b, ps, hd, n_pages, pb = 2, 2, 16, 128, 8, 2
    x = rng.normal(size=(b, 1, cfg.hidden_size)).astype(np.float32)
    kp = (rng.normal(size=(n_layers, n_pages, ps, hd)) * 0.5).astype(np.float32)
    vp = (rng.normal(size=(n_layers, n_pages, ps, hd)) * 0.5).astype(np.float32)
    table = np.array([[5, 2, 0, 0], [7, 3, 0, 0]] if frag else [[1, 2, 0, 0], [3, 4, 0, 0]],
                     np.int32)
    pos = np.array([5, 17], np.int32)
    cos, sin = j_rope.rope_cos_sin(jnp.asarray(pos + 1)[:, None], hd)
    jh, jk, jv = j_dlp.layers_decode_fused_paged(
        jnp.asarray(x), j_layer.repack_layers(jlm["layers"]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table[:, :pb]), jnp.asarray(pos), cos[:, 0], sin[:, 0],
        cfg.num_attention_heads, hd, cfg.rms_norm_eps, interpret=True)
    tkp, tvp = _t(kp), _t(vp)
    assert t_dlp.supported(cfg, tlm["layers"], b, page_size=ps)
    th, tk, tv = t_dlp.layers_decode_fused_paged(
        _t(x), t_layer.repack_layers(tlm["layers"]), tkp, tvp, _t(table), _t(pos),
        _t(np.asarray(cos[:, 0])), _t(np.asarray(sin[:, 0])), cfg.num_attention_heads, hd,
        cfg.rms_norm_eps, pages_bucket=pb)
    for got, want in ((th, jh), (tk, jk), (tv, jv)):
        want = _np(want)
        assert got.shape == want.shape
        assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) < 1e-4
    for r in range(b):
        page, slot = table[r, pos[r] // ps], pos[r] % ps
        assert torch.equal(tkp[:, page, slot], tk[:, r])
        assert torch.equal(tvp[:, page, slot], tv[:, r])


# ------------------------------------------------------------- models ----
def _mqa_pg_config():
    tiny = tiny_test_config()
    return PaliGemmaConfig(
        vision_config=tiny.vision_config,
        text_config=GemmaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=1, head_dim=128),
        projection_dim=128, hidden_size=128, image_token_index=510, vocab_size=512,
    )


def _prompt(cfg, b, n_txt, seed):
    rng = np.random.default_rng(seed)
    n_img = cfg.vision_config.num_patches
    ids = np.concatenate([np.full((b, n_img), cfg.image_token_index),
                          rng.integers(3, 100, (b, n_txt))], 1).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, -2:] = 0  # a padded row
    pixels = rng.normal(size=(b, 3, 28, 28)).astype(np.float32)
    return pixels, ids, mask


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_prefix_lens_matches_jax(use_flash):
    """Recompute prefill (prefix shorter than the prompt): last-token logits
    and the written cache against JAX's plain path, to 2e-4."""
    cfg = tiny_test_config()
    jp = j_pg.init_params(jax.random.PRNGKey(0), cfg)
    pixels, ids, mask = _prompt(cfg, 2, 6, seed=7)
    pfx = np.array([cfg.vision_config.num_patches + 2, cfg.vision_config.num_patches + 4],
                   np.int32)
    jc = j_gemma.init_kv_cache(cfg.text_config, 2, 16, jnp.float32)
    want, jc = j_pg.prefill(jp, cfg, jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask),
                            jc, use_flash=False, last_only=True, prefix_lens=jnp.asarray(pfx))
    tc = t_gemma.init_kv_cache(cfg.text_config, 2, 16, torch.float32, device=torch.device("cpu"))
    got, tc = t_pg.prefill(_to_port(jp), cfg, _t(pixels), _t(ids).long(), _t(mask), tc,
                           use_flash=use_flash, last_only=True, prefix_lens=_t(pfx))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=2e-4)
    s = ids.shape[1]
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n][:, :, :s].numpy(), _np(jc[n])[:, :, :s],
                                   rtol=2e-4, atol=2e-4)


def _paged_setup(seed=11):
    cfg = _mqa_pg_config()
    jp = j_pg.init_params(jax.random.PRNGKey(seed), cfg)
    jq = j_qserve(jp)
    tq = _to_port(jq)
    tq["lm"]["layers"] = t_layer.repack_layers(tq["lm"]["layers"])
    rng = np.random.default_rng(seed)
    L, n_pages, ps, hd = 2, 10, 16, 128
    pool = {n: (rng.normal(size=(L, n_pages, ps, 1, hd)) * 0.5).astype(np.float32)
            for n in ("k", "v")}
    table = np.array([[4, 9, 0, 0], [2, 3, 7, 0]], np.int32)
    return cfg, jq, tq, pool, table


@pytest.mark.parametrize("kernel", ["multi", "fused", "xla"])
def test_decode_step_paged_matches_jax(kernel):
    """Two chained paged steps against JAX's page walk on the same int8
    tree: logits to 1e-4 of the largest, same pool writes."""
    cfg, jq, tq, pool, table = _paged_setup()
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    tpool = {n: _t(a) for n, a in pool.items()}
    tok = np.array([7, 9], np.int32)
    wp = np.array([12, 33], np.int32)
    for _ in range(2):
        want, jpool = j_pg.decode_step_paged(
            jq, cfg, jnp.asarray(tok), jpool, jnp.asarray(table), jnp.asarray(wp),
            jnp.asarray(wp + 1), pages_bucket=4, paged_kernel="xla")
        got, tpool = t_pg.decode_step_paged(
            tq, cfg, _t(tok), tpool, _t(table), _t(wp), _t(wp + 1), pages_bucket=4,
            paged_kernel=kernel)
        want = _np(want)
        assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) < 1e-4
        for n in ("k", "v"):
            np.testing.assert_allclose(tpool[n].numpy(), _np(jpool[n]), rtol=1e-4, atol=1e-4)
        tok = want.argmax(-1).astype(np.int32)
        wp = wp + 1


def test_decode_step_greedy_paged_matches_argmax():
    """The greedy paged step gives argmax of the paged logits (the argmax
    head's bf16 rounding aside, fp32 here: exact) and the same pool."""
    cfg, jq, tq, pool, table = _paged_setup(seed=12)
    tq["lm"]["head_q"] = t_head.repack_head(tq["lm"]["head_q"])
    tok, wp = np.array([3, 5], np.int32), np.array([20, 40], np.int32)
    want, jpool = j_pg.decode_step_paged(
        jq, cfg, jnp.asarray(tok), {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(table), jnp.asarray(wp), jnp.asarray(wp + 1), paged_kernel="xla")
    tpool = {n: _t(a) for n, a in pool.items()}
    got, tpool = t_pg.decode_step_greedy_paged(tq, cfg, _t(tok), tpool, _t(table), _t(wp),
                                               _t(wp + 1), pages_bucket=4)
    np.testing.assert_array_equal(got.numpy(), _np(want).argmax(-1))
    for n in ("k", "v"):
        np.testing.assert_allclose(tpool[n].numpy(), _np(jpool[n]), rtol=1e-4, atol=1e-4)
