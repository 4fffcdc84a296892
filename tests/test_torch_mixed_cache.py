"""A KV cache whose dtype differs from the activations' (the engines'
``cache_dtype``: bf16 activations over an fp32 cache, fp32 over bf16), on
the CPU, against the JAX package: the plain versions of the three mixed
kernel families (the qkv GEMV's cache write, the dense and the paged split
attention), the decode chain against JAX's fused Pallas kernel in interpret
mode, and the engines (PaliGemmaEngine on the fused layer, the dense fused
tick, the paged engine) against JAX's fused engines: the same greedy tokens.
The kernels themselves run in tests/test_torch_cuda.py on a card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import GemmaConfig, PaliGemmaConfig, tiny_test_config
from paligemma_tpu.kernels import decode_layer as j_layer
from paligemma_tpu.kernels import paged_attention as j_paged_attn
from paligemma_tpu.models import gemma as j_gemma
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.ops import attention as j_attn
from paligemma_tpu.ops import rope as j_rope
from paligemma_tpu.runtime import serving as j_serving
from paligemma_tpu.runtime import serving_paged as j_paged
from paligemma_tpu.runtime.engine import PaliGemmaEngine as JaxEngine
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu_torch import kernels
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.kernels import decode_attention as t_dattn
from paligemma_tpu_torch.kernels import decode_layer as t_layer
from paligemma_tpu_torch.kernels import int8_gemv as t_gemv
from paligemma_tpu_torch.kernels import paged_attention as t_paged_attn
from paligemma_tpu_torch.runtime import serving as t_serving
from paligemma_tpu_torch.runtime import serving_paged as t_paged
from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine

torch.set_num_threads(2)

BF, F32 = torch.bfloat16, torch.float32
# (activation dtype, cache dtype)
PAIRS = [("bfloat16", "float32"), ("float32", "bfloat16")]
# the plain versions against JAX: bf16 outputs round at 2^-8 relative, fp32
# sums differ in order only
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# the decode chain against JAX's fused kernel, hidden state relative to its
# largest element. bf16 activations: the bf16 roundings of two different
# chains, 5.7e-3 at this seed over either cache (tests/test_torch_kernels.py
# holds the fp32 chain to 1e-4; it is 3e-7 here). fp32 over a bf16 cache:
# the chain reads the fresh K / V row back from the cache, rounded to bf16,
# where the TPU kernel scores it unrounded (decode_layer.py:326-335); that
# one rounding moves the hidden state by 4.8e-4 at this seed, so the bound
# is 2e-3.
CHAIN_TOL = {"bfloat16": 3e-2, "float32": 2e-3}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


# ------------------------------------------------------------ kernels ----
@pytest.mark.parametrize("act,cache", PAIRS)
def test_decode_attention_plain_casts_the_window_like_jax(act, cache):
    """3b's plain version over a cache of the other dtype casts the window to
    q's dtype before its fp32 products, as JAX does
    (models/gemma.py:253-254; the fused kernel's ``kwin.astype(q.dtype)``):
    against JAX's gqa on the cast window, and bit for bit the call on the
    cache converted first. The fp32 cache holds values bf16 cannot hold."""
    rng = np.random.default_rng(2)
    b, h, d, s_len, w = 3, 4, 32, 40, 24
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kc, vc = (rng.normal(size=(b, s_len, d)).astype(np.float32) for _ in range(2))
    valid = rng.random((b, w)) < 0.6
    valid[:, 0] = True
    jq = jnp.asarray(q).astype(act)
    jk, jv = (jnp.asarray(c).astype(cache)[:, :w, None].astype(act) for c in (kc, vc))
    mask = j_attn.make_additive_mask(jnp.asarray(valid)[:, None, :])
    want = _np(j_attn.gqa(jq[:, None], jk, jv, mask, scale=d**-0.5)).reshape(b, h * d)
    tq, tk, tv = _t(q).to(getattr(torch, act)), *(_t(c).to(getattr(torch, cache))
                                                    for c in (kc, vc))
    got = t_dattn.decode_attention(tq, tk, tv, _t(valid), d**-0.5)
    assert got.dtype == tq.dtype and _rel(got.float(), want) <= TOL[act]
    cast = t_dattn.decode_attention(tq, tk.to(tq.dtype), tv.to(tq.dtype), _t(valid), d**-0.5)
    assert torch.equal(got, cast)


@pytest.mark.parametrize("act,cache", PAIRS)
def test_paged_attention_plain_casts_the_pages_like_jax(act, cache):
    """B5's plain version over a pool of the other dtype casts the gathered
    pages to q's dtype (decode_layer_paged.py:282, ``k_win.astype(q_b.dtype)``):
    against JAX's paged reference on the cast pool, and bit for bit the call
    on the pool converted first; a kv_len 0 row gives zeros."""
    rng = np.random.default_rng(3)
    b, hq, d, ps, n_pages, n_layers = 3, 4, 32, 16, 10, 2
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kp, vp = (rng.normal(size=(n_layers, n_pages, ps, 1, d)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(n_pages - 1)[:9].reshape(b, 3).astype(np.int32) + 1
    kv_len = np.array([37, 0, 20], np.int32)
    jq = jnp.asarray(q).astype(act)
    jk, jv = (jnp.asarray(p).astype(cache).astype(act) for p in (kp, vp))
    want = _np(j_paged_attn.reference_paged_decode_attention(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(kv_len), layer_idx=1))
    tq = _t(q).to(getattr(torch, act))
    tk, tv = (_t(p).to(getattr(torch, cache)) for p in (kp, vp))
    got = t_paged_attn.paged_decode_attention(tq, tk, tv, _t(table), _t(kv_len), layer_idx=1)
    live = kv_len > 0  # JAX's reference spreads a kv_len 0 row over the masked keys
    assert got.dtype == tq.dtype and _rel(got.float()[live], want[live]) <= TOL[act]
    assert torch.count_nonzero(got[1]) == 0
    cast = t_paged_attn.paged_decode_attention(tq, tk.to(tq.dtype), tv.to(tq.dtype), _t(table),
                                               _t(kv_len), layer_idx=1)
    assert torch.equal(got, cast)


@pytest.mark.parametrize("act,cache", PAIRS)
@pytest.mark.parametrize("paged", [False, True])
def test_rope_kv_write_converts_to_the_cache_dtype(act, cache, paged):
    """The qkv GEMV's cache write (int8_gemv_rope_kv, its plain version on
    the CPU) into a cache of the other dtype: q is the uniform call's, and
    the cache rows and k_new / v_new are the uniform call's rows converted
    (``.to(torch.bfloat16)``: nearest even; widening: exact), bit for bit;
    against JAX's apply_rope of the same q|k|v cast to the cache dtype, as
    the TPU kernel returns ``k_new.astype(cache dtype)``."""
    rng = np.random.default_rng(4)
    b, h, d, s_len, k, ps = 2, 3, 32, 16, 24, 8
    adt, cdt = getattr(torch, act), getattr(torch, cache)
    x = _t(rng.normal(size=(b, k)).astype(np.float32)).to(adt)
    w8 = torch.from_numpy(rng.integers(-127, 128, (k, (h + 2) * d), dtype=np.int8))
    s = _t((rng.random((h + 2) * d) * 0.02).astype(np.float32))
    norm = (_t(rng.normal(size=k).astype(np.float32) * 0.1).to(adt), 1e-6)
    pos = torch.tensor([4, 9], dtype=torch.int32)
    jcos, jsin = (t[:, 0] for t in j_rope.rope_cos_sin(jnp.asarray([[5], [10]]), d))
    cos, sin = _t(jcos).to(adt), _t(jsin).to(adt)
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32) if paged else None
    shape = (4, ps, d) if paged else (b, s_len, d)

    def run(dtype):
        kc, vc = torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype)
        kn, vn = torch.empty(b, d, dtype=dtype), torch.empty(b, d, dtype=dtype)
        q, _, _ = t_gemv.int8_gemv_rope_kv(x, w8, s, cos, sin, pos, h, kc, vc, kn, vn,
                                           norm=norm, page_table=table)
        return q, kc, vc, kn, vn

    got, same = run(cdt), run(adt)
    assert torch.equal(got[0], same[0])
    for mixed, one in zip(got[1:], same[1:]):
        assert mixed.dtype == cdt and torch.equal(mixed, one.to(cdt))
    qkv = t_gemv.int8_gemv_reference(x, w8, s, norm=norm).float().numpy()
    rot = _np(j_rope.apply_rope(jnp.asarray(qkv.reshape(b, 1, h + 2, d)).astype(act),
                                jcos[:, None].astype(act), jsin[:, None].astype(act)))[:, 0]
    want_k = _np(jnp.asarray(rot[:, h]).astype(act).astype(cache))
    assert _rel(got[3].float(), want_k) <= TOL[act] + 2**-8  # one rounding to the cache
    assert torch.equal(got[4], _t(qkv[:, (h + 1) * d:]).to(adt).to(cdt))


def _chain_setup(act):
    # the MQA / head_dim-128 config of tests/test_decode_layer.py
    cfg = GemmaConfig(vocab_size=256, hidden_size=128, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
                      head_dim=128, max_position_embeddings=128)
    full = {"lm": j_gemma.init_params(jax.random.PRNGKey(0), cfg, getattr(jnp, act))}
    return cfg, j_qserve(full)["lm"]


@pytest.mark.parametrize("act,cache", PAIRS)
def test_layers_decode_fused_mixed_cache_matches_pallas(act, cache):
    """The decode chain (int8_gemv_rope_kv + decode_attention per layer, its
    plain versions on the CPU) over a cache of the other dtype against JAX's
    fused kernel in interpret mode on the same int8 tree: hidden state
    within CHAIN_TOL (the comment there says why fp32 over bf16 has its own
    bound), k_new / v_new in the cache dtype and written into the port's
    cache; bf16 over an fp32 cache is the bf16 cache's chain bit for bit."""
    cfg, jlm = _chain_setup(act)
    tlm = params_from_numpy(jax.tree.map(np.asarray, jlm), "cpu")
    rng = np.random.default_rng(3)
    n_layers, b, s_len, w, hd = 2, 2, 32, 16, 128
    x = rng.normal(size=(b, 1, cfg.hidden_size)).astype(np.float32)
    kc, vc = ((rng.normal(size=(n_layers, b, s_len, hd)) * 0.5).astype(np.float32)
              for _ in range(2))
    pos = np.array([7, 11], np.int32)
    valid = np.arange(w)[None] <= pos[:, None]
    valid[0, 3] = False
    cos, sin = j_rope.rope_cos_sin(jnp.asarray(pos + 1)[:, None], hd)
    jh, jk, jv = j_layer.layers_decode_fused(
        jnp.asarray(x).astype(act), j_layer.repack_layers(jlm["layers"]),
        jnp.asarray(kc).astype(cache), jnp.asarray(vc).astype(cache), jnp.asarray(pos),
        jnp.asarray(valid), cos[:, 0].astype(act), sin[:, 0].astype(act), w,
        cfg.num_attention_heads, hd, cfg.rms_norm_eps, interpret=True)
    adt, cdt = getattr(torch, act), getattr(torch, cache)

    def port(dtype):
        tkc, tvc = _t(kc).to(dtype), _t(vc).to(dtype)
        out = t_layer.layers_decode_fused(
            _t(x).to(adt), t_layer.repack_layers(tlm["layers"]), tkc, tvc, _t(pos), _t(valid),
            _t(np.asarray(cos[:, 0])).to(adt), _t(np.asarray(sin[:, 0])).to(adt), w,
            cfg.num_attention_heads, hd, cfg.rms_norm_eps)
        return out, tkc, tvc

    (th, tk, tv), tkc, tvc = port(cdt)
    assert th.dtype == adt and tk.dtype == tv.dtype == cdt == getattr(torch, str(jk.dtype))
    assert _rel(th.float(), _np(jh)) <= CHAIN_TOL[act]
    for got, want in ((tk, jk), (tv, jv)):
        assert _rel(got.float(), _np(want)) <= TOL[act] + 2**-8
    rows = torch.arange(b)
    assert torch.equal(tkc[:, rows, _t(pos).long()], tk)
    assert torch.equal(tvc[:, rows, _t(pos).long()], tv)
    if act == "bfloat16":
        (uh, uk, uv), _, _ = port(adt)
        assert torch.equal(th, uh) and torch.equal(tk, uk.to(cdt)) and torch.equal(tv, uv.to(cdt))


# ------------------------------------------------------------- engines ----
def _config():
    tiny = tiny_test_config()
    return PaliGemmaConfig(
        vision_config=tiny.vision_config,
        text_config=GemmaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=1, head_dim=128),
        projection_dim=128, hidden_size=128, image_token_index=510, vocab_size=512)


CFG = _config()


@functools.lru_cache(maxsize=None)
def _weights(act):
    """The JAX tree at ``act`` and its int8 tree, and the port's copies."""
    jp = j_pg.init_params(jax.random.PRNGKey(1), CFG)
    jp = jax.tree.map(lambda a: a.astype(act) if a.dtype == jnp.float32 else a, jp)
    jq = j_qserve(jp)
    to_port = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    return jp, jq, to_port(jp), to_port(jq)


def _inputs(b=2, n_txt=5, seed=1):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((b, CFG.vision_config.num_patches), CFG.image_token_index),
                          rng.integers(3, 100, (b, n_txt))], 1).astype(np.int32)
    return rng.normal(size=(b, 3, 28, 28)).astype(np.float32), ids, np.ones_like(ids)


@functools.lru_cache(maxsize=None)
def _jax_generate(act, cache):
    jp, jq, _, _ = _weights(act)
    pixels, ids, mask = _inputs()
    out = JaxEngine(jp, CFG, max_seq_len=64, use_flash=False, decode_params=jq, fused_layer=True,
                    cache_dtype=getattr(jnp, cache)).generate(
        jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=8,
        eos_token_id=-1)
    return np.asarray(out)


def _port_engine(act, cache):
    _, _, tp, tq = _weights(act)
    return PaliGemmaEngine(tp, CFG, max_seq_len=64, decode_params=tq, use_flash=True,
                           fused_layer=True, cache_dtype=getattr(torch, cache))


@pytest.mark.parametrize("act,cache", PAIRS)
def test_engine_fused_layer_matches_jax_fused_layer(act, cache):
    """PaliGemmaEngine on the kernel chain (plain versions on the CPU) over a
    cache of the other dtype: JAX's fused_layer engine's greedy tokens."""
    eng = _port_engine(act, cache)
    assert eng.fused_layer and eng.cache_dtype == getattr(torch, cache)
    pixels, ids, mask = _inputs()
    got = eng.generate(pixels, ids, mask, max_new_tokens=8, eos_token_id=-1)
    np.testing.assert_array_equal(got, _jax_generate(act, cache))


def test_bf16_over_fp32_cache_is_the_bf16_cache_bit_for_bit():
    """bf16 activations over an fp32 cache: every row the cache holds is a
    widened bf16 row, so the prefill and every decode step's logits are the
    bf16 cache's bit for bit, and so are the tokens."""
    pixels, ids, mask = _inputs()
    runs = []
    for cache in ("float32", "bfloat16"):
        eng = _port_engine("bfloat16", cache)
        logits, st = eng.prefill(pixels, ids, mask)
        steps = [logits]
        for _ in range(6):
            logits, st = eng.decode_step(logits.argmax(-1), st)
            steps.append(logits)
        runs.append((steps, st.cache["k"]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert runs[0][1].dtype == F32 and torch.equal(runs[0][1], runs[1][1].float())


def _req(cls, rid, seed, n_txt, max_new):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((CFG.vision_config.num_patches,), CFG.image_token_index),
                          rng.integers(3, 100, (n_txt,))]).astype(np.int32)
    return cls(request_id=rid, input_ids=ids, max_new_tokens=max_new, eos_token_id=-1,
               pixel_values=rng.normal(size=(3, 28, 28)).astype(np.float32))


SPECS = ((0, 1, 4, 6), (1, 2, 7, 4), (2, 3, 4, 5))
SERVE_KW = dict(max_slots=2, max_seq_len=32)


def _serve(eng, cls):
    reqs = [_req(cls, *s) for s in SPECS]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return {r.request_id: list(r.tokens) for r in reqs}


@functools.lru_cache(maxsize=None)
def _jax_served(act, cache, paged):
    jp, jq, _, _ = _weights(act)
    kw = dict(SERVE_KW, cache_dtype=getattr(jnp, cache), decode_params=jq, use_flash=False)
    if paged:  # JAX's default paged kernel: its fused Pallas tick, in interpret mode here
        eng = j_paged.PagedServingEngine(jp, CFG, page_size=16, **kw)
        assert eng.paged_kernel == "fused"
    else:
        eng = j_serving.ServingEngine(jp, CFG, fused_decode=True, **kw)
        assert eng.fused_decode
    return _serve(eng, j_serving.Request)


@pytest.mark.parametrize("act,cache", PAIRS)
@pytest.mark.parametrize("paged", [False, True])
def test_serving_engines_match_jax_fused_engines(act, cache, paged):
    """The dense ServingEngine's fused tick and the PagedServingEngine (their
    kernel chains' plain versions on the CPU) over a cache of the other
    dtype: the greedy tokens of JAX's dense fused_decode engine and of its
    default paged engine with the same cache dtype."""
    _, _, tp, tq = _weights(act)
    kw = dict(SERVE_KW, cache_dtype=getattr(torch, cache), decode_params=tq, use_flash=True,
              fused_decode=True)
    eng = (t_paged.PagedServingEngine(tp, CFG, page_size=16, **kw) if paged
           else t_serving.ServingEngine(tp, CFG, **kw))
    assert eng.fused_decode and eng.cache_dtype == getattr(torch, cache)
    assert _serve(eng, t_serving.Request) == _jax_served(act, cache, paged)


@pytest.mark.parametrize("name,act,cache", [
    ("int8_gemv_rope_kv_cache_fp32", BF, BF), ("int8_gemv_rope_kv_fp32_cache_bf16", F32, F32),
    ("decode_attention_cache_fp32", F32, F32), ("decode_attention_fp32_cache_bf16", BF, BF),
    ("paged_decode_attention_cache_fp32", BF, BF),
    ("paged_decode_attention_fp32_cache_bf16", F32, F32)])
def test_mixed_form_wrappers_take_their_pair_only(name, act, cache):
    """The wrapper of a mixed form refuses any other (activations, cache)
    pair, here a uniform one: it never casts."""
    wrapper = kernels.WRAPPERS[name]
    x, c = torch.zeros(2, 4, 16, dtype=act), torch.zeros(2, 8, 16, dtype=cache)
    args = {"int8_gemv_rope_kv": (x[0], None, None, None, None, None, 4, c),
            "decode_attention": (x, c, c, None, 1.0),
            "paged_decode_attention": (x, c[None, :, :, None], c[None, :, :, None], None, None)}
    with pytest.raises(ValueError, match=name):
        wrapper(*args[name.split("_cache")[0].replace("_fp32", "")])
