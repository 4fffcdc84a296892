"""Multi-LoRA serving in the port against the JAX package (CPU, fp32):
the bank (train/lora.stack_lora_bank), its per-row deltas
(models/gemma._lora_delta), the in-kernel LoRA operands of the decode
chains (kernels/decode_layer.repack_lora_bank_fused, lora_row_masks, and
``lora_pack`` / ``adapter_ids`` on the dense and paged chains, whose
wrappers run their plain versions on the CPU, against the TPU kernels in
Pallas interpret mode), and the serving engines with a bank against JAX's
multi-LoRA ServingEngine on a mixed base / adapter batch.

Also the signatures the port shares with the JAX package (PaliGemmaEngine,
ServingEngine, PagedServingEngine, siglip.encode): a call in JAX's order
binds every argument to the same name.

The config is tests/test_lora_fused.py's (hidden 128, head_dim 128, MQA,
2 layers, vocab 512); adapters are made from seeds with numpy and handed
to both frameworks."""

import functools
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig
from paligemma_tpu.kernels import decode_layer as j_layer
from paligemma_tpu.kernels import decode_layer_paged as j_dlp
from paligemma_tpu.models import gemma as j_gemma
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.models import siglip as j_siglip
from paligemma_tpu.ops import rope as j_rope
from paligemma_tpu.runtime import engine as j_engine
from paligemma_tpu.runtime import serving as j_serving
from paligemma_tpu.runtime import serving_paged as j_paged
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu.train import lora as j_lora
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.kernels import decode_layer as t_layer
from paligemma_tpu_torch.kernels import decode_layer_paged as t_dlp
from paligemma_tpu_torch.kernels import int8_gemv as t_gemv
from paligemma_tpu_torch.kernels import lora as t_klora
from paligemma_tpu_torch.models import gemma as t_gemma
from paligemma_tpu_torch.models import paligemma as t_pg
from paligemma_tpu_torch.models import siglip as t_siglip
from paligemma_tpu_torch.runtime import engine as t_engine
from paligemma_tpu_torch.runtime import serving as t_serving
from paligemma_tpu_torch.runtime import serving_paged as t_paged
from paligemma_tpu_torch.train import lora as t_lora

torch.set_num_threads(2)

CFG = PaliGemmaConfig(
    vision_config=SiglipVisionConfig(image_size=28, patch_size=14, hidden_size=32,
                                     intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4),
    text_config=GemmaConfig(vocab_size=512, hidden_size=128, intermediate_size=512,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=1, head_dim=128),
    projection_dim=128, hidden_size=128, image_token_index=510, vocab_size=512,
)
TC = CFG.text_config
TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def _dims(name):
    h, nq, hd, inter = TC.hidden_size, TC.num_attention_heads * TC.head_dim, TC.head_dim, \
        TC.intermediate_size
    return {"q": (h, nq), "k": (h, hd), "v": (h, hd), "o": (nq, h), "gate": (h, inter),
            "up": (h, inter), "down": (inter, h)}[name]


def _adapter_np(seed, rank=4, alpha=8.0, targets=TARGETS):
    """A LoRA tree with nonzero deltas (a trained adapter, not init_lora's
    b = 0), as numpy arrays."""
    rng = np.random.default_rng(seed)
    n = TC.num_hidden_layers
    layers = {}
    for name in targets:
        i, o = _dims(name)
        layers[name] = {
            "a": (rng.normal(size=(n, i, rank)) * i**-0.5).astype(np.float32),
            "b": (rng.normal(size=(n, rank, o)) * 0.05).astype(np.float32),
            "alpha": np.full((n,), alpha, np.float32),
        }
    return {"layers": layers}


def _jax_tree(t):
    return jax.tree.map(jnp.asarray, t)


def _port_tree(t):
    return params_from_numpy(jax.tree.map(np.asarray, t), "cpu")


ADAPTERS = {"x": _adapter_np(1), "y": _adapter_np(2)}


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ bank ----
@functools.lru_cache(maxsize=None)
def _banks():
    ads = [ADAPTERS["x"], ADAPTERS["y"]]
    jb = j_lora.stack_lora_bank([_jax_tree(a) for a in ads])
    tb = t_lora.stack_lora_bank([_port_tree(a) for a in ads])
    return jb, tb


def test_stack_lora_bank_equals_jax():
    jb, tb = _banks()
    assert set(tb["layers"]) == set(jb["layers"])
    for name, jp in jb["layers"].items():
        assert set(tb["layers"][name]) == set(jp)
        for key, want in jp.items():
            got = tb["layers"][name][key]
            assert tuple(got.shape) == want.shape, (name, key)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{name}.{key}")
    # bank row 0 is the zero adapter
    assert not tb["layers"]["q"]["a"][:, 0].any() and not tb["layers"]["q"]["alpha"][:, 0].any()


def test_stack_lora_bank_dtype_cast():
    jb = j_lora.stack_lora_bank([_jax_tree(ADAPTERS["x"])], dtype=jnp.bfloat16)
    tb = t_lora.stack_lora_bank([_port_tree(ADAPTERS["x"])], dtype=torch.bfloat16)
    got, want = tb["layers"]["o"]["b_cat"], jb["layers"]["o"]["b_cat"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("case", ["rank", "targets", "empty"])
def test_stack_lora_bank_refusals(case):
    if case == "empty":
        with pytest.raises(ValueError, match="at least one adapter"):
            t_lora.stack_lora_bank([])
        return
    other = (_adapter_np(3, rank=2) if case == "rank"
             else _adapter_np(3, targets=("q", "k", "v", "o")))
    match = "rank/shape" if case == "rank" else "targets"
    with pytest.raises(ValueError, match=match):
        j_lora.stack_lora_bank([_jax_tree(ADAPTERS["x"]), _jax_tree(other)])
    with pytest.raises(ValueError, match=match):
        t_lora.stack_lora_bank([_port_tree(ADAPTERS["x"]), _port_tree(other)])


@pytest.mark.parametrize("path", ["concat", "gather"])
def test_lora_delta_bank_matches_jax(path):
    """gemma._lora_delta on one layer's bank slice with per-row ids, through
    the concat basis and through the per-row gather (the bank without its
    a_cat / b_cat)."""
    jb, tb = _banks()
    rng = np.random.default_rng(4)
    ids = np.array([0, 1, 2, 1], np.int32)
    for name in TARGETS:
        y = rng.normal(size=(4, 3, _dims(name)[0])).astype(np.float32)
        jl = {k: v[0] for k, v in jb["layers"][name].items()}
        tl = {k: v[0] for k, v in tb["layers"][name].items()}
        if path == "gather":
            jl = {k: jl[k] for k in ("a", "b", "alpha")}
            tl = {k: tl[k] for k in ("a", "b", "alpha")}
        want = _np(j_gemma._lora_delta(jnp.asarray(y), {name: jl, "__ids__": jnp.asarray(ids)},
                                       name))
        got = t_gemma._lora_delta(_t(y), {name: tl, "__ids__": _t(ids)}, name).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
        assert not got[0].any()  # the base row: a delta of exactly 0


def test_lora_with_ids_matches_jax():
    jb, tb = _banks()
    ids = np.array([2, 0, 1], np.int32)
    jw = j_pg.lora_with_ids({**jb, "__fused_pack__": {}}, jnp.asarray(ids), 2)
    tw = t_pg.lora_with_ids({**tb, "__fused_pack__": {}}, _t(ids), 2)
    np.testing.assert_array_equal(tw["layers"]["__ids__"].numpy(), np.asarray(jw["layers"]["__ids__"]))
    assert "__fused_pack__" in tw and "__ids__" not in tb["layers"]
    assert t_pg.lora_with_ids(tb, None, 2) is tb


# ------------------------------------------------------ kernel operands ----
@functools.lru_cache(maxsize=None)
def _jax_lm():
    return j_qserve({"lm": j_gemma.init_params(jax.random.PRNGKey(0), TC, jnp.float32)})["lm"]


def _packs(bank_pair=None):
    jb, tb = bank_pair or _banks()
    # the TPU pack follows the TPU kernel's MLP chunks
    _, nc, _, bs = j_layer.repack_layers(_jax_lm()["layers"])["mlp"]["gate_blk"].shape
    jp = j_layer.repack_lora_bank_fused(jb["layers"], nc=nc, bs=bs,
                                        n_heads=TC.num_attention_heads, head_dim=TC.head_dim,
                                        hidden=TC.hidden_size)
    tp = t_layer.repack_lora_bank_fused(tb["layers"], n_heads=TC.num_attention_heads,
                                        head_dim=TC.head_dim, hidden=TC.hidden_size,
                                        intermediate=TC.intermediate_size)
    return jp, tp


def test_repack_lora_bank_fused_equals_jax_after_reshape():
    """The port's pack holds the TPU pack's numbers in the port's layout:
    qkv_b keeps each column's own target rows (the TPU's is block-diagonal),
    and the gate / up / down blocks are not chunk-major."""
    jp, tp = _packs()
    n_layers, g, nq = TC.num_hidden_layers, tp["o_b"].shape[1], TC.num_attention_heads * TC.head_dim
    hd, inter = TC.head_dim, TC.intermediate_size
    assert g % 8 == 0 and g == jp["o_b"].shape[1] and tp["g_true"] == jp["g_true"] == 12
    assert tp["rank"] == jp["rank"] == 4
    jqb = np.asarray(jp["qkv_b"])
    want_qkv_b = np.concatenate([jqb[:, :g, :nq], jqb[:, g:2 * g, nq:nq + hd],
                                 jqb[:, 2 * g:, nq + hd:]], axis=-1)
    assert not jqb[:, :g, nq:].any() and not jqb[:, g:2 * g, :nq].any()  # block-diagonal
    unchunk = lambda a: np.asarray(a).transpose(0, 2, 1, 3).reshape(n_layers, g, inter)  # noqa: E731
    want = {
        "qkv_a": np.asarray(jp["qkv_a"]), "qkv_b": want_qkv_b, "o_a": np.asarray(jp["o_a"]),
        "o_b": np.asarray(jp["o_b"]), "gu_a": np.asarray(jp["gu_a"]),
        "gu_b": np.concatenate([unchunk(jp["gate_b"]), unchunk(jp["up_b"])], axis=-1),
        "down_a": np.asarray(jp["down_a"]).reshape(n_layers, inter, g),
        "down_b": np.asarray(jp["down_b"]),
    }
    for key, w in want.items():
        assert tp[key].is_contiguous(), key
        np.testing.assert_array_equal(tp[key].numpy(), w, err_msg=key)


def test_repack_lora_bank_fused_missing_targets_are_zero():
    ads = [_adapter_np(5, targets=("q", "v", "down")), _adapter_np(6, targets=("q", "v", "down"))]
    jp, tp = _packs((j_lora.stack_lora_bank([_jax_tree(a) for a in ads]),
                     t_lora.stack_lora_bank([_port_tree(a) for a in ads])))
    g = tp["o_b"].shape[1]
    assert not tp["o_a"].any() and not tp["gu_b"].any() and not tp["qkv_a"][..., g:2 * g].any()
    assert tp["down_b"].any()
    np.testing.assert_array_equal(tp["qkv_a"].numpy(), np.asarray(jp["qkv_a"]))


def test_lora_row_masks_equal_jax():
    ids = np.array([0, 2, 1, 3, 2], np.int32)
    for g, rank in ((16, 4), (24, 8)):
        want = j_layer.lora_row_masks(jnp.asarray(ids), g, rank, jnp.float32)
        got = t_layer.lora_row_masks(_t(ids), g, rank, torch.float32)
        for gm, wm in zip(got, want):
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        # the shrink's in-kernel mask is the same mask over each target's block
        np.testing.assert_array_equal(
            t_klora.block_mask(_t(ids), 3 * g, g, rank, torch.float32).numpy(),
            np.asarray(want[2]))


def test_lora_shrink_and_expand_plain_versions():
    """lora_shrink's plain version is the TPU kernel's cast(x @ cast(A)) *
    mask; the GEMV epilogue adds z @ B per target block."""
    rng = np.random.default_rng(7)
    b, k, g, rank = 3, 64, 8, 4
    x = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(torch.bfloat16)
    a = torch.from_numpy(rng.normal(size=(k, 3 * g)).astype(np.float32))
    for t in range(3):
        a[:, t * g:t * g + rank] = 0  # block 0 of each target: the zero adapter
    ids = torch.tensor([0, 1, 1], dtype=torch.int32)
    z = t_klora.lora_shrink(x, a, ids, rank, g)
    want = (x.float() @ a.to(torch.bfloat16).float()).to(torch.bfloat16)
    mask = torch.zeros(b, 3 * g)
    for r, i in enumerate(ids.tolist()):
        for t in range(3):
            mask[r, t * g + i * rank:t * g + (i + 1) * rank] = 1
    assert torch.equal(z, want * mask.to(torch.bfloat16))
    assert not z[0].any()
    n = 40
    lb = torch.from_numpy(rng.normal(size=(g, n)).astype(np.float32))
    delta = t_gemv.lora_expand_reference(z, lb, (16, 24), torch.bfloat16)
    bq = lb.to(torch.bfloat16).float()
    ref = torch.cat([z[:, :g].float() @ bq[:, :16], z[:, g:2 * g].float() @ bq[:, 16:24],
                     z[:, 2 * g:].float() @ bq[:, 24:]], dim=-1)
    assert torch.equal(delta, ref)
    w8 = torch.randint(-127, 128, (k, n), dtype=torch.int8)
    s = torch.rand(n) * 1e-2
    base = t_gemv.int8_gemv(x, w8, s)
    with_lora = t_gemv.int8_gemv(x, w8, s, lora=(z, lb, (16, 24)))
    assert torch.equal(with_lora, base + delta.to(torch.bfloat16))
    assert torch.equal(with_lora[0], base[0])  # base row: delta exactly 0


def _layer_inputs():
    jlm = _jax_lm()
    return TC, jlm, _port_tree(jlm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_decode_fused_with_lora_matches_pallas(dtype):
    """The dense chain with the pack (plain versions on the CPU) against
    the TPU kernel with lora=True in interpret mode: rows (base, x, y)
    at different cache positions; hidden and fresh K/V within 2e-2 of the
    largest element, and the adapters move the hidden state."""
    cfg, jlm, tlm = _layer_inputs()
    jpack, tpack = _packs()
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(3)
    n_layers, b, s_len, w, hd = 2, 3, 32, 16, 128
    x = rng.normal(size=(b, 1, cfg.hidden_size)).astype(np.float32)
    kc = (rng.normal(size=(n_layers, b, s_len, hd)) * 0.5).astype(np.float32)
    vc = (rng.normal(size=(n_layers, b, s_len, hd)) * 0.5).astype(np.float32)
    pos = np.array([7, 11, 4], np.int32)
    valid = np.arange(w)[None] <= pos[:, None]
    ids = np.array([0, 1, 2], np.int32)
    cos, sin = j_rope.rope_cos_sin(jnp.asarray(pos + 1)[:, None], hd)
    jh, jk, jv = j_layer.layers_decode_fused(
        jnp.asarray(x, jd), j_layer.repack_layers(jlm["layers"]), jnp.asarray(kc, jd),
        jnp.asarray(vc, jd), jnp.asarray(pos), jnp.asarray(valid), cos[:, 0], sin[:, 0], w,
        cfg.num_attention_heads, hd, cfg.rms_norm_eps, interpret=True, lora_pack=jpack,
        adapter_ids=jnp.asarray(ids))
    args = (t_layer.repack_layers(tlm["layers"]), _t(kc).to(td), _t(vc).to(td), _t(pos),
            _t(valid), _t(np.asarray(cos[:, 0])), _t(np.asarray(sin[:, 0])), w,
            cfg.num_attention_heads, hd, cfg.rms_norm_eps)
    th, tk, tv = t_layer.layers_decode_fused(_t(x).to(td), *args, lora_pack=tpack,
                                             adapter_ids=_t(ids))
    for got, want in ((th, jh), (tk, jk), (tv, jv)):
        want = _np(want)
        assert got.shape == want.shape
        assert np.max(np.abs(got.float().numpy() - want)) / np.max(np.abs(want)) < 2e-2
    base, _, _ = t_layer.layers_decode_fused(_t(x).to(td), *args)
    assert torch.equal(base[0], th[0])  # bank row 0: exactly the base model
    assert not torch.equal(base[1:], th[1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_decode_fused_with_lora_eight_rows_matches_pallas(dtype):
    """The LoRA tick at a full batch tile of the card's kernels (8 rows,
    every bank row twice or more, positions across the window) against the
    TPU kernel with lora=True in interpret mode; hidden and fresh K/V
    within 2e-2 of the largest element (bf16: the kernels round z to bf16
    where the TPU kernel does, after fp32 sums in another order); base rows
    equal the chain without the bank."""
    cfg, jlm, tlm = _layer_inputs()
    jpack, tpack = _packs()
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(11)
    n_layers, b, s_len, w, hd = 2, 8, 32, 32, 128
    x = rng.normal(size=(b, 1, cfg.hidden_size)).astype(np.float32)
    kc = (rng.normal(size=(n_layers, b, s_len, hd)) * 0.5).astype(np.float32)
    vc = (rng.normal(size=(n_layers, b, s_len, hd)) * 0.5).astype(np.float32)
    pos = np.array([7, 11, 4, 31, 0, 19, 23, 16], np.int32)
    valid = np.arange(w)[None] <= pos[:, None]
    ids = np.array([0, 1, 2, 0, 2, 1, 1, 0], np.int32)
    cos, sin = j_rope.rope_cos_sin(jnp.asarray(pos + 1)[:, None], hd)
    jh, jk, jv = j_layer.layers_decode_fused(
        jnp.asarray(x, jd), j_layer.repack_layers(jlm["layers"]), jnp.asarray(kc, jd),
        jnp.asarray(vc, jd), jnp.asarray(pos), jnp.asarray(valid), cos[:, 0], sin[:, 0], w,
        cfg.num_attention_heads, hd, cfg.rms_norm_eps, interpret=True, lora_pack=jpack,
        adapter_ids=jnp.asarray(ids))
    args = (t_layer.repack_layers(tlm["layers"]), _t(kc).to(td), _t(vc).to(td), _t(pos),
            _t(valid), _t(np.asarray(cos[:, 0])), _t(np.asarray(sin[:, 0])), w,
            cfg.num_attention_heads, hd, cfg.rms_norm_eps)
    th, tk, tv = t_layer.layers_decode_fused(_t(x).to(td), *args, lora_pack=tpack,
                                             adapter_ids=_t(ids))
    for got, want in ((th, jh), (tk, jk), (tv, jv)):
        want = _np(want)
        assert got.shape == want.shape
        assert np.max(np.abs(got.float().numpy() - want)) / np.max(np.abs(want)) < 2e-2
    base, _, _ = t_layer.layers_decode_fused(_t(x).to(td), *args)
    rows = torch.from_numpy(ids == 0)
    assert torch.equal(base[rows], th[rows]) and not torch.equal(base[~rows], th[~rows])


@pytest.mark.parametrize("frag", [False, True])
def test_layers_decode_fused_paged_with_lora_matches_pallas(frag):
    cfg, jlm, tlm = _layer_inputs()
    jpack, tpack = _packs()
    rng = np.random.default_rng(5)
    n_layers, b, ps, hd, n_pages, pb = 2, 3, 16, 128, 9, 2
    x = rng.normal(size=(b, 1, cfg.hidden_size)).astype(np.float32)
    kp = (rng.normal(size=(n_layers, n_pages, ps, hd)) * 0.5).astype(np.float32)
    vp = (rng.normal(size=(n_layers, n_pages, ps, hd)) * 0.5).astype(np.float32)
    table = np.array([[5, 2, 0, 0], [7, 3, 0, 0], [8, 6, 0, 0]] if frag
                     else [[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0]], np.int32)
    pos = np.array([5, 17, 20], np.int32)
    ids = np.array([2, 0, 1], np.int32)
    cos, sin = j_rope.rope_cos_sin(jnp.asarray(pos + 1)[:, None], hd)
    jh, jk, jv = j_dlp.layers_decode_fused_paged(
        jnp.asarray(x), j_layer.repack_layers(jlm["layers"]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table[:, :pb]), jnp.asarray(pos), cos[:, 0], sin[:, 0],
        cfg.num_attention_heads, hd, cfg.rms_norm_eps, interpret=True, lora_pack=jpack,
        adapter_ids=jnp.asarray(ids))
    th, tk, tv = t_dlp.layers_decode_fused_paged(
        _t(x), t_layer.repack_layers(tlm["layers"]), _t(kp), _t(vp), _t(table), _t(pos),
        _t(np.asarray(cos[:, 0])), _t(np.asarray(sin[:, 0])), cfg.num_attention_heads, hd,
        cfg.rms_norm_eps, pages_bucket=pb, lora_pack=tpack, adapter_ids=_t(ids))
    for got, want in ((th, jh), (tk, jk), (tv, jv)):
        want = _np(want)
        assert got.shape == want.shape
        assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) < 2e-2


def test_lora_pack_and_ids_go_together():
    cfg, _, tlm = _layer_inputs()
    _, tpack = _packs()
    with pytest.raises(ValueError, match="go together"):
        t_layer.layers_decode_fused(torch.zeros(1, 1, 128), tlm["layers"],
                                    torch.zeros(2, 1, 8, 128), torch.zeros(2, 1, 8, 128),
                                    torch.zeros(1, dtype=torch.int32),
                                    torch.ones(1, 8, dtype=torch.bool), torch.ones(1, 128),
                                    torch.zeros(1, 128), 8, 4, 128, 1e-6, lora_pack=tpack)


# --------------------------------------------------------------- serving ----
@functools.lru_cache(maxsize=None)
def _weights():
    jp = j_pg.init_params(jax.random.PRNGKey(0), CFG)
    jq = j_qserve(jp)
    to_port = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    return jp, jq, to_port(jp), to_port(jq)


def _req(cls, rid, seed, n_txt, max_new, lora=None, sample=False):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((CFG.vision_config.num_patches,), CFG.image_token_index),
                          rng.integers(3, 100, (n_txt,))]).astype(np.int32)
    pixels = rng.normal(size=(3, 28, 28)).astype(np.float32)
    return cls(request_id=rid, input_ids=ids, pixel_values=pixels, max_new_tokens=max_new,
               do_sample=sample, eos_token_id=-1, lora=lora)


MIXED = ((0, 1, 6, 8, None), (1, 2, 5, 8, "x"), (2, 3, 7, 8, "y"), (3, 4, 4, 8, "x"))


def _serve(eng, cls, specs=MIXED):
    reqs = [_req(cls, *spec) for spec in specs]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return {r.request_id: list(r.tokens) for r in reqs}


def _bf16_leaves(tree):
    """The adapter tree with every float leaf rounded to bf16 (a bank saved
    in bf16), as JAX arrays."""
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)


@functools.lru_cache(maxsize=None)
def _jax_mixed(bank_bf16=False):
    jp, jq, _, _ = _weights()
    tree = _bf16_leaves if bank_bf16 else _jax_tree
    eng = j_serving.ServingEngine(jp, CFG, max_slots=4, max_seq_len=64, use_flash=False,
                                  decode_params=jq, fused_decode=False, sync_every=2,
                                  lora_bank={n: tree(a) for n, a in ADAPTERS.items()})
    return _serve(eng, j_serving.Request)


def _port_bank(bank_bf16=False):
    if bank_bf16:  # the same bf16 values as JAX's bank
        return {n: params_from_numpy(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), _bf16_leaves(a)), "cpu",
            torch.bfloat16) for n, a in ADAPTERS.items()}
    return {n: _port_tree(a) for n, a in ADAPTERS.items()}


@pytest.mark.parametrize("engine,path", [("dense", "plain"), ("dense", "kernel"),
                                         ("paged", "plain"), ("paged", "kernel"),
                                         ("paged", "multi"), ("dense", "kernel-bf16-bank"),
                                         ("paged", "kernel-bf16-bank")])
def test_serving_with_bank_matches_jax(engine, path):
    """Rows (base, x, y, x) in one batch: every request's tokens equal JAX's
    multi-LoRA engine's (plain tick, int8 decode), all at fp32 (the
    ``--dtype float32`` arithmetic). "kernel": the decode chain with the
    bank's kernel operands (plain versions on the CPU); "kernel-bf16-bank":
    the same with the adapters held in bf16 in both frameworks (the fp32
    shrink and expand over a bf16 A and B, widened exactly)."""
    _, _, tp, tq = _weights()
    kernel = path != "plain"
    bank_bf16 = path.endswith("bf16-bank")
    kw = dict(max_slots=4, max_seq_len=64, use_flash=False, decode_params=tq,
              fused_decode=kernel, sync_every=2, lora_bank=_port_bank(bank_bf16))
    if engine == "dense":
        eng = t_serving.ServingEngine(tp, CFG, **kw)
    else:
        eng = t_paged.PagedServingEngine(tp, CFG, page_size=16, n_pages=24,
                                         paged_kernel="multi" if path == "multi" else "fused",
                                         **kw)
    chain = path.startswith("kernel")
    assert (eng._lora_fused_pack is not None) == chain
    if bank_bf16:
        assert eng._lora_fused_pack["qkv_a"].dtype == torch.bfloat16
    got = _serve(eng, t_serving.Request)
    want = _jax_mixed(bank_bf16)
    for rid in want:
        assert got[rid] == want[rid], rid


def test_paged_preemption_keeps_adapters():
    """A pool that preempts: each request is re-seated with its own adapter,
    so every row keeps the tokens of the unpreempted dense run."""
    _, _, tp, tq = _weights()
    kw = dict(max_slots=4, max_seq_len=64, use_flash=False, decode_params=tq,
              fused_decode=True, sync_every=2, lora_bank=_port_bank())
    specs = tuple((i, 10 + i, 6 + i % 3, 30, (None, "x", "y")[i % 3]) for i in range(4))
    dense = _serve(t_serving.ServingEngine(tp, CFG, **kw), t_serving.Request, specs)
    eng = t_paged.PagedServingEngine(tp, CFG, page_size=16, n_pages=7, **kw)
    got = _serve(eng, t_serving.Request, specs)
    assert eng.preemptions > 0
    assert got == dense


def _merged(tp, name):
    return {**tp, "lm": t_lora.merge_lora(tp["lm"], _port_tree(ADAPTERS[name]))}


def test_bank_rows_match_merged_single_adapter():
    """Each bank row's tokens equal a single-adapter engine on merge_lora'd
    weights (tests/test_multilora.py:75), on the port's plain path."""
    _, _, tp, _ = _weights()
    kw = dict(max_slots=2, max_seq_len=64, use_flash=False, fused_decode=False)
    specs = ((0, 1, 6, 8, "x"), (1, 2, 9, 5, "y"), (2, 3, 4, 7, "x"))
    got = _serve(t_serving.ServingEngine(tp, CFG, lora_bank=_port_bank(), **kw),
                 t_serving.Request, specs)
    for rid, seed, n_txt, max_new, name in specs:
        want = _serve(t_serving.ServingEngine(_merged(tp, name), CFG, **kw), t_serving.Request,
                      ((rid, seed, n_txt, max_new, None),))
        assert got[rid] == want[rid], rid
    base = _serve(t_serving.ServingEngine(tp, CFG, **kw), t_serving.Request,
                  ((0, 1, 6, 8, None),))
    assert base[0] != got[0]  # the adapters change tokens


def test_unknown_adapter_rejected():
    _, _, tp, _ = _weights()
    eng = t_serving.ServingEngine(tp, CFG, max_slots=2, max_seq_len=64, use_flash=False,
                                  fused_decode=False, lora_bank=_port_bank())
    with pytest.raises(ValueError, match="unknown LoRA adapter"):
        eng.submit(_req(t_serving.Request, 0, 1, 4, 4, lora="nope"))
    eng2 = t_paged.PagedServingEngine(tp, CFG, max_slots=2, max_seq_len=64, page_size=16,
                                      use_flash=False, fused_decode=False)
    with pytest.raises(ValueError, match="unknown LoRA adapter"):
        eng2.submit(_req(t_serving.Request, 0, 1, 4, 4, lora="x"))
    assert not eng.has_work and not eng2.has_work


def test_sampling_composes_with_lora():
    _, _, tp, tq = _weights()
    for fused in (False, True):
        eng = t_serving.ServingEngine(tp, CFG, max_slots=2, max_seq_len=64, use_flash=False,
                                      decode_params=tq, fused_decode=fused,
                                      lora_bank=_port_bank())
        got = _serve(eng, t_serving.Request, ((0, 1, 5, 6, "x"), (1, 2, 5, 6, None)))
        assert [len(t) for t in got.values()] == [6, 6]
        sampled = _req(t_serving.Request, 0, 1, 5, 6, lora="x", sample=True)
        eng.submit(sampled)
        eng.run_to_completion()
        assert len(sampled.tokens) == 6


def test_kernel_tick_equals_plain_tick_in_fp32():
    """With fp32 activations the kernel decode (the chain with the bank's
    operands) computes the plain tick's function: adapters with deltas
    larger than the base (B std 0.5), rows (base, x, y), logits within 1e-5
    of the largest. In bf16 the two round z at different places (the TPU
    kernel's cast of the adapter basis; JAX's XLA path keeps it in fp32)."""
    _, _, tp, tq = _weights()
    bank = {n: _port_tree(_adapter_np(20 + i, rank=8)) for i, n in enumerate("xy")}
    for ad in bank.values():
        for p in ad["layers"].values():
            p["b"] = p["b"] * 10.0
    kw = dict(max_slots=3, max_seq_len=64, use_flash=False, decode_params=tq, lora_bank=bank)
    ek = t_serving.ServingEngine(tp, CFG, fused_decode=True, **kw)
    ep = t_serving.ServingEngine(tp, CFG, fused_decode=False, **kw)
    ids = torch.tensor([0, 1, 2], dtype=torch.int32)
    caches = [t_gemma.init_kv_cache(TC, 3, 64, torch.float32, device="cpu") for _ in range(2)]
    rng = np.random.default_rng(11)
    init = torch.from_numpy(rng.normal(size=caches[0]["k"][:, :, :8].shape).astype(np.float32))
    for c in caches:
        c["k"][:, :, :8] = init
        c["v"][:, :, :8] = init * 0.5
    valid = torch.zeros(3, 64, dtype=torch.bool)
    valid[:, :8] = True
    tok = torch.tensor([5, 9, 13])
    for t in range(4):
        pos = torch.full((3,), 8 + t, dtype=torch.int32)
        valid[:, 8 + t] = True
        step = dict(cache_pos=pos, kv_valid=valid, position_ids=pos + 1, adapter_ids=ids)
        lk, _ = t_pg.decode_step(ek.decode_params, CFG, tok, caches[0], fused_layer=True,
                                 lora=ek._lora_arg(), **step)
        lp, _ = t_pg.decode_step(ep.decode_params, CFG, tok, caches[1], fused_layer=False,
                                 lora=ep._lora_arg(), **step)
        assert float((lk - lp).abs().max()) <= 1e-5 * float(lp.abs().max())
        tok = lp.argmax(-1)


def test_kernel_tick_without_pack_raises():
    """The kernel decode takes a bank only with its kernel operands."""
    _, _, _, tq = _weights()
    _, tb = _banks()
    cache = t_gemma.init_kv_cache(TC, 1, 16, torch.float32, device="cpu")
    tok = torch.zeros(1, dtype=torch.int32)
    valid = torch.ones(1, 16, dtype=torch.bool)
    with pytest.raises(ValueError, match="__fused_pack__"):
        t_pg.decode_step_greedy(tq, CFG, tok, cache, 3, valid, tok + 4, fused_layer=True,
                                lora=tb, adapter_ids=tok)


def test_tensor_parallel_with_bank_raises():
    """A mesh with a data axis: the dense engine raises with the JAX
    engine's reason (slots are the batch), the paged engine takes the bank
    whole on each data shard (pure DP). Under a model axis (a hand-built
    Mesh names the rank; no collective runs at construction) both engines
    keep this rank's shard of the stacked bank (core/mesh.shard_lora)."""
    from paligemma_tpu_torch.core.mesh import Mesh, shard_lora

    _, _, tp, _ = _weights()
    bank = _port_bank()
    with pytest.raises(ValueError, match="pure TP"):
        t_serving.ServingEngine(tp, CFG, max_slots=2, max_seq_len=64,
                                mesh=Mesh(model=1, data=2), lora_bank=bank)
    dp = t_paged.PagedServingEngine(tp, CFG, max_slots=2, max_seq_len=64, page_size=16,
                                    mesh=Mesh(model=1, data=2), lora_bank=bank,
                                    fused_decode=False)
    whole = t_lora.stack_lora_bank([bank[n] for n in bank])
    for name, p in whole["layers"].items():
        for key, t in p.items():
            assert torch.equal(dp.lora_bank["layers"][name][key], t), (name, key)
    for cls in (t_serving.ServingEngine, t_paged.PagedServingEngine):
        mesh = Mesh(model=2, rank=1)
        eng = cls(tp, CFG, max_slots=2, max_seq_len=64, mesh=mesh, lora_bank=bank,
                  fused_decode=False)
        want = shard_lora(t_lora.stack_lora_bank([bank[n] for n in bank]), mesh)
        for name, p in want["layers"].items():
            for key, t in p.items():
                assert torch.equal(eng.lora_bank["layers"][name][key], t), (name, key)


# ---------------------------------------------------------- signatures ----
# A JAX parameter the port takes under another name, in the same slot: the
# port's names for it, the first one it has being the one compared
TRANSLATED = {"key": ("generator",), "rng": ("generator",), "devices": ("group",),
              "packed": ("layers", "mlp"), "G": ("g",)}
# Functions whose operands differ in kind from JAX's after their shared
# leading parameters: (JAX's operands that differ, why). Those take no
# translation, and every parameter after the last one shared is
# keyword-only
OPERANDS_DIFFER = {
    "core.mesh.Mesh.__init__": (("devices", "axis_names", "axis_types"),
                                "JAX's Mesh holds a device array and axis names, the port's "
                                "one rank's place in a torch.distributed group"),
    "core.mesh.make_mesh": (("devices",), "JAX's devices are jax devices, the port's group a "
                                          "torch.distributed process group"),
    "kernels.decode_layer_tp.attn_decode_tp": (("bias", "posmask", "window"),
                                               "JAX's bias and posmask arrays against the "
                                               "port's valid mask and cache positions"),
    "kernels.decode_layer_paged_tp.attn_decode_paged_tp": (
        ("start", "contig", "pt", "bias", "posmask"),
        "JAX's start, contig, pt, bias and posmask against the port's page table and write "
        "positions"),
}
# every public function of the port with a JAX namesake beyond the engines
# and siglip.encode (C5)
C5_FUNCTIONS = (
    "models.paligemma.prefill", "models.paligemma.decode_step",
    "models.paligemma.decode_step_greedy", "models.paligemma.decode_step_paged",
    "models.paligemma.decode_step_greedy_paged", "cli.infer.main",
    "models.paligemma.decode_verify", "models.paligemma.decode_verify_paged",
    "models.gemma.forward_paged_verify", "ops.ngram.propose_ngram",
    "runtime.engine.PaliGemmaEngine.generate_spec",
    "models.gemma.forward", "models.gemma.forward_paged_decode",
    "models.gemma.forward_paged_decode_fused", "models.gemma.init_kv_cache",
    "models.gemma.lm_head", "runtime.paged_cache.PagedKVCache.__init__",
    "train.trainer.Trainer.__init__", "train.lora.init_lora",
    "kernels.decode_head.head_argmax_fused", "kernels.decode_head.reference_head_argmax",
    "kernels.paged_attention.paged_decode_attention",
    "kernels.paged_attention.paged_decode_attention_multi",
    "kernels.paged_attention.paged_decode_attention_batched",
    "kernels.paged_attention.paged_decode_attention_runs",
    "kernels.decode_mlp.mlp_decode_fused", "kernels.decode_mlp.reference_mlp",
    "kernels.decode_layer.layers_decode_fused", "kernels.decode_layer.repack_lora_bank_fused",
    "kernels.decode_layer.lora_row_masks", "kernels.decode_layer_paged.supported",
    "kernels.decode_layer_paged.layers_decode_fused_paged",
    "kernels.decode_layer_paged_tp.supported", "ops.sampling.sample",
    "ops.sampling.sample_top_p", "checkpoints.hf_loader.params_from_state_dict",
    "checkpoints.hf_loader.load_state_dict_from_safetensors",
    "checkpoints.hf_loader.load_hf_model", "checkpoints.hf_export.state_dict_from_params",
    "checkpoints.hf_export.export_hf_checkpoint", "processing.images.process_images_host",
    "processing.images.preprocess_device", "processing.native.preprocess_images_native",
    "processing.processor.PaliGemmaProcessor.__init__", "processing.grammar.compile_regex",
    "processing.grammar.compile_choices", "processing.grammar.compile_token_dfa",
    "processing.grammar.token_strings_from_tokenizer", "cli.serve.main",
    "cli.serve.build_server", "cli.serve._Server.__init__", "cli.serve._Server.run_batch",
    "cli.serve._Server.serve_http", "cli.finetune.main", "train.data.json2token",
    "train.data.token2json", "train.data.normalized_edit_distance", "train.data.collate",
    "train.hf_dataset.HFDatasetAdapter.__init__", "train.hf_dataset.load_hf_rows",
    "runtime.logging.MetricsLogger.__init__", "runtime.logging.MetricsLogger.log",
    "processing.mask_vae.reconstruct_masks", "processing.mask_vae.to_unit_range",
    "processing.mask_vae.init_params", "processing.mask_vae.load_vae_oid_npz",
    "ops.activations.geglu", "runtime.quantize.quantized_bytes", "models.siglip.init_params",
    "models.gemma.init_params", "models.paligemma.init_params", "kernels.quant.matmul_any",
    "core.mesh.single_device_mesh", "core.mesh.param_specs", "core.mesh.lora_specs",
    "core.mesh.batch_spec", "core.mesh.kv_cache_specs",
    # the training half of the mesh: the mesh= parameters of forward_train
    # (gemma's in JAX's slot, paligemma's the port's own), FSDP's specs, the
    # loss's data axis and core/multihost
    "models.gemma.forward_train", "models.paligemma.forward_train",
    "core.mesh.fsdp_param_specs", "train.losses.causal_lm_loss",
    "core.multihost.initialize", "core.multihost.make_multihost_mesh",
    "core.multihost.global_batch_from_local", "core.multihost.process_local_rows",
    # the paged attention's plain version, which casts the pages to q's
    # dtype for a pool of the other dtype (the mixed forms' own wrappers have
    # no JAX namesake)
    "kernels.paged_attention.reference_paged_decode_attention",
    *OPERANDS_DIFFER,
)


def _resolve(package, path):
    """``package.path``: the longest importable module prefix, then attributes."""
    parts = path.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join([package, *parts[:cut]]))
        except ImportError:
            continue
        for name in parts[cut:]:
            obj = getattr(obj, name)
        return obj
    raise ImportError(path)


def _positional(fn):
    kinds = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    return [p.name for p in inspect.signature(fn).parameters.values() if p.kind in kinds]


def _names(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind not in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)]


@pytest.mark.parametrize("name,jax_fn,port_fn", [
    ("PaliGemmaEngine", j_engine.PaliGemmaEngine.__init__, t_engine.PaliGemmaEngine.__init__),
    ("ServingEngine", j_serving.ServingEngine.__init__, t_serving.ServingEngine.__init__),
    ("PagedServingEngine", j_paged.PagedServingEngine.__init__,
     t_paged.PagedServingEngine.__init__),
    ("siglip.encode", j_siglip.encode, t_siglip.encode),
] + [(f, _resolve("paligemma_tpu", f), _resolve("paligemma_tpu_torch", f))
     for f in C5_FUNCTIONS])
def test_signature_follows_jax_order(name, jax_fn, port_fn):
    """A call in JAX's order binds each argument to the same name in the
    port: the port's positional parameters are a prefix of JAX's, every
    other name they share is keyword-only in the port, in JAX's relative
    order, and the port's own names are keyword-only. A JAX name counts as
    the port's translation of it (TRANSLATED), except where the operands
    differ in kind (OPERANDS_DIFFER)."""
    port_all = _names(port_fn)

    def same_slot(n):
        if n in OPERANDS_DIFFER.get(name, ((), ""))[0]:
            return n
        return next((t for t in TRANSLATED.get(n, ()) if t in port_all), n)

    jax_pos = [same_slot(n) for n in _positional(jax_fn)]
    jax_all = [same_slot(n) for n in _names(jax_fn)]
    port_pos = _positional(port_fn)
    assert port_pos == jax_pos[:len(port_pos)], (name, port_pos)
    shared = [n for n in port_all if n in jax_all]
    assert shared == [n for n in jax_all if n in port_all], name
    if len(port_pos) < len(jax_pos):  # the next JAX name is not in the port
        assert jax_pos[len(port_pos)] not in port_all, name
    if name in OPERANDS_DIFFER:
        kw_only = [n for n in port_all if n not in port_pos]
        params = inspect.signature(port_fn).parameters
        assert all(params[n].kind == inspect.Parameter.KEYWORD_ONLY for n in kw_only), name


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def test_engine_cache_dtype_follows_jax():
    """PaliGemmaEngine(params, cfg, max_seq_len, cache_dtype, eos_token_id):
    JAX's positional order; the cache takes cache_dtype."""
    _, _, tp, _ = _weights()
    bf = _cast(tp, torch.bfloat16)
    eng = t_engine.PaliGemmaEngine(bf, CFG, 32, torch.float32, 7, False)
    assert eng.eos_token_id == 7 and eng.cache_dtype == torch.float32
    assert eng.init_state_cache(1)["k"].dtype == torch.float32
    assert t_engine.PaliGemmaEngine(bf, CFG, 32).cache_dtype == torch.bfloat16
    # W8A8 prefill is ported: the engine builds and keeps the flag
    assert t_engine.PaliGemmaEngine(tp, CFG, 32, int8_act_prefill=True).int8_act_prefill


def test_siglip_encode_use_flash_positional_is_flash():
    """encode(p, cfg, x, True) runs the flash path, as JAX's does."""
    _, _, tp, _ = _weights()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(1, 3, 28, 28)).astype(np.float32))
    vp, vc = tp["vision"], CFG.vision_config
    got = t_siglip.encode(vp, vc, x, True)
    assert torch.equal(got, t_siglip.encode(vp, vc, x, attn="flash"))
    assert torch.equal(t_siglip.encode(vp, vc, x), t_siglip.encode(vp, vc, x, attn="xla"))
