"""W8A8 prefill (single-copy int8 serving) in the port against the JAX
package (CPU, seeded numpy inputs, the int8 tree JAX quantized):

* ``kernels/quant._w8a8_matmul`` equals JAX's ``_xla_w8a8_matmul`` bit for
  bit (fp32 and bf16, an all-zero row, row scales over four decades), and
  K1's plain codes and scales equal JAX's; ``matmul_any``'s gate at 255 /
  256 rows (below it the convert path's bits);
* ``gemma.forward`` and ``paligemma.prefill`` with ``int8_act``: every W8A8
  product equals JAX's function on the same operands bit for bit (4 a
  layer), and the logits agree with JAX's within ``LOGIT_TOL``;
* the single-copy engines (``params`` = ``decode_params`` = the int8 tree,
  ``int8_act_prefill=True``) give JAX's greedy tokens where a prefill takes
  at least 256 rows: ``PaliGemmaEngine.generate`` and ``generate_spec``,
  the dense and paged serving engines on the plain and the kernel path
  (plain versions on the CPU), plainly, with a prefix-cache hit, with
  ``spec_decode`` (the verify's rows stay weight-only) and with a LoRA bank;
* two gloo ranks (a model axis of 2) give one rank's prefill logits bit for
  bit.

``LOGIT_TOL``: W8A8 is discontinuous. Where the two frameworks' fp32 sums
part by an ulp at a rounding boundary of ``x / a_s``, a code moves by one
(1/127 of the row's amax) and the move runs on through the layers. Measured
here: 8.7e-3 of the largest |logit| at prefill, 6.4e-4 for the decoder
alone; without ``int8_act`` the two agree to 1e-6.

The W8A8 products equal JAX's eager ``_xla_w8a8_matmul``. Under jit, XLA
turns its ``amax / 127`` into ``amax * fp32(1/127)`` (a rewrite of division
by a constant), which moves ``a_s`` by an ulp on a few rows; the port, as
its card kernel, divides (IEEE).
"""

import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from paligemma_tpu.kernels import quant as j_quant
from paligemma_tpu.models import gemma as j_gemma
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.runtime import serving as j_serving
from paligemma_tpu.runtime import serving_paged as j_paged
from paligemma_tpu.runtime.engine import PaliGemmaEngine as JaxEngine
from paligemma_tpu_torch import kernels as t_kernels
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.kernels import quant as t_quant
from paligemma_tpu_torch.kernels import w8a8 as t_w8a8
from paligemma_tpu_torch.models import gemma as t_gemma
from paligemma_tpu_torch.models import paligemma as t_pg
from paligemma_tpu_torch.runtime import serving as t_serving
from paligemma_tpu_torch.runtime import serving_paged as t_paged
from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
from tests.test_torch_grammar import _adapter_np
from tests.test_torch_spec_serving import CFG, _weights

torch.set_num_threads(2)

LOGIT_TOL = 2e-2  # of the largest |logit| (module docstring)
N_TXT = 126  # text tokens: 4 image + 126 = 130 rows a prompt, 260 at B = 2
MAX_SEQ = 192
ENGINES = [("dense", "plain"), ("dense", "kernel"), ("paged", "plain"), ("paged", "kernel")]
KD = 3  # spec_draft_k


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_int8(w):
    q = j_quant.quantize_int8(jnp.asarray(w))
    return q, {k: torch.from_numpy(np.array(v)) for k, v in q.items()}


def _rows(rng, shape):
    """Rows of x with scales over four decades, an all-zero row and an
    outlier."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-2, 2, size=shape[:-1] + (1,))
    x = x.reshape(-1, shape[-1])
    x[3] = 0.0
    x[5, 7] = 80.0
    return x.reshape(shape).astype(np.float32)


# ------------------------------------------------------------ the matmul ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_matmul_equals_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    x = _rows(rng, (2, 150, 96))
    jq, tq = _jax_int8(rng.normal(size=(96, 80)).astype(np.float32))
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(j_quant._xla_w8a8_matmul(xj, jq["w8"], jq["s"]).astype(jnp.float32))
    got = _np(t_quant._w8a8_matmul(xt, tq["w8"], tq["s"]))
    assert np.array_equal(got, want)
    assert np.all(got[0, 3] == 0)  # the all-zero row

    # K1's codes and scales: the reference's steps on the same rows
    xf = xj.astype(jnp.float32).reshape(-1, 96)
    a_s = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
    x8 = jnp.clip(jnp.round(xf / a_s), -127, 127).astype(jnp.int8)
    t8, ts = t_w8a8.quant_rows_reference(xt.reshape(-1, 96))
    assert np.array_equal(t8.numpy(), np.asarray(x8))
    assert np.array_equal(ts.numpy(), np.asarray(a_s)[:, 0])
    assert t8.abs().max() == 127 and (t8 == 0).all(dim=-1).sum() == 1


def test_w8a8_wrappers_on_the_cpu_are_their_plain_versions():
    """On CPU tensors K1 and K2 run their plain versions and count no
    launch; K2's int32 sums scaled by ``scale_sums`` are its bf16 output."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_rows(rng, (40, 64))).bfloat16()
    _, tq = _jax_int8(rng.normal(size=(64, 48)).astype(np.float32))
    before = t_kernels.launch_counts()
    x8, a_s = t_w8a8.w8a8_quant_rows(x)
    r8, rs = t_w8a8.quant_rows_reference(x)
    assert torch.equal(x8, r8) and torch.equal(a_s, rs)
    acc = t_w8a8.w8a8_gemm(x8, tq["w8"], a_s, tq["s"], out_dtype=torch.int32)
    out = t_w8a8.w8a8_gemm(x8, tq["w8"], a_s, tq["s"])
    assert acc.dtype == torch.int32 and out.dtype == torch.bfloat16
    assert torch.equal(t_w8a8.scale_sums(acc, a_s, tq["s"], torch.bfloat16), out)
    assert torch.equal(acc.double(), x8.double() @ tq["w8"].double())
    # a given amax replaces the row's own: the rows' own amax gives the same bits
    x8b, a_sb = t_w8a8.w8a8_quant_rows(x, x.float().abs().amax(-1))
    assert torch.equal(x8b, x8) and torch.equal(a_sb, a_s)
    assert t_kernels.launch_counts() == before


# K2's plans at one Gemma-2B layer's four projections (K, N): M266 (a 224 px
# prompt) in one 272-row tile (chunks 144 + 128), K split over 4 / 6 ranks
# where 16-20 column tiles would leave SMs idle; M2560 in 256-row tiles,
# persistent CTAs; M1 and M16 in 16-row tiles
W8A8_PROJECTIONS = {"qkv": (2048, 2560), "o": (2048, 2048), "gateup": (2048, 32768),
                    "down": (16384, 2048)}
GEMM_PLANS = {  # (M, projection): (rows, cluster, k_stages, ctas)
    (266, "qkv"): (272, 4, 4, 80), (266, "o"): (272, 6, 3, 96),
    (266, "gateup"): (272, 1, 16, 132), (266, "down"): (272, 6, 22, 96),
    (2560, "qkv"): (256, 1, 16, 132), (2560, "o"): (256, 1, 16, 132),
    (2560, "gateup"): (256, 1, 16, 132), (2560, "down"): (256, 1, 128, 132),
    (1, "qkv"): (16, 4, 4, 80), (16, "down"): (16, 6, 22, 96),
    (255, "o"): (256, 6, 3, 96), (267, "qkv"): (272, 4, 4, 80),
}


@pytest.mark.parametrize("m,proj", list(GEMM_PLANS), ids=[f"M{m}-{p}" for m, p in GEMM_PLANS])
def test_w8a8_gemm_plan_pins_the_main_shapes(m, proj):
    """K2's launch at the prefill's shapes: the row tile, the K split and
    the grid (kernels/w8a8.GemmPlan)."""
    k, n = W8A8_PROJECTIONS[proj]
    plan = t_w8a8.GemmPlan.make(m, k, n)
    assert (plan.rows, plan.cluster, plan.k_stages, plan.ctas) == GEMM_PLANS[(m, proj)]


@pytest.mark.parametrize("m", [1, 15, 16, 17, 100, 255, 256, 257, 266, 272, 273, 700, 2560])
def test_w8a8_gemm_plan_covers_k_and_fits_the_card(m):
    """For every M and each projection (and small K / N): the row tile is
    one of the kernel's; the split's ranks each sum at least one stage and
    together every stage; a split's clusters all fit the card at once
    (FITS) and take one tile each; persistent CTAs are at most FITS[1]; the
    plan is the cheapest option of the cost model."""
    for k, n in list(W8A8_PROJECTIONS.values()) + [(48, 48), (128, 16), (2048, 4096)]:
        plan = t_w8a8.GemmPlan.make(m, k, n)
        assert plan.rows in t_w8a8.ROW_TILES and plan.k_stages >= 1
        stages = -(-k // t_w8a8.BK)
        assert plan.stages == stages
        assert (plan.cluster - 1) * plan.k_stages < stages <= plan.cluster * plan.k_stages
        if plan.cluster > 1:
            assert plan.tiles <= t_w8a8.FITS[plan.cluster]
            assert plan.ctas == plan.tiles * plan.cluster
        else:
            assert plan.k_stages == stages and plan.ctas == min(plan.tiles, t_w8a8.FITS[1])
        waves = 1 if plan.cluster > 1 else -(-plan.tiles // t_w8a8.FITS[1])
        cost = waves * plan.k_stages * (plan.rows + t_w8a8.STAGE_COST)
        for rows in t_w8a8.ROW_TILES:  # no other row tile is cheaper
            tiles = -(-n // t_w8a8.COLS) * -(-m // rows)
            floor = -(-tiles // t_w8a8.FITS[1]) * stages if tiles > t_w8a8.FITS[1] else max(
                1, -(-stages // max(c for c in t_w8a8.FITS if c <= stages and (
                    c == 1 or tiles <= t_w8a8.FITS[c]))))
            assert cost <= floor * (rows + t_w8a8.STAGE_COST)


@pytest.mark.parametrize("shape", [(255, 64), (5, 51, 64), (256, 64), (4, 64, 64)],
                         ids=["255", "5x51", "256", "4x64"])
def test_matmul_any_gate(shape):
    """int8_act takes W8A8 from 256 rows of x.shape[:-1] on: JAX's bits;
    below, the convert path's bits (the port's, which JAX's fp32 dot order
    meets within 1e-5 of each row's largest output)."""
    rng = np.random.default_rng(2)
    x = _rows(rng, shape)
    jq, tq = _jax_int8(rng.normal(size=(64, 40)).astype(np.float32))
    want = np.asarray(j_quant.matmul_any(jnp.asarray(x), jq, int8_act=True))
    xt = torch.from_numpy(x)
    got = t_quant.matmul_any(xt, tq, int8_act=True)
    convert = t_quant._int8_matmul(xt, tq["w8"], tq["s"])
    if np.prod(shape[:-1]) >= 256:
        assert np.array_equal(got.numpy(), want)
        assert not torch.equal(got, convert)
    else:
        assert torch.equal(got, convert)
        row_max = np.abs(want).max(axis=-1, keepdims=True)
        assert (np.abs(got.numpy() - want) <= 1e-5 * row_max).all()
    assert torch.equal(t_quant.matmul_any(xt, tq), convert)  # int8_act off: unchanged


# ------------------------------------------------------- forward, prefill ----
@pytest.fixture
def jax_checked_products(monkeypatch):
    """Every W8A8 product of the port, also run through JAX's function on
    the same operands: the outputs must be equal bit for bit. Yields the
    list of the products' x shapes."""
    calls = []
    plain = t_quant._w8a8_matmul

    def both(x, w8, s):
        got = plain(x, w8, s)
        want = j_quant._xla_w8a8_matmul(jnp.asarray(x.numpy()), jnp.asarray(w8.numpy()),
                                        jnp.asarray(s.numpy()))
        assert np.array_equal(got.numpy(), np.asarray(want)), tuple(x.shape)
        calls.append(tuple(x.shape))
        return got

    monkeypatch.setattr(t_quant, "_w8a8_matmul", both)
    return calls


def _close(got, want):
    err = np.abs(got - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max(), err


def test_gemma_forward_int8_act_matches_jax(jax_checked_products):
    jp, jq, tp, tq = _weights()
    tc = CFG.text_config
    rng = np.random.default_rng(3)
    b, s, w = 2, 130, 160
    emb = rng.normal(size=(b, s, tc.hidden_size)).astype(np.float32)
    pos = np.tile(np.arange(1, s + 1), (b, 1)).astype(np.int32)
    valid = np.zeros((b, w), bool)
    valid[:, :s] = True
    want, _ = j_gemma.forward(jq["lm"], tc, jnp.asarray(emb), jnp.asarray(pos),
                              j_gemma.init_kv_cache(tc, b, w, jnp.float32),
                              jnp.zeros((), jnp.int32), jnp.asarray(valid), int8_act=True)
    outs = {}
    for act in (True, False):
        outs[act], _ = t_gemma.forward(
            tq["lm"], tc, torch.from_numpy(emb), torch.from_numpy(pos).long(),
            t_gemma.init_kv_cache(tc, b, w, torch.float32, device="cpu"), 0,
            torch.from_numpy(valid), int8_act=act)
    nq = tc.num_attention_heads * tc.head_dim  # qkv, o, gateup, down: their inputs
    assert jax_checked_products == [(b, s, tc.hidden_size), (b, s, nq), (b, s, tc.hidden_size),
                                    (b, s, tc.intermediate_size)] * tc.num_hidden_layers
    _close(outs[True].numpy(), np.asarray(want))
    assert not torch.equal(outs[True], outs[False])


def _prompt(b, n_txt=N_TXT, seed=4):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((b, CFG.vision_config.num_patches), CFG.image_token_index),
                          rng.integers(3, 100, (b, n_txt))], 1).astype(np.int32)
    return rng.normal(size=(b, 3, 28, 28)).astype(np.float32), ids, np.ones_like(ids)


def test_paligemma_prefill_int8_act_matches_jax(jax_checked_products):
    """paligemma.prefill(int8_act=True, last_only=True) from the int8 tree:
    4 W8A8 products a layer, each JAX's bits; the head weight-only."""
    _, jq, _, tq = _weights()
    tc = CFG.text_config
    pix, ids, mask = _prompt(2)
    want, _ = j_pg.prefill(jq, CFG, jnp.asarray(pix), jnp.asarray(ids), jnp.asarray(mask),
                           j_gemma.init_kv_cache(tc, 2, MAX_SEQ, jnp.float32), last_only=True,
                           int8_act=True)
    got, _ = t_pg.prefill(tq, CFG, torch.from_numpy(pix), torch.from_numpy(ids).long(),
                          torch.from_numpy(mask),
                          t_gemma.init_kv_cache(tc, 2, MAX_SEQ, torch.float32, device="cpu"),
                          last_only=True, int8_act=True)
    assert len(jax_checked_products) == 4 * tc.num_hidden_layers
    assert all(np.prod(shape[:-1]) == 2 * ids.shape[1] for shape in jax_checked_products)
    assert got.shape == (2, 1, CFG.vocab_size)
    _close(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- engines ----
def test_single_copy_engine_holds_one_tree():
    """params = decode_params = the int8 tree: the engine's prefill and
    decode read the same int8 tensors, and no dense LM projection is held."""
    _, _, _, tq = _weights()
    eng = PaliGemmaEngine(tq, CFG, max_seq_len=MAX_SEQ, decode_params=tq, use_flash=True,
                          fused_layer=True, int8_act_prefill=True)
    assert eng.int8_act_prefill
    for group, name in (("attn", "qkv"), ("attn", "o"), ("mlp", "gateup"), ("mlp", "down")):
        leaf = eng.params["lm"]["layers"][group][name]
        assert set(leaf) == {"w8", "s"}
        assert leaf["w8"] is eng.decode_params["lm"]["layers"][group][name]["w8"]
    head = eng.decode_params["lm"]["head_q"]
    assert head["w8_blk"].data_ptr() == eng.params["lm"]["head_q"]["w8"].data_ptr()


@functools.lru_cache(maxsize=None)
def _jax_generate(spec):
    _, jq, _, _ = _weights()
    pix, ids, mask = _prompt(1 if spec else 2, N_TXT + 126 if spec else N_TXT)
    eng = JaxEngine(jq, CFG, max_seq_len=MAX_SEQ + 128, use_flash=False, decode_params=jq,
                    fused_layer=False, int8_act_prefill=True)
    args = (jnp.asarray(pix), jnp.asarray(ids), jnp.asarray(mask))
    if spec:
        return np.asarray(eng.generate_spec(*args, max_new_tokens=10, eos_token_id=-1,
                                            draft_k=KD))
    return np.asarray(eng.generate(*args, max_new_tokens=10, eos_token_id=-1))


@pytest.mark.parametrize("spec", [False, True], ids=["generate", "generate_spec"])
@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_engine_single_copy_matches_jax(path, spec, jax_checked_products):
    """PaliGemmaEngine from the int8 tree alone with int8_act_prefill: JAX's
    greedy tokens (B 2 x 130 rows; generate_spec B 1 x 256 rows), the
    prefill's products W8A8 and JAX's bits. Both engines run at fp32 (the
    tree JAX quantized from fp32 weights): the arithmetic of ``--dtype
    float32 --int8_prefill``, whose K1 / K2 fp32 forms the card holds to
    these plain versions bit for bit (tests/test_torch_cuda.py)."""
    _, _, _, tq = _weights()
    kernel = path == "kernel"
    pix, ids, mask = _prompt(1 if spec else 2, N_TXT + 126 if spec else N_TXT)
    assert ids.size >= 256
    eng = PaliGemmaEngine(tq, CFG, max_seq_len=MAX_SEQ + 128, decode_params=tq,
                          use_flash=kernel, fused_layer=kernel, int8_act_prefill=True)
    assert eng.cache_dtype == torch.float32 == tq["lm"]["embed"].dtype
    if spec:
        got = eng.generate_spec(pix, ids, mask, max_new_tokens=10, eos_token_id=-1, draft_k=KD)
    else:
        got = eng.generate(pix, ids, mask, max_new_tokens=10, eos_token_id=-1, sync_every=4)
    np.testing.assert_array_equal(got, _jax_generate(spec))
    # the prefill only: decode steps and verify forwards stay weight-only
    assert len(jax_checked_products) == 4 * CFG.text_config.num_hidden_layers


def _req(cls, rid, seed, n_txt, max_new, lora=None):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((CFG.vision_config.num_patches,), CFG.image_token_index),
                          rng.integers(3, 100, (n_txt,))]).astype(np.int32)
    return cls(request_id=rid, input_ids=ids, max_new_tokens=max_new, eos_token_id=-1,
               pixel_values=rng.normal(size=(3, 28, 28)).astype(np.float32), lora=lora)


# (rid, seed, n_txt, max_new): a first wave of two (>= 256 rows: W8A8), then
# the third alone (fewer rows: weight-only); "prefix_cache" repeats
# request 0 as request 2 (a hit, no prefill)
SPECS = {
    "plain": ((0, 1, 130, 6), (1, 2, 128, 5), (2, 3, 131, 7)),
    "prefix_cache": ((0, 1, 130, 6), (1, 2, 128, 5), (2, 1, 130, 6)),
    "spec_decode": ((0, 1, 130, 9), (1, 2, 128, 6), (2, 3, 131, 8)),
    "lora": ((0, 1, 130, 6), (1, 2, 128, 5), (2, 3, 131, 7)),
}
LORAS = (None, "a", "b")
N_PAGES = 3 * MAX_SEQ // 16 + 1  # two whole slots and a prefix-cache entry


def _bank(np_bank):
    return {n: params_from_numpy(t, "cpu") for n, t in np_bank.items()}


def _serving_kw(variant):
    kw = dict(max_slots=2, max_seq_len=MAX_SEQ, sync_every=2, int8_act_prefill=True)
    if variant == "prefix_cache":
        kw["prefix_cache"] = True
    if variant == "spec_decode":
        kw.update(spec_decode=True, spec_draft_k=KD)
    return kw


def _serve(eng, cls, variant):
    reqs = [_req(cls, *s, lora=LORAS[s[0]] if variant == "lora" else None)
            for s in SPECS[variant]]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return {r.request_id: list(r.tokens) for r in reqs}, eng.prefill_calls


@functools.lru_cache(maxsize=None)
def _jax_serve(engine, variant):
    _, jq, _, _ = _weights()
    kw = _serving_kw(variant)
    if variant == "lora":
        kw["lora_bank"] = {n: _adapter_np(i + 5) for i, n in enumerate(LORAS[1:])}
    if engine == "paged":  # the XLA page walk: the reference's tick in fp32, without
        # lowering the fused Pallas tick in interpret mode (~40 s a variant on the CPU)
        eng = j_paged.PagedServingEngine(jq, CFG, page_size=16, n_pages=N_PAGES,
                                         decode_params=jq, use_flash=False,
                                         paged_kernel="xla", **kw)
    else:
        eng = j_serving.ServingEngine(jq, CFG, decode_params=jq, use_flash=False, **kw)
    return _serve(eng, j_serving.Request, variant)


@pytest.mark.parametrize("variant", list(SPECS))
@pytest.mark.parametrize("engine,path", ENGINES)
def test_serving_single_copy_matches_jax(engine, path, variant, jax_checked_products):
    """The dense and paged engines serving from the int8 tree alone with
    int8_act_prefill: JAX's engines' greedy tokens and prefill calls; the
    first wave (two prompts, >= 256 rows) takes W8A8 (JAX's bits), the
    third request's wave (one prompt) stays weight-only, a prefix-cache hit
    takes no prefill."""
    _, _, _, tq = _weights()
    kernel = path == "kernel"
    kw = _serving_kw(variant)
    if variant == "lora":
        kw["lora_bank"] = _bank({n: _adapter_np(i + 5) for i, n in enumerate(LORAS[1:])})
    if engine == "paged":
        eng = t_paged.PagedServingEngine(tq, CFG, page_size=16, n_pages=N_PAGES,
                                         decode_params=tq, use_flash=kernel,
                                         fused_decode=kernel, paged_kernel="fused", **kw)
    else:
        eng = t_serving.ServingEngine(tq, CFG, decode_params=tq, use_flash=kernel,
                                      fused_decode=kernel, **kw)
    got, calls = _serve(eng, t_serving.Request, variant)
    want, j_calls = _jax_serve(engine, variant)
    assert got == want and calls == j_calls
    assert len(jax_checked_products) == 4 * CFG.text_config.num_hidden_layers
    assert np.prod(jax_checked_products[0][:-1]) >= 256
    if variant == "prefix_cache":
        assert eng.cache_hits == 1 and calls == 1


# ------------------------------------------------------------ two ranks ----
def test_two_gloo_ranks_give_one_ranks_prefill_logits(tmp_path):
    """A model axis of 2 (gloo): the row-parallel o and down take each row's
    amax across ranks, quantize their K shards with it and add the int32
    sums across ranks, so both ranks' prefill logits equal one rank's (no
    mesh) bit for bit; column-parallel qkv and gateup need nothing."""
    from test_torch_tp import N_IMG, _cfg
    from test_torch_tp import _weights as tp_weights

    _, _, _, tq = tp_weights(256)
    rng = np.random.default_rng(6)
    ids = np.concatenate([np.full((1, N_IMG), 250), rng.integers(3, 240, (1, 256))],
                         1).astype(np.int32)
    pix = rng.normal(size=(1, 3, 28, 28)).astype(np.float32)
    wf = str(tmp_path / "w.pt")
    torch.save((tq, 256, pix, ids), wf)
    from torch_w8a8_ranks import rank_prefill

    ctx = tmp.start_processes(rank_prefill, args=(2, str(tmp_path / "init"), wf, str(tmp_path)),
                              nprocs=2, start_method="spawn", join=False)
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):  # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("2 ranks did not finish in 300 s")
    one = PaliGemmaEngine(tq, _cfg(256), max_seq_len=320, decode_params=tq, use_flash=False,
                          fused_layer=False, int8_act_prefill=True)
    want, _ = one.prefill(pix, ids, np.ones_like(ids))
    for r in range(2):
        got = torch.load(str(tmp_path / f"logits{r}.pt"))
        assert torch.equal(got, want), r
