"""Speculative continuous batching in the port's serving engines against the
JAX engines (CPU, fp32 prefill, the int8 decode tree JAX quantized, seeded
requests):

* ``spec_decode=True``: the dense and paged engines give the tokens of the
  JAX spec engines and of the port's engines without speculation, on the
  plain path and on the kernel path (the decode chain at
  ``max_slots * (spec_draft_k + 1)`` rows, whose wrappers run their plain
  versions on the CPU), with more requests than slots (slot reuse);
* EOS retires a row early, the budget is exact, pipelined windows give the
  stepwise tokens, a sampled request is refused, the overshoot of the last
  verify is left room at ``submit``, and a row that fills its cache leaves
  its neighbour's tokens unchanged;
* a pool that preempts (recompute) keeps the JAX spec engine's tokens and
  preemption count, and with constrained rows the tokens of constrained
  decoding without speculation;
* grammars: constrained spec rows give the tokens of constrained decoding
  without speculation (and of JAX's spec engine), on both engines;
* the prefix cache: hits are seated with no prefill and keep speculating,
  and the entry's borrowed pages are never written;
* the rejections: a LoRA bank, a page-walk ``paged_kernel``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import GemmaConfig, PaliGemmaConfig, tiny_test_config
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.processing import grammar as j_grammar
from paligemma_tpu.runtime import serving as j_serving
from paligemma_tpu.runtime import serving_paged as j_paged
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.processing import grammar as t_grammar
from paligemma_tpu_torch.runtime import serving as t_serving
from paligemma_tpu_torch.runtime import serving_paged as t_paged

torch.set_num_threads(2)

CFG = PaliGemmaConfig(
    vision_config=tiny_test_config().vision_config,
    text_config=GemmaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=1, head_dim=128),
    projection_dim=128, hidden_size=128, image_token_index=510, vocab_size=512,
)
KD = 3  # spec_draft_k
ENGINES = [("dense", "plain"), ("dense", "kernel"), ("paged", "plain"), ("paged", "kernel")]
# (rid, seed, n_txt, max_new): five requests through three slots
SPECS = ((0, 1, 4, 14), (1, 2, 7, 9), (2, 3, 4, 17), (3, 4, 6, 5), (4, 5, 3, 12))
EOS_G = 1
TOKEN_STRS = [""] * CFG.vocab_size
for _i, _s in {10: "a", 11: "b", 12: "ab", 13: "c"}.items():
    TOKEN_STRS[_i] = _s


@functools.lru_cache(maxsize=None)
def _weights():
    jp = j_pg.init_params(jax.random.PRNGKey(0), CFG)
    jq = j_qserve(jp)
    to_port = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    return jp, jq, to_port(jp), to_port(jq)


def _req(cls, rid, seed, n_txt, max_new, eos=-1, grammar=None, sample=False):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((CFG.vision_config.num_patches,), CFG.image_token_index),
                          rng.integers(3, 100, (n_txt,))]).astype(np.int32)
    return cls(request_id=rid, input_ids=ids, max_new_tokens=max_new, eos_token_id=eos,
               pixel_values=rng.normal(size=(3, 28, 28)).astype(np.float32),
               grammar=grammar, do_sample=sample)


def _serve(eng, cls, specs, eos=-1, pipeline=None, grammar=None):
    reqs = [_req(cls, *s, eos=eos, grammar=grammar(s[0]) if grammar else None) for s in specs]
    for r in reqs:
        eng.submit(r)
    done = eng.run_to_completion(pipeline=pipeline)
    assert sorted(r.request_id for r in done) == sorted(s[0] for s in specs)
    return {r.request_id: list(r.tokens) for r in reqs}


def _kw(spec=True, slots=3, **kw):
    out = dict(max_slots=slots, max_seq_len=64, sync_every=2, **kw)
    if spec:
        out.update(spec_decode=True, spec_draft_k=KD)
    return out


def _grammars(pkg):
    return {"g": pkg.compile_token_dfa(pkg.compile_regex("(ab|c)+"), TOKEN_STRS, EOS_G)}


def _jax_engine(engine, **kw):
    jp, jq, _, _ = _weights()
    if engine == "paged":
        return j_paged.PagedServingEngine(jp, CFG, page_size=16, decode_params=jq,
                                          use_flash=False, **kw)
    return j_serving.ServingEngine(jp, CFG, decode_params=jq, use_flash=False, **kw)


def _port_engine(engine, path, **kw):
    _, _, tp, tq = _weights()
    kernel = path == "kernel"
    if engine == "paged":
        eng = t_paged.PagedServingEngine(tp, CFG, page_size=16, decode_params=tq,
                                         use_flash=kernel, fused_decode=kernel,
                                         paged_kernel="fused", **kw)
    else:
        eng = t_serving.ServingEngine(tp, CFG, decode_params=tq, use_flash=kernel,
                                      fused_decode=kernel, **kw)
    assert eng.fused_decode == kernel
    return eng


@functools.lru_cache(maxsize=None)
def _jax_tokens(engine, eos=-1, pipeline=None, n_pages=None, grammar=False, specs=SPECS):
    kw = _kw(grammars=_grammars(j_grammar) if grammar else None)
    if n_pages is not None:
        kw["n_pages"] = n_pages
    eng = _jax_engine(engine, **kw)
    toks = _serve(eng, j_serving.Request, specs, eos, pipeline,
                  (lambda rid: "g" if rid % 2 else None) if grammar else None)
    return toks, getattr(eng, "preemptions", 0)


@functools.lru_cache(maxsize=None)
def _plain_tokens(eos=-1):
    """The port's dense engine without speculation (plain path)."""
    return _serve(_port_engine("dense", "plain", **_kw(spec=False)), t_serving.Request, SPECS,
                  eos)


@pytest.mark.parametrize("engine,path", ENGINES)
def test_spec_engine_matches_jax_spec_and_no_spec(engine, path):
    eng = _port_engine(engine, path, **_kw())
    got = _serve(eng, t_serving.Request, SPECS)
    assert got == _jax_tokens(engine)[0]
    assert got == _plain_tokens()
    assert [len(got[s[0]]) for s in SPECS] == [s[3] for s in SPECS]  # the exact budgets


@pytest.mark.parametrize("engine,path", ENGINES)
def test_spec_engine_eos_retires_early(engine, path):
    eos = _plain_tokens()[0][4]
    got = _serve(_port_engine(engine, path, **_kw()), t_serving.Request, SPECS, eos)
    assert got == _plain_tokens(eos)
    assert got[0][-1] == eos and len(got[0]) < SPECS[0][3]
    if path == "plain":
        assert got == _jax_tokens(engine, eos)[0]


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_spec_pipelined_equals_stepwise(engine):
    stepwise = _serve(_port_engine(engine, "kernel", **_kw()), t_serving.Request, SPECS,
                      pipeline=False)
    piped = _serve(_port_engine(engine, "kernel", **_kw()), t_serving.Request, SPECS,
                   pipeline=True)
    assert stepwise == piped == _plain_tokens()


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_spec_paged_preemption_recomputes(path):
    """A pool of 5 usable 16-token pages preempts twice (every window
    reserves ticks * (draft_k + 1) + draft_k positions past what was
    dispatched): the JAX spec engine's tokens and preemptions, and the
    tokens without speculation."""
    specs = ((0, 1, 4, 30), (1, 2, 7, 28), (2, 3, 4, 33), (3, 4, 6, 20))
    want, jax_pre = _jax_tokens("paged", n_pages=6, specs=specs)
    eng = _port_engine("paged", path, **_kw(n_pages=6))
    got = _serve(eng, t_serving.Request, specs)
    assert eng.preemptions == jax_pre == 2
    assert got == want
    assert got == _serve(_port_engine("dense", "plain", **_kw(spec=False)), t_serving.Request,
                         specs)


@pytest.mark.parametrize("engine,path", ENGINES)
def test_spec_with_grammar_keeps_constrained_tokens(engine, path):
    """Odd requests under "(ab|c)+": each verify position's argmax masked by
    the DFA state after its prefix gives constrained greedy decoding's
    tokens (the engine without speculation, and JAX's spec engine)."""
    gr = lambda rid: "g" if rid % 2 else None  # noqa: E731
    want = _serve(_port_engine(engine, path, **_kw(spec=False, grammars=_grammars(t_grammar))),
                  t_serving.Request, SPECS, EOS_G, grammar=gr)
    eng = _port_engine(engine, path, **_kw(grammars=_grammars(t_grammar)))
    got = _serve(eng, t_serving.Request, SPECS, EOS_G, grammar=gr)
    assert got == want
    for rid in (1, 3):
        text = "".join(TOKEN_STRS[t] for t in got[rid] if t != EOS_G)
        assert text and set(text) <= set("abc")
    if path == "plain":
        assert got == _jax_tokens(engine, EOS_G, grammar=True)[0]


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_spec_paged_preemption_with_grammar(path):
    """The pool of 5 usable pages under speculation with constrained rows
    (the logits head at B x (draft_k + 1) rows, each position masked by its
    prefix's DFA state): a preempted constrained row is recomputed and
    seated in the state its emitted tokens reach, so every row keeps the
    tokens of constrained decoding without speculation or preemption. Not
    held against JAX, whose engine seats such a row in the start state."""
    specs = ((0, 1, 4, 30), (1, 2, 7, 28), (2, 3, 4, 33), (3, 4, 6, 20))
    gr = lambda rid: "g" if rid % 2 else None  # noqa: E731
    want = _serve(_port_engine("dense", "plain", **_kw(spec=False, grammars=_grammars(t_grammar))),
                  t_serving.Request, specs, EOS_G, grammar=gr)
    eng = _port_engine("paged", path, **_kw(n_pages=6, grammars=_grammars(t_grammar)))
    got = _serve(eng, t_serving.Request, specs, EOS_G, grammar=gr)
    assert eng.preemptions >= 1
    assert got == want


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_spec_with_prefix_cache(engine):
    """The requests twice: the second wave is seated from the cache (no
    prefill), keeps speculating and gives the first wave's tokens; a paged
    hit's borrowed pages are never written."""
    # prompts of 24 tokens: one full page to borrow, a tail page to copy
    specs = tuple((r, seed, 20, n) for r, seed, _, n in SPECS[:3])
    specs += tuple((r + 10, *rest) for r, *rest in specs)
    eng = _port_engine(engine, "kernel", **_kw(prefix_cache=True, **(
        {"n_pages": 40} if engine == "paged" else {})))
    reqs = [_req(t_serving.Request, *s) for s in specs]
    for r in reqs[:3]:
        eng.submit(r)
    eng.run_to_completion()
    if engine == "paged":
        borrowed = [p for e in eng._pcache.values() for p in e["full_pages"]]
        assert borrowed
        before = {n: eng.cache[n][:, borrowed].clone() for n in ("k", "v")}
    calls = eng.prefill_calls
    for r in reqs[3:]:
        eng.submit(r)
    eng.run_to_completion()
    assert eng.cache_hits == 3 and eng.prefill_calls == calls
    toks = {r.request_id: r.tokens for r in reqs}
    want = _serve(_port_engine("dense", "plain", **_kw(spec=False)), t_serving.Request,
                  specs[:3])
    assert all(toks[r] == toks[r + 10] == want[r] for r in range(3))
    if engine == "paged":
        assert all(torch.equal(eng.cache[n][:, borrowed], before[n]) for n in ("k", "v"))


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_spec_submit_rules(engine):
    """A sampled request is refused; a verify's draft_k slots past the last
    token are left room (the budget is capped), and a prompt with no room
    left is refused."""
    eng = _port_engine(engine, "plain", **_kw())
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit(_req(t_serving.Request, 0, 1, 4, 5, sample=True))
    long = _req(t_serving.Request, 1, 2, 50, 30)  # 4 image + 50 text tokens
    eng.submit(long)
    assert long.max_new_tokens == 64 - 54 - KD
    with pytest.raises(ValueError, match="no room"):
        eng.submit(_req(t_serving.Request, 2, 3, 58, 5))


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_spec_row_that_fills_its_cache_leaves_its_neighbour(engine):
    """Request 0 is capped to fill its cache up to the verify's overshoot and
    goes on verifying, done, until its slot is seated again; every write
    stays below max_seq_len, and request 1's tokens are its tokens alone."""
    specs = ((0, 1, 40, 100), (1, 2, 4, 24))
    kw = _kw(slots=2, **({"n_pages": 12} if engine == "paged" else {}))
    both = _serve(_port_engine(engine, "kernel", **kw), t_serving.Request, specs)
    alone = _serve(_port_engine(engine, "kernel", **kw), t_serving.Request, specs[1:])
    assert len(both[0]) == 64 - 44 - KD and both[1] == alone[1]


def test_spec_rejections():
    _, _, tp, tq = _weights()
    with pytest.raises(ValueError, match="lora_bank"):
        t_serving.ServingEngine(tp, CFG, decode_params=tq, spec_decode=True,
                                lora_bank={"x": {"layers": {}}})
    with pytest.raises(ValueError, match="page walk"):
        t_paged.PagedServingEngine(tp, CFG, max_seq_len=64, page_size=16, decode_params=tq,
                                   fused_decode=True, paged_kernel="multi", spec_decode=True)
