"""Grammar-constrained decoding in the port (processing/grammar.py and the
``grammars`` of both serving engines) against the JAX package (CPU, fp32
prefill, int8 decode tree, seeded requests):

* the port's regex, choices and token-closure tables are bit-equal to
  JAX's;
* the dense and paged engines with grammars give the JAX engines' tokens
  per request, on the plain path and on the kernel path (the decode chain
  with the int8 logits head, whose wrappers run their plain versions on
  the CPU), for the cases of tests/test_grammar.py:127-186: constrained
  greedy rows stay in the grammar, a choices grammar forces a stop,
  unconstrained rows are unchanged by a grammar on another row, a
  constrained sampled row stays in the grammar (JAX's Gumbel draws
  replayed into the port's sampler), grammar + LoRA; and the rejections;
* a grammar engine never takes the argmax head while a constrained row is
  seated;
* a preempted constrained row resumes in its DFA state (the paged engine).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.processing import grammar as j_grammar
from paligemma_tpu.runtime import serving as j_serving
from paligemma_tpu.runtime import serving_paged as j_paged
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.ops import sampling as t_sampling
from paligemma_tpu_torch.processing import grammar as t_grammar
from paligemma_tpu_torch.runtime import serving as t_serving
from paligemma_tpu_torch.runtime import serving_paged as t_paged

torch.set_num_threads(2)

CFG = PaliGemmaConfig(
    vision_config=SiglipVisionConfig(image_size=28, patch_size=14, hidden_size=32,
                                     intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=4),
    text_config=GemmaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=1, head_dim=128),
    projection_dim=128, hidden_size=128, image_token_index=510, vocab_size=512,
)
V = CFG.vocab_size
EOS = 1

# tests/test_grammar.py's synthetic vocab: ids 10..17 are text pieces, every
# other id (specials, the image token, filler) has no surface text
TOKEN_STRS = [""] * V
for _i, _s in {10: "a", 11: "b", 12: "ab", 13: "c", 14: "x", 15: "yz", 16: "12",
               17: "3"}.items():
    TOKEN_STRS[_i] = _s

PATTERNS = ["(ab)+c?", r"\d{2,3}(,\d{2,3})*", "[^b]+", "a{0,2}b", "q+", "(yes|no)",
            "[a-c]x*|yz", r"(\w\s?)*"]
ENGINES = [("dense", "plain"), ("dense", "kernel"), ("paged", "plain"), ("paged", "kernel")]


# ------------------------------------------------------------- tables ----
@pytest.mark.parametrize("pattern", PATTERNS)
def test_regex_and_token_tables_bit_equal(pattern):
    """compile_regex's byte DFA and compile_token_dfa's table over the
    vocabulary: the same arrays, dtypes and states as JAX's."""
    jd, td = j_grammar.compile_regex(pattern), t_grammar.compile_regex(pattern)
    np.testing.assert_array_equal(td.next, jd.next)
    np.testing.assert_array_equal(td.accepting, jd.accepting)
    assert td.next.dtype == jd.next.dtype
    jt = j_grammar.compile_token_dfa(jd, TOKEN_STRS, EOS)
    tt = t_grammar.compile_token_dfa(td, TOKEN_STRS, EOS)
    assert tt.table.dtype == np.int16 and tt.eos_token_id == jt.eos_token_id
    np.testing.assert_array_equal(tt.table, jt.table)
    for text in ("ab", "abc", "12,345", "ac", "aab", "q", "yes", "bx", "yz", "a b"):
        assert td.matches(text) == jd.matches(text)
        assert td.is_live_prefix(text) == jd.is_live_prefix(text)


def test_choices_table_and_dead_end_bit_equal():
    opts = ["ab", "abab", "yz", "c"]
    jd, td = j_grammar.compile_choices(opts), t_grammar.compile_choices(opts)
    np.testing.assert_array_equal(td.next, jd.next)
    np.testing.assert_array_equal(td.accepting, jd.accepting)
    np.testing.assert_array_equal(t_grammar.compile_token_dfa(td, TOKEN_STRS, EOS).table,
                                  j_grammar.compile_token_dfa(jd, TOKEN_STRS, EOS).table)
    # a grammar the vocabulary cannot spell: EOS is the way out
    dead = t_grammar.compile_token_dfa(t_grammar.compile_regex("q+"), TOKEN_STRS, EOS)
    assert dead.table[0, EOS] == 0 and (dead.table[0] >= 0).sum() == 1
    with pytest.raises(ValueError, match="outside vocab"):
        t_grammar.compile_token_dfa(td, TOKEN_STRS, V)
    with pytest.raises(ValueError, match="parse error|unclosed|unexpected"):
        t_grammar.compile_regex("(ab")


def test_token_strings_from_tokenizer():
    class Tok:
        all_special_ids = [0, 1]

        def convert_ids_to_tokens(self, ids):
            return ["<pad>", "<eos>", "▁yes", "no", None, "Ġx"][:len(ids)]

    want = j_grammar.token_strings_from_tokenizer(Tok(), 6)
    assert t_grammar.token_strings_from_tokenizer(Tok(), 6) == want == ["", "", " yes", "no",
                                                                          "", " x"]


# ------------------------------------------------------------ engines ----
@functools.lru_cache(maxsize=None)
def _weights():
    jp = j_pg.init_params(jax.random.PRNGKey(0), CFG)
    jq = j_qserve(jp)
    to_port = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    return jp, jq, to_port(jp), to_port(jq)


def _adapter_np(seed, rank=4):
    """A LoRA tree with nonzero deltas on every projection, as numpy."""
    tc = CFG.text_config
    h, nq, hd, inter = tc.hidden_size, tc.num_attention_heads * tc.head_dim, tc.head_dim, \
        tc.intermediate_size
    dims = {"q": (h, nq), "k": (h, hd), "v": (h, hd), "o": (nq, h), "gate": (h, inter),
            "up": (h, inter), "down": (inter, h)}
    rng = np.random.default_rng(seed)
    n = tc.num_hidden_layers
    return {"layers": {name: {
        "a": (rng.normal(size=(n, i, rank)) * i**-0.5).astype(np.float32),
        "b": (rng.normal(size=(n, rank, o)) * 0.05).astype(np.float32),
        "alpha": np.full((n,), 8.0, np.float32)} for name, (i, o) in dims.items()}}


GRAMMARS = {"g": ("regex", "(ab)+c?"), "choice": ("choices", ("ab", "abab")),
            "s": ("regex", "(ab|c)+"), "lead": ("regex", "c(ab)+")}


def _grammars(pkg, names):
    out = {}
    for n in names:
        kind, arg = GRAMMARS[n]
        dfa = pkg.compile_regex(arg) if kind == "regex" else pkg.compile_choices(list(arg))
        out[n] = pkg.compile_token_dfa(dfa, TOKEN_STRS, EOS)
    return out


def _byte_dfa(name):
    kind, arg = GRAMMARS[name]
    return t_grammar.compile_regex(arg) if kind == "regex" else t_grammar.compile_choices(
        list(arg))


# case -> (grammars, requests (rid, seed, n_txt, max_new, grammar, lora, sample), slots,
#          with a bank)
CASES = {
    "stays": (("g",), ((0, 1, 6, 10, "g", None, False), (1, 2, 4, 8, "g", None, False)), 2,
              False),
    "choices": (("choice",), ((0, 1, 6, 20, "choice", None, False),), 2, False),
    "mixed": (("g",), ((0, 1, 6, 8, None, None, False), (1, 2, 5, 6, None, None, False),
                       (2, 3, 4, 8, "g", None, False)), 2, False),
    "sampled": (("s",), ((0, 7, 5, 12, "s", None, True), (1, 2, 5, 6, None, None, False)), 2,
                False),
    "lora": (("g",), ((0, 1, 5, 8, "g", "x", False), (1, 2, 5, 8, None, "x", False),
                      (2, 3, 6, 8, "g", None, False)), 3, True),
}


def _req(cls, rid, seed, n_txt, max_new, grammar=None, lora=None, sample=False):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((CFG.vision_config.num_patches,), CFG.image_token_index),
                          rng.integers(3, 100, (n_txt,))]).astype(np.int32)
    pixels = rng.normal(size=(3, 28, 28)).astype(np.float32)
    return cls(request_id=rid, input_ids=ids, pixel_values=pixels, max_new_tokens=max_new,
               do_sample=sample, temperature=1.0, top_p=0.9, eos_token_id=EOS,
               grammar=grammar, lora=lora)


def _serve(eng, cls, specs):
    reqs = [_req(cls, *s) for s in specs]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return {r.request_id: list(r.tokens) for r in reqs}


def _kw(slots):
    return dict(max_slots=slots, max_seq_len=64, sync_every=2)


def _jax_engine(engine, slots, names, bank):
    jp, jq, _, _ = _weights()
    kw = dict(_kw(slots), decode_params=jq, use_flash=False,
              grammars=_grammars(j_grammar, names) if names else None)
    if bank:
        kw["lora_bank"] = {"x": jax.tree.map(jnp.asarray, _adapter_np(1))}
    if engine == "paged":
        # the JAX plain page walk ("fused" would run Pallas in interpret mode)
        return j_paged.PagedServingEngine(jp, CFG, page_size=16, n_pages=24,
                                          paged_kernel="multi", **kw)
    return j_serving.ServingEngine(jp, CFG, **kw)


def _port_engine(engine, path, slots, names, bank):
    _, _, tp, tq = _weights()
    kernel = path == "kernel"
    kw = dict(_kw(slots), decode_params=tq, use_flash=kernel, fused_decode=kernel,
              grammars=_grammars(t_grammar, names) if names else None)
    if bank:
        kw["lora_bank"] = {"x": params_from_numpy(_adapter_np(1), "cpu")}
    if engine == "paged":
        return t_paged.PagedServingEngine(tp, CFG, page_size=16, n_pages=24,
                                          paged_kernel="fused", **kw)
    return t_serving.ServingEngine(tp, CFG, **kw)


class _JaxDraws:
    """Replays the JAX engine's Gumbel draws into the port's sampler: the
    JAX engine splits its key (PRNGKey(0)) into ticks + 1 at every window,
    each tick's key over the slots, and draws (1, vocab) noise per row."""

    def __init__(self, eng, monkeypatch):
        self.key = jax.random.PRNGKey(0)
        self.queue = []
        self.used = 0
        run = eng._run_window

        def run_window(ticks, *a):
            self.key, *tks = jax.random.split(self.key, ticks + 1)
            self.queue = [np.stack([np.asarray(jax.random.gumbel(k, (1, V), jnp.float32))[0]
                                    for k in jax.random.split(tk, eng.max_slots)])
                          for tk in tks]
            return run(ticks, *a)

        def noise(shape, generator, device):
            self.used += 1
            return torch.from_numpy(self.queue.pop(0))

        eng._run_window = run_window
        monkeypatch.setattr(t_sampling, "gumbel_noise", noise)


@functools.lru_cache(maxsize=None)
def _jax_tokens(engine, case, with_grammars=True):
    names, specs, slots, bank = CASES[case]
    if not with_grammars:
        specs = tuple(s for s in specs if s[4] is None)
    eng = _jax_engine(engine, slots, names if with_grammars else (), bank)
    return _serve(eng, j_serving.Request, specs)


def _text(tokens):
    out = []
    for t in tokens:
        if t == EOS:
            break
        assert TOKEN_STRS[t], f"constrained row emitted token {t}, which has no text"
        out.append(TOKEN_STRS[t])
    return "".join(out)


@pytest.mark.parametrize("engine,path", ENGINES)
@pytest.mark.parametrize("case", list(CASES))
def test_grammar_engine_matches_jax(case, engine, path, monkeypatch):
    names, specs, slots, bank = CASES[case]
    want = _jax_tokens(engine, case)
    eng = _port_engine(engine, path, slots, names, bank)
    assert eng.fused_decode == (path == "kernel")
    draws = _JaxDraws(eng, monkeypatch) if case == "sampled" else None
    got = _serve(eng, t_serving.Request, specs)
    assert got == want
    if draws is not None:
        assert draws.used > 0
    for rid, _, _, max_new, g, _, _ in specs:
        if g is None:
            continue
        dfa, toks = _byte_dfa(g), got[rid]
        text = _text(toks)
        assert dfa.is_live_prefix(text), (rid, toks, text)
        if EOS in toks:
            assert dfa.matches(text), (rid, toks, text)
        if g == "choice":  # a finite grammar stops on the completed match
            assert toks[-1] == EOS and len(toks) < max_new and dfa.matches(text)
    if case == "mixed":
        # unconstrained rows equal an engine without grammars
        plain = _serve(_port_engine(engine, path, slots, (), bank), t_serving.Request,
                       tuple(s for s in specs if s[4] is None))
        assert plain == _jax_tokens(engine, case, False)
        for rid in plain:
            assert got[rid] == plain[rid]


@pytest.mark.parametrize("engine,path", ENGINES)
def test_grammar_engine_never_takes_the_argmax_head(engine, path, monkeypatch):
    """A grammar engine's greedy windows with a constrained row seated run
    the chain with the logits head (decode_step / decode_step_paged with the
    kernel tick), never the argmax head; on the kernel path the windows of
    free rows alone take it."""
    from paligemma_tpu_torch.models import paligemma as t_pg

    eng = _port_engine(engine, path, 2, ("g",), False)
    calls = []

    def guarded(inner):
        def head(*a, **kw):
            seated = [r.grammar for r in eng.slots if r is not None]
            assert seated and not any(seated), "the argmax head was taken with a grammar row"
            calls.append(len(seated))
            return inner(*a, **kw)
        return head

    for name in ("decode_step_greedy", "decode_step_greedy_paged"):
        monkeypatch.setattr(t_pg, name, guarded(getattr(t_pg, name)))
    assert eng._head_argmax_tick(False) == (path == "kernel")
    got = _serve(eng, t_serving.Request, CASES["mixed"][1])
    assert got == _jax_tokens(engine, "mixed")
    assert bool(calls) == (path == "kernel")


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_paged_preemption_keeps_the_grammar_state(path):
    """A pool that preempts constrained rows after they emitted tokens: each
    is seated again in the DFA state those tokens reach, not the start
    state, so its text stays in the grammar and its tokens equal the
    unpreempted dense engine's. "lead" tells the two apart: its start state
    allows only "c", which the model never picks once "ab" is allowed."""
    _, _, tp, tq = _weights()
    kernel = path == "kernel"
    kw = dict(_kw(4), decode_params=tq, use_flash=kernel, fused_decode=kernel,
              grammars=_grammars(t_grammar, ("lead", "s")))
    specs = tuple((i, 10 + i, 6 + i % 3, 30, ("lead", None, "lead", "s")[i % 4])
                  for i in range(4))
    dense = _serve(t_serving.ServingEngine(tp, CFG, **kw), t_serving.Request, specs)
    eng = t_paged.PagedServingEngine(tp, CFG, page_size=16, n_pages=7, **kw)
    reqs = [_req(t_serving.Request, *s) for s in specs]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert eng.preemptions > 0
    resumed = [r for r in reqs if r.grammar == "lead" and r.prefix_len is not None]
    assert resumed and all(len(r.input_ids) > r.prefix_len for r in resumed)
    for r in reqs:
        assert r.done and list(r.tokens) == dense[r.request_id], r.request_id
        if r.grammar is not None:
            text = _text(r.tokens)
            assert _byte_dfa(r.grammar).is_live_prefix(text), (r.request_id, text)


def test_grammar_rejections():
    _, _, tp, tq = _weights()
    eng = t_serving.ServingEngine(tp, CFG, max_slots=2, max_seq_len=64, decode_params=tq,
                                  grammars=_grammars(t_grammar, ("g",)))
    with pytest.raises(ValueError, match="unknown grammar"):
        eng.submit(_req(t_serving.Request, 0, 1, 4, 4, grammar="nope"))
    bad = _req(t_serving.Request, 0, 1, 4, 4, grammar="g")
    bad.eos_token_id = -1
    with pytest.raises(ValueError, match="eos_token_id"):
        eng.submit(bad)
    assert not eng.has_work
    plain = t_paged.PagedServingEngine(tp, CFG, max_slots=2, max_seq_len=64, page_size=16,
                                       decode_params=tq)
    with pytest.raises(ValueError, match="unknown grammar"):
        plain.submit(_req(t_serving.Request, 0, 1, 4, 4, grammar="g"))
    other = t_grammar.compile_token_dfa(t_grammar.compile_regex("a+"), TOKEN_STRS[:100], EOS)
    with pytest.raises(ValueError, match="compiled for vocab 100"):
        t_serving.ServingEngine(tp, CFG, max_slots=2, max_seq_len=64, grammars={"g": other})
    # a mesh with a data axis: the dense engine refuses it (JAX's reason:
    # slots are the batch); the paged engine takes grammars on each shard
    from paligemma_tpu_torch.core.mesh import Mesh

    with pytest.raises(ValueError, match="pure TP"):
        t_serving.ServingEngine(tp, CFG, max_slots=2, max_seq_len=64, mesh=Mesh(data=2),
                                grammars=_grammars(t_grammar, ("g",)))
    dp = t_paged.PagedServingEngine(tp, CFG, max_slots=2, max_seq_len=64, page_size=16,
                                    mesh=Mesh(data=2), grammars=_grammars(t_grammar, ("g",)),
                                    fused_decode=False)
    assert dp.grammar_table is not None and dp.state["dstate"].shape == (1,)


def test_grammar_table_layout():
    """Row 0 unconstrained, each grammar padded with rejecting states, on
    the engine's device."""
    _, _, tp, tq = _weights()
    gs = _grammars(t_grammar, ("g", "choice"))
    eng = t_serving.ServingEngine(tp, CFG, max_slots=2, max_seq_len=64, decode_params=tq,
                                  grammars=gs)
    t = eng.grammar_table
    s_max = max(g.num_states for g in gs.values())
    assert t.shape == (3, s_max, V) and t.dtype == torch.int16
    assert t.device == tp["lm"]["embed"].device and not t[0].any()
    for i, g in enumerate(gs.values(), 1):
        np.testing.assert_array_equal(t[i, :g.num_states].numpy(), g.table)
        assert (t[i, g.num_states:] == -1).all()
