"""Speculative decoding in the port against the JAX package (CPU, fp32,
seeded numpy inputs):

* ``ops.ngram.propose_ngram`` on the cases of tests/test_spec_decode.py and on
  seeded random histories;
* the plain verify forwards (``decode_verify`` with a scalar and a per-row
  start, ``decode_verify_paged`` with a block that crosses a page) against
  JAX's logits and caches, and against the port's own step-by-step decode
  (JAX's own test holds the two within 2e-4);
* the kernel route on the CPU (the wrappers' plain versions): the decode
  chain at B s rows (``rows_per_cache`` for the dense cache, each row's
  table repeated for the pool) equals the plain verify on the int8 tree,
  and at one token a row it is the kernel decode step bit for bit;
* ``PaliGemmaEngine.generate_spec``: the tokens of JAX's ``generate_spec``
  and of the port's ``generate``, on the plain path and the kernel route;
  EOS, the exact budget, the guards, and ``corrupt_frac`` (the same tokens,
  more cycles).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import GemmaConfig, PaliGemmaConfig, tiny_test_config
from paligemma_tpu.models import gemma as j_gemma
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.ops.ngram import propose_ngram as j_propose
from paligemma_tpu.runtime.engine import PaliGemmaEngine as JaxEngine
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.models import gemma as t_gemma
from paligemma_tpu_torch.models import paligemma as t_pg
from paligemma_tpu_torch.ops.ngram import propose_ngram
from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine

torch.set_num_threads(2)

TINY = tiny_test_config()


def _mqa_config():
    """The tiny tower with the MQA / head_dim-128 decoder the kernels take."""
    return PaliGemmaConfig(
        vision_config=TINY.vision_config,
        text_config=GemmaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=1, head_dim=128),
        projection_dim=128, hidden_size=128, image_token_index=510, vocab_size=512,
    )


MQA = _mqa_config()


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@functools.lru_cache(maxsize=None)
def _weights(which, seed=0):
    """(JAX params, JAX int8 tree, the port's copies) of a config."""
    cfg = TINY if which == "tiny" else MQA
    jp = j_pg.init_params(jax.random.PRNGKey(seed), cfg)
    jq = j_qserve(jp)
    return jp, jq, _to_port(jp), _to_port(jq)


def _inputs(cfg, seed=0, n_txt=6):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((1, cfg.vision_config.num_patches), cfg.image_token_index),
                          rng.integers(3, 100, (1, n_txt))], axis=1).astype(np.int32)
    px = rng.normal(size=(1, 3, 28, 28)).astype(np.float32)
    return px, ids, np.ones_like(ids)


# ---------------------------------------------------------------- proposer ---
@pytest.mark.parametrize("hist,hl,m,k,want", [
    ([5, 6, 7, 1, 5, 6, 9, 5, 6] + [0] * 7, 9, 2, 3, [9, 5, 6]),  # the most recent match
    ([1, 2, 3, 1, 2, 3, 1, 2, 0, 0, 0, 0], 8, 2, 5, [3, 1, 2, 3, 1]),  # the period wraps
    ([1, 2, 3, 4, 5, 0, 0, 0], 5, 2, 4, [5, 5, 5, 5]),  # no match repeats the last
    ([1, 2, 9, 9, 1, 2, 7, 7], 6, 2, 2, [9, 9]),  # a stale tail past hist_len is not read
], ids=["most_recent", "period_wrap", "no_match", "stale_tail"])
def test_propose_ngram_cases(hist, hl, m, k, want):
    h = np.asarray([hist], np.int32)
    got = propose_ngram(torch.from_numpy(h).long(), torch.tensor([hl]), m, k)
    assert got.tolist() == [want]
    assert np.asarray(j_propose(jnp.asarray(h), jnp.asarray([hl]), m, k)).tolist() == [want]


@pytest.mark.parametrize("seed", range(4))
def test_propose_ngram_matches_jax_on_random_histories(seed):
    """Small alphabets (frequent matches, recent and old), hist_len from 0 to
    the buffer's width, match_n 1-3, draft_k 1-9."""
    rng = np.random.default_rng(seed)
    b, s = 16, 40
    hist = rng.integers(0, 2 + seed, (b, s)).astype(np.int32)
    hl = rng.integers(0, s + 1, (b,)).astype(np.int32)
    for m in (1, 2, 3):
        for k in (1, 4, 9):
            want = np.asarray(j_propose(jnp.asarray(hist), jnp.asarray(hl), m, k))
            got = propose_ngram(torch.from_numpy(hist).long(), torch.from_numpy(hl), m, k)
            np.testing.assert_array_equal(got.numpy(), want)


def test_propose_ngram_reads_below_hist_len():
    """A planted sentinel past hist_len never appears in a draft."""
    rng = np.random.default_rng(5)
    hist = rng.integers(0, 3, (32, 24)).astype(np.int64)
    hl = rng.integers(1, 24, (32,))
    for r in range(32):
        hist[r, hl[r]:] = 99
    got = propose_ngram(torch.from_numpy(hist), torch.from_numpy(hl), 2, 8)
    assert not (got == 99).any()


# ------------------------------------------------------- plain verify forwards ---
def _dense_state(cfg, b, max_seq, seed, starts):
    """A random cache, a validity bitmap with holes below each row's start."""
    rng = np.random.default_rng(seed)
    tc = cfg.text_config
    shape = (tc.num_hidden_layers, b, max_seq, tc.num_key_value_heads, tc.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    valid = rng.random((b, max_seq)) < 0.8
    valid &= np.arange(max_seq)[None] < np.asarray(starts)[:, None]
    return k, v, valid


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_start", "per_row_start"])
def test_decode_verify_matches_jax_and_stepwise(per_row):
    jp, _, tp, _ = _weights("tiny")
    b, s, max_seq = 2, 4, 32
    starts = [11, 17] if per_row else [13, 13]
    k, v, valid = _dense_state(TINY, b, max_seq, 1, starts)
    toks = np.random.default_rng(2).integers(3, 400, (b, s)).astype(np.int32)
    pos = np.asarray([9, 14], np.int32)
    start = np.asarray(starts, np.int32) if per_row else np.int32(starts[0])
    j_logits, j_cache = j_pg.decode_verify(
        jp, TINY, jnp.asarray(toks), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(start), jnp.asarray(valid), jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    t_start = torch.from_numpy(start) if per_row else int(start)
    logits, cache = t_pg.decode_verify(tp, TINY, torch.from_numpy(toks), cache, t_start,
                                       torch.from_numpy(valid), torch.from_numpy(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=2e-5, atol=2e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(j_cache[n]), rtol=2e-5,
                                   atol=2e-5)
    # the same tokens one step at a time through the port's decode_step
    step = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    vis = torch.from_numpy(valid.copy())
    wp = torch.as_tensor(np.asarray(starts, np.int64))
    for j in range(s):
        vis[torch.arange(b), wp + j] = True
        lg, step = t_pg.decode_step(tp, TINY, torch.from_numpy(toks[:, j]), step, wp + j, vis,
                                    torch.from_numpy(pos) + j)
        np.testing.assert_allclose(lg.numpy(), logits[:, j].numpy(), rtol=2e-4, atol=2e-4)


def _paged_state(cfg, seed, n_pages=12, ps=4):
    rng = np.random.default_rng(seed)
    tc = cfg.text_config
    shape = (tc.num_hidden_layers, n_pages, ps, tc.num_key_value_heads, tc.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def test_decode_verify_paged_matches_jax_and_stepwise():
    """Row 0's block crosses a page (positions 6-9 over pages of 4); row 1's
    starts a page; a table entry past a row's pages is the garbage page."""
    jp, _, tp, _ = _weights("tiny")
    k, v = _paged_state(TINY, 3)
    table = np.asarray([[3, 7, 1, 0], [5, 2, 9, 4]], np.int32)
    wp = np.asarray([6, 8], np.int32)
    pos = np.asarray([7, 9], np.int32)
    s = 4
    toks = np.random.default_rng(4).integers(3, 400, (2, s)).astype(np.int32)
    j_logits, j_pool = j_pg.decode_verify_paged(
        jp, TINY, jnp.asarray(toks), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(table), jnp.asarray(wp), jnp.asarray(pos), pages_bucket=3)
    pool = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    logits, pool = t_pg.decode_verify_paged(tp, TINY, torch.from_numpy(toks), pool,
                                            torch.from_numpy(table), torch.from_numpy(wp),
                                            torch.from_numpy(pos), pages_bucket=3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=2e-5, atol=2e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(pool[n].numpy(), np.asarray(j_pool[n]), rtol=2e-5,
                                   atol=2e-5)
    step = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    for j in range(s):
        lg, step = t_pg.decode_step_paged(tp, TINY, torch.from_numpy(toks[:, j]), step,
                                          torch.from_numpy(table), torch.from_numpy(wp + j),
                                          torch.from_numpy(pos + j), pages_bucket=3,
                                          paged_kernel="xla")
        np.testing.assert_allclose(lg.numpy(), logits[:, j].numpy(), rtol=2e-4, atol=2e-4)


def test_forward_paged_verify_drops_writes_past_the_table():
    """A finished row whose block reaches past the table's last slot writes
    nothing there (JAX drops them); its other positions are written."""
    _, _, tp, _ = _weights("tiny")
    k, v = _paged_state(TINY, 6, n_pages=4)
    table = torch.tensor([[1, 2]], dtype=torch.int32)  # 8 slots
    pool = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    toks = torch.tensor([[5, 6, 7, 8]])
    t_pg.decode_verify_paged(tp, TINY, toks, pool, table, torch.tensor([6]), torch.tensor([7]))
    for n, ref in (("k", k), ("v", v)):
        assert not np.array_equal(pool[n][:, 2, 2:].numpy(), ref[:, 2, 2:])  # slots 6, 7
        np.testing.assert_array_equal(pool[n][:, [0, 3]].numpy(), ref[:, [0, 3]])
        np.testing.assert_array_equal(pool[n][:, 1].numpy(), ref[:, 1])


# ------------------------------------------------------ the kernel route (CPU) ---
def _int8_tree():
    return _weights("mqa")[3]


def test_layers_verify_fused_equals_the_plain_verify():
    """decode_verify on the kernel route (the chain at B*s rows and the
    logits head) against the plain verify on the same int8 tree, with a
    per-row start and holes in the validity bitmap."""
    tq = _int8_tree()
    b, s, max_seq = 2, 5, 48
    starts = [20, 31]
    k, v, valid = _dense_state(MQA, b, max_seq, 7, starts)
    toks = torch.from_numpy(np.random.default_rng(8).integers(3, 400, (b, s)))
    pos = torch.tensor([18, 25])
    wp = torch.tensor(starts, dtype=torch.int32)
    out = {}
    for route in (False, True):
        cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
        lg, cache = t_pg.decode_verify(tq, MQA, toks, cache, wp, torch.from_numpy(valid), pos,
                                       kv_bucket=40, fused_layer=route)
        ids, _ = t_pg.decode_verify(tq, MQA, toks, {n: c.clone() for n, c in cache.items()}, wp,
                                    torch.from_numpy(valid), pos, kv_bucket=40,
                                    fused_layer=route, greedy_head=True)
        out[route] = (lg, ids, cache)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-4, atol=1e-4)
    assert torch.equal(out[True][1], out[False][0].argmax(dim=-1).to(torch.int32))
    for n in ("k", "v"):
        torch.testing.assert_close(out[True][2][n], out[False][2][n], rtol=1e-5, atol=1e-5)


def test_layers_verify_fused_at_one_token_is_the_decode_chain():
    """s = 1: the kernel route's verify is the kernel decode step, the same
    logits and cache writes bit for bit (per-row starts, holes in the
    validity bitmap)."""
    tq = _int8_tree()
    b, max_seq = 3, 40
    starts = [10, 22, 5]
    k, v, valid = _dense_state(MQA, b, max_seq, 9, starts)
    toks = torch.from_numpy(np.random.default_rng(9).integers(3, 400, (b, 1)))
    wp = torch.tensor(starts, dtype=torch.int32)
    pos = wp + 2
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    got, cache = t_pg.decode_verify(tq, MQA, toks, cache, wp, torch.from_numpy(valid), pos,
                                    kv_bucket=32, fused_layer=True)
    vis = torch.from_numpy(valid.copy())
    vis[torch.arange(b), wp.long()] = True
    step = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    want, step = t_pg.decode_step(tq, MQA, toks[:, 0], step, wp, vis, pos, kv_bucket=32,
                                  fused_layer=True)
    assert got.shape == (b, 1, MQA.text_config.vocab_size)
    assert torch.equal(got[:, 0], want.reshape(b, -1))
    assert all(torch.equal(cache[n], step[n]) for n in ("k", "v"))


def test_layers_verify_fused_paged_at_one_token_is_the_paged_chain():
    """s = 1 over the pool: the kernel route's verify is the fused paged
    decode step, bit for bit."""
    tq = _int8_tree()
    tc = MQA.text_config
    rng = np.random.default_rng(10)
    shape = (tc.num_hidden_layers, 9, 16, 1, tc.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    table = torch.tensor([[4, 2, 0], [7, 1, 8]], dtype=torch.int32)
    wp = torch.tensor([17, 33], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(3, 400, (2, 1)))
    pool = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    got, pool = t_pg.decode_verify_paged(tq, MQA, toks, pool, table, wp, wp + 1,
                                         pages_bucket=3, fused_layer=True)
    step = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    want, step = t_pg.decode_step_paged(tq, MQA, toks[:, 0], step, table, wp, wp + 1,
                                        pages_bucket=3, paged_kernel="fused")
    assert torch.equal(got[:, 0], want.reshape(2, -1))
    assert all(torch.equal(pool[n], step[n]) for n in ("k", "v"))


def test_layers_verify_fused_paged_equals_the_plain_paged_verify():
    """The paged verify on the kernel route (rows' tables repeated s times,
    lengths write_pos + j + 1) against the plain page verify, a block
    crossing a page; then the argmax head on the same rows."""
    tq = _int8_tree()
    tc = MQA.text_config
    rng = np.random.default_rng(11)
    ps = 16
    shape = (tc.num_hidden_layers, 9, ps, 1, tc.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    table = torch.tensor([[4, 2, 6, 0], [7, 1, 8, 3]], dtype=torch.int32)
    wp = torch.tensor([13, 33], dtype=torch.int32)  # row 0 crosses from page 0 to 1
    pos = torch.tensor([14, 30])
    toks = torch.from_numpy(rng.integers(3, 400, (2, 6)))
    out = {}
    for route in (False, True):
        pool = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
        lg, pool = t_pg.decode_verify_paged(tq, MQA, toks, pool, table, wp, pos, pages_bucket=4,
                                            fused_layer=route)
        out[route] = (lg, pool)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-4, atol=1e-4)
    for n in ("k", "v"):
        torch.testing.assert_close(out[True][1][n], out[False][1][n], rtol=1e-5, atol=1e-5)
    pool = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    ids, _ = t_pg.decode_verify_paged(tq, MQA, toks, pool, table, wp, pos, pages_bucket=4,
                                      fused_layer=True, greedy_head=True)
    assert torch.equal(ids, out[True][0].argmax(dim=-1).to(torch.int32))


# ----------------------------------------------------------- generate_spec ---
@functools.lru_cache(maxsize=None)
def _jax_engine(which, seed):
    jp, jq, _, _ = _weights(which, seed)
    cfg = TINY if which == "tiny" else MQA
    kw = {} if which == "tiny" else dict(decode_params=jq, fused_layer=False)
    return JaxEngine(jp, cfg, max_seq_len=64, use_flash=False, **kw)


def _port_engine(which, seed, route=False, max_seq_len=64):
    _, _, tp, tq = _weights(which, seed)
    cfg = TINY if which == "tiny" else MQA
    kw = {} if which == "tiny" else dict(decode_params=tq, fused_layer=route)
    return PaliGemmaEngine(tp, cfg, max_seq_len=max_seq_len, **kw)


@pytest.mark.parametrize("which,route", [("tiny", False), ("mqa", False), ("mqa", True)],
                         ids=["plain", "int8_plain", "int8_kernel_route"])
def test_generate_spec_matches_jax_and_generate(which, route):
    cfg = TINY if which == "tiny" else MQA
    px, ids, mask = _inputs(cfg, seed=1)
    want = _jax_engine(which, 1).generate_spec(jnp.asarray(px), jnp.asarray(ids),
                                               jnp.asarray(mask), max_new_tokens=14,
                                               eos_token_id=-1, draft_k=4, match_n=2)
    eng = _port_engine(which, 1, route)
    got = eng.generate_spec(px, ids, mask, max_new_tokens=14, eos_token_id=-1, draft_k=4,
                            match_n=2, sync_every=3)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.spec_cycles == _jax_engine(which, 1).spec_cycles
    greedy = eng.generate(px, ids, mask, max_new_tokens=14, eos_token_id=-1)
    np.testing.assert_array_equal(got, greedy)


def test_generate_spec_stops_at_eos_and_keeps_the_budget():
    eng = _port_engine("tiny", 2)
    px, ids, mask = _inputs(TINY, seed=2)
    full = eng.generate(px, ids, mask, max_new_tokens=12, eos_token_id=-1)
    eos = int(full[0, 5])
    first = full[0].tolist().index(eos)
    got = eng.generate_spec(px, ids, mask, max_new_tokens=12, eos_token_id=eos, draft_k=4)
    assert got[0].tolist() == full[0, :first + 1].tolist() and got[0, -1] == eos
    jax_got = _jax_engine("tiny", 2).generate_spec(jnp.asarray(px), jnp.asarray(ids),
                                                   jnp.asarray(mask), max_new_tokens=12,
                                                   eos_token_id=eos, draft_k=4)
    np.testing.assert_array_equal(got, np.asarray(jax_got))
    for n in (1, 2, 5):
        got = eng.generate_spec(px, ids, mask, max_new_tokens=n, eos_token_id=-1, draft_k=4)
        assert got.tolist() == full[:, :n].tolist()


def test_generate_spec_guards():
    eng = _port_engine("tiny", 0, max_seq_len=32)
    px, ids, mask = _inputs(TINY)
    with pytest.raises(ValueError, match="single-request"):
        eng.generate_spec(np.concatenate([px, px]), np.concatenate([ids, ids]),
                          np.concatenate([mask, mask]), max_new_tokens=4)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate_spec(px, ids, mask, max_new_tokens=30, draft_k=8)
    from paligemma_tpu_torch.core.mesh import Mesh

    eng.dp_mesh = Mesh(data=2)  # a model axis speculates (tests/test_torch_tp_features.py)
    with pytest.raises(ValueError, match="cannot split over a data axis"):
        eng.generate_spec(px, ids, mask, max_new_tokens=4)


def test_generate_spec_corrupt_frac_keeps_the_tokens():
    """The acceptance dial: the same tokens at any value, fewer drafts
    accepted per cycle (more cycles) as it rises; 1.0 accepts none."""
    eng = _port_engine("mqa", 1, route=True)
    px, ids, mask = _inputs(MQA, seed=1)
    want = eng.generate(px, ids, mask, max_new_tokens=20, eos_token_id=-1)
    cycles = []
    for cf in (0.0, 0.5, 1.0):
        got = eng.generate_spec(px, ids, mask, max_new_tokens=20, eos_token_id=-1, draft_k=4,
                                corrupt_frac=cf,
                                generator=torch.Generator().manual_seed(3))
        np.testing.assert_array_equal(got, want)
        cycles.append(eng.spec_cycles)
    assert cycles[0] < cycles[1] < cycles[2] == 19, cycles


def test_generate_spec_window_reads_nothing_back():
    """The cycles of a window leave the row's state on its device: counts,
    flags and history are tensors, and the host reads them once a window."""
    eng = _port_engine("tiny", 1)
    px, ids, mask = _inputs(TINY, seed=1)
    st = eng.spec_start(px, ids, mask, 12, -1, 4, 2)
    eng._spec_cycles(st, 2)
    assert all(torch.is_tensor(st[n]) for n in ("n_out", "done", "hist", "hist_len", "wp"))
    while not eng.spec_window(st, 3):
        pass
    want = eng.generate(px, ids, mask, max_new_tokens=12, eos_token_id=-1)
    assert st["out"][:int(st["n_out"][0])].tolist() == want[0].tolist()


def test_gemma_forward_paged_verify_signature_is_jax_order():
    """forward_paged_verify(params, cfg, embeds, pos, pool, table, write_pos,
    pages_bucket) in JAX's positional order."""
    jp, _, tp, _ = _weights("tiny")
    k, v = _paged_state(TINY, 12)
    table = np.asarray([[2, 5, 0]], np.int32)
    x = np.random.default_rng(13).normal(size=(1, 3, TINY.text_config.hidden_size)).astype(
        np.float32)
    pos = np.asarray([[4, 5, 6]], np.int32)
    wp = np.asarray([3], np.int32)
    want, _ = j_gemma.forward_paged_verify(jp["lm"], TINY.text_config, jnp.asarray(x),
                                           jnp.asarray(pos), {"k": jnp.asarray(k),
                                                              "v": jnp.asarray(v)},
                                           jnp.asarray(table), jnp.asarray(wp), 2)
    got, _ = t_gemma.forward_paged_verify(tp["lm"], TINY.text_config, torch.from_numpy(x),
                                          torch.from_numpy(pos), {"k": torch.from_numpy(k),
                                                                  "v": torch.from_numpy(v)},
                                          torch.from_numpy(table), torch.from_numpy(wp), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
