"""Exact-match prefix caching in the port's serving engines against the JAX
engines (CPU, fp32 prefill, int8 decode tree, seeded requests): the
single-device cases of tests/test_prefix_cache.py, on the port's plain
path and on its kernel path (plain versions of the kernels on the CPU).

Paged: a hit skips the prefill with the same tokens; page-aligned prefixes
share pages, and a borrowed page (or an entry's tail page) is never
written; distinct prompts do not collide; entries are evicted under pool
pressure; sampled hits resume from the stored logits (JAX's draws replayed
into the port's sampler); same-wave duplicates coalesce, also mixed with
uniques. Dense: hits, distinct prompts, same-wave coalescing and LRU at
capacity. ``prefill_calls`` and ``cache_hits`` equal JAX's.

Not here: the DP and TP cases (tests/test_prefix_cache.py:159-236), which
wait for the data axis and the mesh (ROADMAP item 14), and the
speculative-decoding case (:292-308), which waits for ROADMAP item 8.
"""

import functools

import numpy as np
import pytest
import torch

from paligemma_tpu.runtime import serving as j_serving
from paligemma_tpu.runtime import serving_paged as j_paged
from paligemma_tpu_torch.runtime import serving as t_serving
from paligemma_tpu_torch.runtime import serving_paged as t_paged
from tests.test_torch_grammar import CFG, _JaxDraws, _weights

torch.set_num_threads(2)

PATHS = ["plain", "kernel"]


def _req(cls, rid, seed, n_txt, max_new, sample=False):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((CFG.vision_config.num_patches,), CFG.image_token_index),
                          rng.integers(3, 100, (n_txt,))]).astype(np.int32)
    pixels = rng.normal(size=(3, 28, 28)).astype(np.float32)
    return cls(request_id=rid, input_ids=ids, pixel_values=pixels, max_new_tokens=max_new,
               do_sample=sample, temperature=0.7, top_p=0.9, eos_token_id=-1)


def _engine(pkg, paged, path="plain", **kw):
    jp, jq, tp, tq = _weights()
    base = dict(max_slots=2, max_seq_len=32)
    if paged:
        base["page_size"] = 16
    base.update(kw)
    if pkg == "jax":
        if paged:
            return j_paged.PagedServingEngine(jp, CFG, decode_params=jq, use_flash=False,
                                              paged_kernel="multi", **base)
        return j_serving.ServingEngine(jp, CFG, decode_params=jq, use_flash=False, **base)
    kernel = path == "kernel"
    cls = t_paged.PagedServingEngine if paged else t_serving.ServingEngine
    return cls(tp, CFG, decode_params=tq, use_flash=kernel, fused_decode=kernel, **base)


def _run(eng, specs):
    cls = t_serving.Request if isinstance(eng, t_serving.ServingEngine) else j_serving.Request
    reqs = [_req(cls, *s) for s in specs]
    for r in reqs:
        eng.submit(r)
    done = eng.run_to_completion()
    assert sorted(r.request_id for r in done) == sorted(s[0] for s in specs)
    return {r.request_id: list(r.tokens) for r in reqs}


# case -> (paged, engine kwargs, request specs (rid, seed, n_txt, max_new, sample))
CASES = {
    # :32 a prompt of 8 tokens over pages of 16: a tail-page-only entry
    "hit": (True, (("max_slots", 1),), tuple((i, 7, 4, 5) for i in range(3))),
    # :50 4 image + 12 text = one full page, shared with no tail copy
    "aligned": (True, (("max_slots", 1),), tuple((i, 11, 12, 6) for i in range(3))),
    # one full page and a tail, two rows decoding beside each other
    "full_and_tail": (True, (("max_slots", 2), ("max_seq_len", 64)),
                      tuple((i, 13, 20, 9) for i in range(3))),
    # :67
    "distinct": (True, (), ((0, 1, 4, 5), (1, 2, 4, 5), (2, 1, 4, 5))),
    # :78 a pool of 8 pages
    "eviction": (True, (("max_seq_len", 64), ("n_pages", 8), ("sync_every", 4)),
                 ((0, 5, 4, 20), (1, 6, 4, 20), (2, 5, 4, 20))),
    # :112 four identical requests in one wave: one prefill
    "same_wave": (True, (("max_slots", 4), ("n_pages", 16)),
                  tuple((i, 9, 4, 5) for i in range(4))),
    # :128 two uniques x two copies in one wave
    "same_wave_mixed": (True, (("max_slots", 4), ("n_pages", 16)),
                        tuple((i, s, 4, 5) for i, s in enumerate((1, 2, 1, 2)))),
    # :240-290 the dense engine
    "dense_hit": (False, (("max_slots", 1),), tuple((i, 7, 8, 6) for i in range(3))),
    "dense_distinct": (False, (("max_slots", 1),), ((0, 1, 8, 5), (1, 2, 8, 5), (2, 1, 8, 5))),
    "dense_same_wave": (False, (("max_slots", 4),), tuple((i, 9, 8, 5) for i in range(4))),
    "dense_lru": (False, (("max_slots", 1), ("prefix_cache_entries", 1)),
                  ((0, 1, 8, 4), (1, 2, 8, 4), (2, 1, 8, 4))),
}
# case -> (prefill_calls, cache_hits) of the cached engine, as JAX's tests state them
COUNTS = {"hit": (1, 2), "aligned": (1, 2), "same_wave": (1, 3),
          "same_wave_mixed": (1, 2), "dense_hit": (1, 2), "dense_distinct": (2, 1),
          "dense_same_wave": (1, 3), "dense_lru": (3, 0)}


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    paged, kw, specs = CASES[case]
    eng = _engine("jax", paged, prefix_cache=True, **dict(kw))
    return _run(eng, specs), eng.prefill_calls, eng.cache_hits


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", list(CASES))
def test_prefix_cache_matches_jax(case, path):
    paged, kw, specs = CASES[case]
    want, j_calls, j_hits = _jax_case(case)
    eng = _engine("port", paged, path, prefix_cache=True, **dict(kw))
    got = _run(eng, specs)
    assert got == want
    assert (eng.prefill_calls, eng.cache_hits) == (j_calls, j_hits)
    if case in COUNTS:
        assert (eng.prefill_calls, eng.cache_hits) == COUNTS[case]
    if case == "aligned":
        (entry,) = eng._pcache.values()
        assert entry["tail_page"] is None and len(entry["full_pages"]) == 1
    if case == "dense_lru":
        assert len(eng._dense_pcache) == 1
    if paged:  # every entry is released once its rows retire
        assert all(e["refs"] == 0 for e in eng._pcache.values())


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", ["aligned", "full_and_tail"])
def test_borrowed_pages_are_never_written(case, path):
    """After the first request registers its prefix, the entry's pages (the
    shared full pages and its copy of the tail page) keep their bits while
    hits borrow them and decode beside them; a hit's table row points at
    the shared pages and its tail is a page of its own."""
    paged, kw, specs = CASES[case]
    eng = _engine("port", paged, path, prefix_cache=True, **dict(kw))
    reqs = [_req(t_serving.Request, *s) for s in specs]
    for r in reqs:
        eng.submit(r)
    eng.step()
    (entry,) = eng._pcache.values()
    pages = list(entry["full_pages"]) + ([entry["tail_page"]] if entry["tail_page"] else [])
    assert pages
    snap = {n: eng.cache[n][:, pages].clone() for n in ("k", "v")}
    n_full = len(entry["full_pages"])
    seen_hit = False
    while eng.has_work:
        for slot, req in enumerate(eng.slots):
            if req is not None and eng._slot_borrow.get(slot) is not None:
                row = eng.paged._table_np[slot]
                assert list(row[:n_full]) == list(entry["full_pages"])
                assert entry["tail_page"] is None or row[n_full] != entry["tail_page"]
                seen_hit = seen_hit or req.request_id != 0
        eng.step()
    assert seen_hit and eng.cache_hits == len(specs) - 1
    for n in ("k", "v"):
        assert torch.equal(eng.cache[n][:, pages], snap[n])
    assert {r.request_id: r.tokens for r in reqs} == _jax_case(case)[0]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_sampled_hits_reuse_the_stored_logits(paged, monkeypatch):
    """tests/test_prefix_cache.py:93: a sampled hit resumes from the stored
    logits row: with JAX's draws replayed, the port's cached engine gives
    the JAX cached engine's tokens, which equal the uncached ones."""
    specs = tuple((i, 3, 4, 4, True) for i in range(2))

    def run(pkg, cached):
        eng = _engine(pkg, paged, max_slots=1, prefix_cache=cached)
        if pkg == "port":
            _JaxDraws(eng, monkeypatch)
        return _run(eng, specs), eng.cache_hits

    want, j_hits = run("jax", True)
    assert want == run("jax", False)[0] and j_hits == 1
    got, hits = run("port", True)
    assert got == want and hits == 1
    assert run("port", False)[0] == want


def test_prefix_cache_under_a_mesh_raises():
    """Under a mesh with a data axis the dense engine raises (JAX's reason:
    slots are the batch); the paged engine keeps shard-local entries
    (tests/test_torch_dp.py runs them). A model axis takes the prefix cache
    (tests/test_torch_tp_features.py)."""
    from paligemma_tpu_torch.core.mesh import Mesh

    _, _, tp, tq = _weights()
    with pytest.raises(ValueError, match="pure TP"):
        t_serving.ServingEngine(tp, CFG, max_slots=2, max_seq_len=32, mesh=Mesh(data=2),
                                prefix_cache=True)
    eng = t_paged.PagedServingEngine(tp, CFG, max_slots=2, max_seq_len=32, page_size=16,
                                     mesh=Mesh(data=2), prefix_cache=True, fused_decode=False)
    assert eng.prefix_cache and eng.paged.n_shards == 2


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_prefix_cache_key_is_hashed_once_per_request(paged, monkeypatch):
    """The key hashes a request's ids and pixels once; the admission pass,
    the hit lookup and the registration read the key kept on the request."""
    import hashlib

    hashed = []

    class _Sha1:
        def __init__(self):
            hashed.append(1)
            self._h = hashlib.sha1()

        def update(self, b):
            self._h.update(b)

        def digest(self):
            return self._h.digest()

    monkeypatch.setattr(t_serving, "hashlib", type("H", (), {"sha1": _Sha1}))
    eng = _engine("port", paged, max_slots=2, prefix_cache=True)
    specs = tuple((i, 7, 4, 3) for i in range(3))
    assert _run(eng, specs) == _run(_engine("port", paged, max_slots=2), specs)
    assert len(hashed) == len(specs) and eng.cache_hits >= 1


def test_paged_cache_lend_prefix():
    """lend_prefix moves a slot's leading pages to an entry and keeps them
    in the slot's table as borrowed: growth counts them, release leaves them
    with the entry."""
    from paligemma_tpu_torch.runtime.paged_cache import PagedKVCache

    c = PagedKVCache(CFG.text_config, n_pages=12, page_size=16, max_slots=2,
                     max_pages_per_slot=5, device="cpu")
    assert c.grow_to(0, 40)
    own = c.slot_pages(0)
    assert c.lend_prefix(0, -2, 0) == []
    lent = c.lend_prefix(0, -2, 2)
    assert lent == own[:2] and c.alloc.pages_of(-2) == lent and c.slot_pages(0) == own[2:]
    assert c.page_table[0, :3].tolist() == own
    assert c.grow_to(0, 48) and c.slot_pages(0) == own[2:]  # 3 pages: 2 borrowed + 1 owned
    with pytest.raises(ValueError, match="already borrows"):
        c.lend_prefix(0, -3, 1)
    c.release(0)
    assert c.alloc.pages_of(-2) == lent and c.alloc.free_pages == 12 - 1 - 2
    assert c.page_table[0].tolist() == [0] * 5
