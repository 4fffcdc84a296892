"""The data axis of inference and serving (CPU): ``make_mesh(data > 1)``,
the sharded page pool and the data-parallel paged engine, on
tests/test_torch_tp.py's tiny config and weights.

Pieces, in one process: ``PagedKVCache(n_shards=2)``'s bookkeeping step
by step against JAX's (the cases of tests/test_paged_dp.py), and the spec
helpers of core/mesh against JAX's ``PartitionSpec``s on the tiny trees.

Engines: ``torch.multiprocessing`` spawns, once for the module, d = 2
gloo ranks (pure DP) and d = 2 x m = 2 ranks (DP x TP), each with a
``file://`` store in a temporary directory. Every rank runs the port's
paged engine on the kernel path (whose wrappers run their plain versions
on the CPU) on three runs: plain requests on a pool that preempts, a
feature run (a LoRA bank, a grammar row, a prefix repeat and a sampled
row) and ``spec_decode`` (a grammar row and a prefix repeat); then
``PaliGemmaEngine.generate`` at B = 2 and B = 4, greedy and sampled.
Greedy tokens must equal JAX's ``make_mesh(2, 1)`` / ``make_mesh(2, 2)``
engines' (on the conftest's 8 virtual devices) and the port's one-card
engines'; each request's slots, and so its shards, and the preemption
count must equal JAX's; sampled tokens must equal the one-card port's for
the same seed and the same slots (a row's draws are its slot's); every
rank must return the same. The JAX and one-card runs go on in this
process while the ranks run. The spawned entry ``_rank_main`` and this
module's top level import no JAX.
"""

import datetime
import functools
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.core import mesh as t_mesh
from test_torch_tp import N_IMG, _cfg, _jcfg, _weights
from test_torch_tp_features import (EOS, SERVE_REQS, SPEC_K, SPEC_REQS, TOKEN_STRS, _adapters,
                                    _grammars, _req)

torch.set_num_threads(2)

D = 2  # the data axis of both spawns
MESHES = {"dp": (D, 1), "dptp": (D, 2)}
# (id, seed, text tokens, new tokens, adapter, grammar, sampled)
# 15-token prompts take 2 slots a shard into its 4 free pages; at 22 new
# tokens each needs 3, so both shards preempt
PLAIN_REQS = tuple((i, 30 + i, 11, 22, None, None, False) for i in range(4))
# run -> (requests, pool pages, with the bank and grammars, spec_decode)
RUNS = {
    "plain": (PLAIN_REQS, 10, False, False),
    "features": (SERVE_REQS, 24, True, False),
    "spec": (SPEC_REQS, 24, False, True),
}
GENERATE = {  # name -> (batch, sampled, sync_every)
    "b2_greedy": (2, False, 2), "b4_greedy": (4, False, 2),
    "b2_sampled": (2, True, 1), "b4_sampled": (4, True, 2),
}
GEN_NEW = 6


def _engine_kw(run):
    reqs, pages, feats, spec = RUNS[run]
    return dict(max_slots=4, max_seq_len=64, page_size=16, n_pages=pages,
                sync_every=4 if run == "plain" else 2, use_flash=False,
                prefix_cache=feats or spec, spec_decode=spec, spec_draft_k=SPEC_K)


def _record_seats(eng, force=None):
    """(request id, slot) of every seating, in order (either package);
    ``force``: the seats to take instead, in their order."""
    seats = []
    take = eng._take_slot

    def take_slot(free, req):
        if force is None:
            slot = take(free, req)
        else:
            eng._planned.pop(req.request_id)
            slot = next(s for r, s in force[len(seats):] if r == req.request_id)
            free.remove(slot)
        seats.append((req.request_id, slot))
        return slot

    eng._take_slot = take_slot
    return seats


def _prompts(b):
    rng = np.random.default_rng(b)
    ids = np.concatenate([np.full((b, N_IMG), 250), rng.integers(5, 240, (b, 4))], 1)
    return (rng.normal(size=(b, 3, 28, 28)).astype(np.float32), ids.astype(np.int32),
            np.ones((b, ids.shape[1]), np.int32))


def _port_runs(params, qparams, adapters, mesh, runs=tuple(RUNS), seats=None):
    """The port's paged engine on ``runs`` and generate on every case of
    GENERATE, under ``mesh`` or on one card; ``seats``: {run: seats to
    take} (no generate then)."""
    from paligemma_tpu_torch.processing import grammar as t_grammar
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import Request
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    cfg = _cfg()
    bank = {n: params_from_numpy(a, "cpu") for n, a in adapters.items()}
    out = {}
    for run in runs:
        specs, _, feats, _ = RUNS[run]
        eng = PagedServingEngine(params, cfg, decode_params=qparams, mesh=mesh,
                                 fused_decode=True, lora_bank=bank if feats else None,
                                 grammars=_grammars(t_grammar) if feats or run == "spec" else None,
                                 **_engine_kw(run))
        want_kernel = "fused" if mesh is None or mesh.model == 1 else "fused_tp"
        assert eng.paged_kernel == want_kernel and eng.paged.n_shards == (1 if mesh is None
                                                                           else mesh.data)
        seated = _record_seats(eng, None if seats is None else seats[run])
        reqs = [_req(Request, *s) for s in specs]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out[run] = {r.request_id: list(r.tokens) for r in reqs}
        out[run + "_seats"] = seated
        out[run + "_stats"] = (eng.preemptions, eng.cache_hits, eng.prefill_calls)
    if seats is not None:
        return out
    eng = PaliGemmaEngine(params, cfg, max_seq_len=64, eos_token_id=-1, use_flash=False,
                          decode_params=qparams, fused_layer=True, mesh=mesh)
    for name, (b, sampled, sync) in GENERATE.items():
        pix, ids, mask = _prompts(b)
        out[name] = eng.generate(pix, ids, mask, max_new_tokens=GEN_NEW, do_sample=sampled,
                                 temperature=0.9, top_p=0.9, sync_every=sync,
                                 generator=torch.Generator().manual_seed(3))
    if mesh is not None:
        with pytest.raises(ValueError, match="do not split"):
            eng.generate(*_prompts(3), max_new_tokens=2)
        with pytest.raises(ValueError, match="data axis"):
            eng.generate_spec(*_prompts(1), max_new_tokens=2)
    return out


def _rank_main(rank, world, data, init, weights_file, out_dir):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=180))
    try:
        params, qparams, adapters = torch.load(weights_file, weights_only=False)
        mesh = t_mesh.make_mesh(data, world // data)
        assert (mesh.data_index, mesh.rank) == divmod(rank, world // data)
        out = _port_runs(params, qparams, adapters, mesh)
        foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "paligemma_tpu")]
        assert not foreign, foreign  # the spawned ranks import no JAX
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _same(a, b):
    return np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both spawns' outputs, started together ({"dp": ..., "dptp": ...});
    every rank of a spawn returned the same (checked here). JAX's runs and
    the one-card port's are made meanwhile."""
    _, _, tp, tq = _weights()
    root = tmp_path_factory.mktemp("dp")
    wf = str(root / "weights.pt")
    torch.save((tp, tq, _adapters()), wf)
    ctxs = {}
    for name, (d, m) in MESHES.items():
        (root / name).mkdir()
        ctxs[name] = tmp.start_processes(
            _rank_main, args=(d * m, d, str(root / name / "init"), wf, str(root / name)),
            nprocs=d * m, start_method="spawn", join=False)
    for d, m in MESHES.values():
        _jax_runs(d, m)
    _one_card()
    deadline = time.monotonic() + 400
    for name, ctx in ctxs.items():
        while not ctx.join(timeout=5):  # raises if a rank failed
            if time.monotonic() > deadline:
                for c in ctxs.values():
                    for p in c.processes:
                        p.kill()
                raise TimeoutError(f"the {name} ranks did not finish in 400 s")
    outs = {}
    for name, (d, m) in MESHES.items():
        per = [torch.load(str(root / name / f"rank{r}.pt"), weights_only=False)
               for r in range(d * m)]
        for o in per[1:]:
            for k in per[0]:
                assert _same(per[0][k], o[k]), (name, k)
        outs[name] = per[0]
    return outs


@functools.lru_cache(maxsize=None)
def _one_card():
    _, _, tp, tq = _weights()
    return _port_runs(tp, tq, _adapters(), None)


@functools.lru_cache(maxsize=None)
def _jax_runs(data, model):
    """JAX's paged engine on every run of RUNS under make_mesh(data,
    model) (the sampled row left out), and its greedy generate."""
    import jax
    import jax.numpy as jnp

    from paligemma_tpu.core.mesh import make_mesh as j_make_mesh
    from paligemma_tpu.processing import grammar as j_grammar
    from paligemma_tpu.runtime import serving as j_serving
    from paligemma_tpu.runtime import serving_paged as j_paged
    from paligemma_tpu.runtime.engine import PaliGemmaEngine as JEngine

    jp, jq, _, _ = _weights()
    cfg, mesh = _jcfg(), j_make_mesh(data, model)
    out = {}
    for run, (specs, _, feats, _) in RUNS.items():
        bank = ({n: jax.tree.map(jnp.asarray, a) for n, a in _adapters().items()}
                if feats else None)
        # pure DP: JAX's XLA page walk (its fused tick runs Pallas in
        # interpret mode here, several times slower; tests/test_torch_paged.py
        # holds the port's chain against it)
        eng = j_paged.PagedServingEngine(
            jp, cfg, decode_params=jq, mesh=mesh, lora_bank=bank,
            paged_kernel="xla" if model == 1 else "fused",
            grammars=_grammars(j_grammar) if feats or run == "spec" else None,
            **_engine_kw(run))
        seats = _record_seats(eng)
        reqs = [_req(j_serving.Request, *s) for s in specs if not s[6]]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out[run] = {r.request_id: list(r.tokens) for r in reqs}
        out[run + "_seats"] = seats
        out[run + "_stats"] = (eng.preemptions, eng.cache_hits)
    eng = JEngine(jp, cfg, max_seq_len=64, eos_token_id=-1, fused_layer=True, use_flash=False,
                  mesh=mesh, decode_params=jq)
    for name, (b, sampled, _) in GENERATE.items():
        if not sampled:
            pix, ids, mask = _prompts(b)
            out[name] = np.asarray(eng.generate(jnp.asarray(pix), jnp.asarray(ids),
                                                jnp.asarray(mask), max_new_tokens=GEN_NEW))
    return out


def _greedy(tokens, specs):
    return {rid: t for rid, t in tokens.items() if not specs[rid][6]}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("run", list(RUNS))
def test_dp_engine_matches_jax_and_one_card(ranks, mesh, run):
    """The DP paged engine (pure DP and DP x TP) on the plain run, the pool
    that preempts, the feature run and spec_decode: greedy tokens equal
    JAX's DP engine's and the one-card port's; each request sits in JAX's
    slots (so on JAX's shards); the preemptions and cache hits are JAX's;
    sampled tokens equal the one-card port's."""
    specs = RUNS[run][0]
    got, want, one = ranks[mesh], _jax_runs(*MESHES[mesh]), _one_card()
    assert _greedy(got[run], specs) == want[run] == _greedy(one[run], specs), run
    if any(s[6] for s in specs):  # the sampled row: one card on the same seats
        _, _, tp, tq = _weights()
        seated = _port_runs(tp, tq, _adapters(), None, (run,), {run: got[run + "_seats"]})
        assert seated[run + "_seats"] == got[run + "_seats"]
        assert seated[run] == got[run]
    assert [s for s in got[run + "_seats"] if not specs[s[0]][6]] == want[run + "_seats"]
    shards = {s // 2 for _, s in got[run + "_seats"]}
    assert shards == {0, 1}  # both shards served
    assert got[run + "_stats"][:2] == want[run + "_stats"]
    if run == "plain":
        assert got[run + "_stats"][0] >= 2
    if RUNS[run][2] or RUNS[run][3]:
        assert got[run + "_stats"][1] >= 1  # the repeat was a hit
        constrained = [t for s in specs if s[5] for t in got[run][s[0]] if t != EOS]
        assert constrained and all(TOKEN_STRS[t] for t in constrained)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(GENERATE))
def test_dp_generate_matches_one_card(ranks, mesh, case):
    """generate under a data axis at B = 2 and B = 4: the whole batch on
    every rank; greedy, JAX's DP generate's tokens and the one-card port's;
    sampled, the one-card port's for the same seed."""
    got = ranks[mesh][case]
    b = GENERATE[case][0]
    assert got.shape == (b, GEN_NEW)
    assert np.array_equal(got, _one_card()[case])
    if not GENERATE[case][1]:
        assert np.array_equal(got, _jax_runs(*MESHES[mesh])[case])


# ------------------------------------------------------------ pieces ----
def _both_caches(n_pages, page_size, max_slots, width, n_shards=1):
    from paligemma_tpu.runtime.paged_cache import PagedKVCache as JCache
    from paligemma_tpu_torch.runtime.paged_cache import PagedKVCache as TCache

    jc = JCache(_jcfg().text_config, n_pages, page_size, max_slots, width, n_shards=n_shards)
    tc = TCache(_cfg().text_config, n_pages, page_size, max_slots, width, torch.float32,
                n_shards, device="cpu", shard=n_shards - 1)
    return jc, tc


def _same_books(jc, tc):
    assert [jc.free_pages(s) for s in range(jc.n_shards)] == \
        [tc.free_pages(s) for s in range(tc.n_shards)]
    assert np.array_equal(jc._table_np, tc._table_np)
    for slot in range(jc.max_slots):
        assert jc.slot_pages(slot) == tc.slot_pages(slot)
        assert jc.shard_of(slot) == tc.shard_of(slot)


def test_sharded_cache_matches_jax_step_by_step():
    """tests/test_paged_dp.py's shard cases on both caches, the bookkeeping
    held equal after every step; the port's device pool and page table are
    its own shard's (the last here)."""
    jc, tc = _both_caches(16, 16, 4, 4, 2)
    assert (tc.slots_per_shard, tc.pages_per_shard) == (jc.slots_per_shard,
                                                          jc.pages_per_shard) == (2, 8)
    assert tc.pool["k"].shape[1] == 8 and tuple(tc.page_table.shape) == (2, 4)
    _same_books(jc, tc)
    steps = [("grow", 0, 32, True), ("grow", 2, 48, True), ("grow", 3, 64, True),
             ("grow", 2, 64, False), ("grow", 1, 64, True), ("release", 2),
             ("grow", 2, 16, True), ("release", 0), ("grow", 0, 64, False),
             ("grow", 0, 48, True)]
    for step in steps:
        if step[0] == "grow":
            _, slot, n, ok = step
            assert jc.grow_to(slot, n) == tc.grow_to(slot, n) == ok, step
        else:
            jc.release(step[1])
            tc.release(step[1])
        _same_books(jc, tc)
        assert all(0 < p < 8 for s in range(4) for p in tc.slot_pages(s))
    assert np.array_equal(tc.page_table.numpy(), tc._table_np[2:])
    with pytest.raises(AssertionError):
        tc.alloc  # one allocator per shard: name the slot's
    jc1, tc1 = _both_caches(8, 16, 2, 4)
    assert tc1.alloc.free_pages == jc1.alloc.free_pages == 7
    assert tc1.free_pages() == 7 and tc1.shard_of(1) == 0
    from paligemma_tpu_torch.runtime.paged_cache import PagedKVCache

    with pytest.raises(ValueError, match="split over"):  # JAX asserts
        PagedKVCache(_cfg().text_config, 16, 16, 3, 4, n_shards=2, device="cpu")


def _spec_tree(tree):
    """A JAX PartitionSpec tree as the port's tuples (one entry per dim)."""
    import jax

    return jax.tree.map(lambda leaf, s: tuple(s) + (None,) * (leaf.ndim - len(tuple(s))),
                        tree[0], tree[1])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("tree", ["dense", "int8"])
def test_param_specs_follow_jax(tree):
    """param_specs on the tiny trees against JAX's param_specs, leaf by
    leaf; the differences are the documented ones only: k and v (one KV
    head) and the patch embedding replicated."""
    from paligemma_tpu.core.mesh import param_specs as j_param_specs

    jp, jq, tp, tq = _weights()
    j, t = (jp, tp) if tree == "dense" else (jq, tq)
    want = _flat(_spec_tree((j, j_param_specs(j))))
    got = _flat(t_mesh.param_specs(t))
    assert set(got) <= set(want)
    differ = {k for k in got if got[k] != want[k]}
    documented = {k for k in got if "patch_embed" in k
                  or ("lm" in k and ("k" in k[-2:] or "v" in k[-2:]))}
    assert differ == documented, sorted(differ ^ documented)
    assert all(t_mesh.MODEL not in got[k] for k in documented)
    assert any(t_mesh.MODEL in s for s in got.values())


def test_lora_batch_and_cache_specs_follow_jax():
    """lora_specs against JAX's (k and v's B replicated: one KV head),
    batch_spec and kv_cache_specs as JAX's, single_device_mesh 1 x 1; and
    shard_lora's slices are those of lora_specs."""
    from paligemma_tpu.core import mesh as j_mesh

    adapter = _adapters()["x"]
    want = j_mesh.lora_specs(adapter)["layers"]
    got = t_mesh.lora_specs(params_from_numpy(adapter, "cpu"))["layers"]
    for name, p in got.items():
        for key, spec in p.items():
            jspec = tuple(want[name][key]) + (None,) * (adapter["layers"][name][key].ndim
                                                        - len(tuple(want[name][key])))
            assert spec == ((None,) * 3 if name in ("k", "v") and key == "b" else jspec), \
                (name, key)
    assert t_mesh.batch_spec() == tuple(j_mesh.batch_spec())
    assert {k: tuple(v) for k, v in j_mesh.kv_cache_specs().items()} == t_mesh.kv_cache_specs()
    one = t_mesh.single_device_mesh()
    assert (one.data, one.model, one.data_index, one.rank) == (1, 1, 0, 0)


def test_split_axes_and_data_rows():
    """Pure DP runs one card's paths on its rows (no model mesh); DP x TP
    shards over the model group; rows split evenly or raise."""
    dp = t_mesh.Mesh(data=2, data_index=1)
    assert t_mesh.split_axes(dp) == (None, dp)
    both = t_mesh.Mesh(data=2, model=2, rank=1)
    assert t_mesh.split_axes(both) == (both, both)
    tp = t_mesh.Mesh(model=2)
    assert t_mesh.split_axes(tp) == (tp, None) and t_mesh.split_axes(None) == (None, None)
    assert t_mesh.data_rows(4, dp, "x") == slice(2, 4)
    assert t_mesh.data_rows(3, None, "x") == slice(0, 3)
    with pytest.raises(ValueError, match="3 rows do not split"):
        t_mesh.data_rows(3, dp, "x")


def test_dense_engine_refuses_a_data_axis():
    """The dense ServingEngine is pure TP, with JAX's reason; the paged
    engine takes the axis, and slots or pages that do not split raise."""
    from paligemma_tpu_torch.runtime.serving import ServingEngine
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    _, _, tp, _ = _weights()
    with pytest.raises(ValueError, match="pure TP"):
        ServingEngine(tp, _cfg(), max_slots=2, max_seq_len=64, mesh=t_mesh.Mesh(data=2))
    eng = PagedServingEngine(tp, _cfg(), max_slots=4, max_seq_len=64, page_size=16,
                             mesh=t_mesh.Mesh(data=2, data_index=1), fused_decode=False)
    assert eng.paged.n_shards == 2 and eng.n_pages % 2 == 0
    assert (eng._row(1), eng._row(2), eng._row(3)) == (None, 0, 1)
    assert eng.state["write_pos"].shape == (2,)
    with pytest.raises(ValueError, match="must split"):
        PagedServingEngine(tp, _cfg(), max_slots=3, max_seq_len=64, page_size=16,
                           mesh=t_mesh.Mesh(data=2), fused_decode=False)


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        t_mesh.make_mesh(2, 1)
