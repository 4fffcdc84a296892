"""The port's tensor-parallel engines as a whole against the JAX package's
(CPU; the JAX side on the conftest's 8 virtual devices, Pallas in interpret
mode), on tests/test_torch_tp.py's tiny config and weights.

``torch.multiprocessing`` spawns m ranks on gloo (a ``file://`` store in
``tmp_path``); each runs the port's engines under ``make_mesh`` and writes
its tokens. Greedy tokens must equal JAX's ``make_mesh(1, m)`` engines' and
the port's one-card engines'; sampled tokens must be equal on every rank
(each rank's generator draws from the same seed over the same gathered
logits). The same on the unmodified ``tiny_test_config`` (4 query heads
over 2 KV heads), where JAX's engines take their XLA step and the port's
the torch-op TP step: 2 ranks each hold one KV head, 4 ranks share each
KV head in pairs. The spawned entry ``_rank_main`` and this module's top level
import no JAX (the JAX imports live in the test functions and in
test_torch_tp's helpers), so the children do not load it.
"""

import datetime
import functools
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.core.mesh import make_mesh
from test_torch_tp import N_IMG, _cfg, _jcfg, _weights

torch.set_num_threads(2)

REQS = ((0, 10, 3, 5, False), (1, 11, 5, 4, False), (2, 12, 4, 6, False),
        (3, 13, 3, 5, True))  # (id, seed, text tokens, new tokens, sample)


def _requests(cls, sampled=True, image_token=250):
    """REQS as ``cls`` (either package's Request); ``sampled=False`` drops
    the sampled one."""
    out = []
    for rid, seed, n_txt, n_new, sample in REQS:
        if sample and not sampled:
            continue
        r = np.random.default_rng(seed)
        ids = np.concatenate([np.full((N_IMG,), image_token), r.integers(3, 240, (n_txt,))])
        out.append(cls(request_id=rid, input_ids=ids.astype(np.int32),
                       pixel_values=r.normal(size=(3, 28, 28)).astype(np.float32),
                       max_new_tokens=n_new, do_sample=sample, temperature=0.9, top_p=0.9,
                       eos_token_id=-1))
    return out


def _prompt(image_token=250):
    """generate's one prompt: the image tokens and 4 text tokens."""
    rng = np.random.default_rng(0)
    ids = np.concatenate([np.full((1, N_IMG), image_token), rng.integers(5, 240, (1, 4))], 1)
    return (rng.normal(size=(1, 3, 28, 28)).astype(np.float32), ids.astype(np.int32),
            np.ones((1, ids.shape[1]), np.int32))


def _port_runs(params, qparams, cfg, mesh, serve: bool):
    """The port's engines (kernel path, plain versions on the CPU): generate
    greedy (the kernel path and, under a mesh, the plain sharded path too),
    and with ``serve`` the dense and paged engines on REQS."""
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import Request, ServingEngine
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    pix, ids, mask = _prompt()
    out = {}
    paths = (True, False) if mesh is not None else (True,)
    for fused in paths:
        eng = PaliGemmaEngine(params, cfg, max_seq_len=64, eos_token_id=1, use_flash=False,
                              decode_params=qparams, fused_layer=fused, mesh=mesh)
        out[f"generate_{fused}"] = eng.generate(pix, ids, mask, max_new_tokens=6, sync_every=3)
    if serve:
        for name, make in (("dense", lambda: ServingEngine(
                params, cfg, max_slots=2, max_seq_len=32, use_flash=False,
                decode_params=qparams, fused_decode=True, mesh=mesh)),
                           ("paged", lambda: PagedServingEngine(
                params, cfg, max_slots=2, max_seq_len=32, page_size=16, use_flash=False,
                decode_params=qparams, fused_decode=True, mesh=mesh))):
            eng = make()
            assert eng.fused_decode and (name == "dense" or eng.paged_kernel == (
                "fused" if mesh is None else "fused_tp"))
            reqs = _requests(Request)
            for r in reqs:
                eng.submit(r)
            eng.run_to_completion()
            out[name] = {r.request_id: list(r.tokens) for r in reqs}
    return out


def _gqa_port_runs(params, qparams, mesh):
    """The port's engines on the unmodified tiny config (4 q / 2 KV heads):
    generate greedy and the prefill logits, the dense and paged engines on
    REQS, all on their default path. Under a mesh: the path each engine
    chose (the torch-op TP step: the TP chain's gate refuses 2 KV heads),
    that an explicit request for the chain raises, and that
    ``unshard_params`` inverts ``shard_params`` on both trees."""
    from paligemma_tpu_torch.core import mesh as t_mesh
    from paligemma_tpu_torch.core.config import tiny_test_config
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import Request, ServingEngine
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    cfg = tiny_test_config()
    tok = cfg.image_token_index
    pix, ids, mask = _prompt(tok)
    out = {}
    kw = dict(use_flash=False, decode_params=qparams, mesh=mesh)
    eng = PaliGemmaEngine(params, cfg, max_seq_len=64, eos_token_id=1, **kw)
    out["prefill"] = eng.prefill(pix, ids, mask)[0].numpy()
    out["generate"] = eng.generate(pix, ids, mask, max_new_tokens=6, sync_every=3)
    dense = dict(max_slots=2, max_seq_len=32, **kw)
    paged = dict(dense, page_size=16)
    if mesh is not None:
        out["paths"] = [eng.fused_layer]
        for make, args, flag in ((PaliGemmaEngine, dict(max_seq_len=64, **kw), "fused_layer"),
                                 (ServingEngine, dense, "fused_decode"),
                                 (PagedServingEngine, paged, "fused_decode")):
            with pytest.raises(ValueError, match="supported"):
                make(params, cfg, **args, **{flag: True})
        out["round_trip"] = [
            all(torch.equal(a, b) for a, b in zip(_tensors(tree["lm"]), _tensors(
                t_mesh.unshard_params(t_mesh.shard_params(tree["lm"], mesh, kv_heads=2), mesh,
                                      kv_heads=2))))
            for tree in (params, qparams)]
    for name, make in (("dense", lambda: ServingEngine(params, cfg, **dense)),
                       ("paged", lambda: PagedServingEngine(params, cfg, **paged))):
        eng = make()
        if mesh is not None:
            out["paths"] += [eng.fused_decode, eng._tp_chain_fits()]
        reqs = _requests(Request, image_token=tok)
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out[name] = {r.request_id: list(r.tokens) for r in reqs}
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return [tree]


def _rank_main(rank, world, init, weights_file, out_dir, serve):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        params, qparams, vocab = torch.load(weights_file, weights_only=True)
        mesh = make_mesh(1, world)
        out = (_gqa_port_runs(params, qparams, mesh) if vocab is None
               else _port_runs(params, qparams, _cfg(vocab), mesh, serve))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, m, vocab, serve):
    """m ranks of ``_rank_main`` (``vocab`` None: the tiny config's GQA
    runs); rank 0's outputs, checked equal on every rank."""
    _, _, tp, tq = _weights(vocab) if vocab is not None else _gqa_weights()
    wf = str(tmp_path / f"w{m}_{vocab}.pt")
    torch.save((tp, tq, vocab), wf)
    init = str(tmp_path / f"init{m}_{vocab}")
    ctx = tmp.start_processes(_rank_main, args=(m, init, wf, str(tmp_path), serve), nprocs=m,
                              start_method="spawn", join=False)
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):  # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{m} ranks did not finish in 300 s")
    outs = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(m)]
    for o in outs[1:]:
        for k in outs[0]:
            v0, v = outs[0][k], o[k]
            assert (np.array_equal(v0, v) if isinstance(v0, np.ndarray) else v0 == v), k
    return outs[0]


def _jax_tokens(m, vocab, serve):
    """JAX's make_mesh(1, m) engines (kernels in interpret mode) on the same
    weights: generate greedy, and the dense and paged serving engines."""
    import jax.numpy as jnp

    from paligemma_tpu.core.mesh import make_mesh as j_make_mesh
    from paligemma_tpu.runtime import serving as j_serving
    from paligemma_tpu.runtime import serving_paged as j_paged
    from paligemma_tpu.runtime.engine import PaliGemmaEngine as JEngine

    jp, jq, _, _ = _weights(vocab)
    cfg, mesh = _jcfg(vocab), j_make_mesh(1, m)
    pix, ids, mask = _prompt()
    eng = JEngine(jp, cfg, max_seq_len=64, eos_token_id=1, fused_layer=True,
                  use_flash=False, mesh=mesh, decode_params=jq)
    assert eng._tp_packed is not None
    out = {"generate": np.asarray(eng.generate(jnp.asarray(pix), jnp.asarray(ids),
                                               jnp.asarray(mask), max_new_tokens=6,
                                               do_sample=False, sync_every=3))}
    if serve:
        for name, eng in (("dense", j_serving.ServingEngine(
                jp, cfg, max_slots=2, max_seq_len=32, use_flash=False, decode_params=jq,
                mesh=mesh, fused_decode=True)),
                          ("paged", j_paged.PagedServingEngine(
                jp, cfg, max_slots=2, max_seq_len=32, page_size=16, use_flash=False,
                decode_params=jq, mesh=mesh))):
            reqs = _requests(j_serving.Request, sampled=False)
            for r in reqs:
                eng.submit(r)
            eng.run_to_completion()
            out[name] = {r.request_id: list(r.tokens) for r in reqs}
    return out


@pytest.mark.parametrize("m,vocab,serve", [(2, 256, True), (4, 256, False), (2, 272, False)])
def test_tp_engines_match_jax_and_one_card(tmp_path, m, vocab, serve):
    """Greedy tokens of the port's TP engines on m gloo ranks: identical on
    every rank, to JAX's make_mesh(1, m) engines and to the port's one-card
    engines; the sampled request's tokens identical on every rank. Vocab
    272 over 2 ranks pads each 136-column shard to 256 in the argmax head:
    padding never wins."""
    got = _spawn(tmp_path, m, vocab, serve)
    want = _jax_tokens(m, vocab, serve)
    _, _, tp, tq = _weights(vocab)
    one = _port_runs(tp, tq, _cfg(vocab), None, serve)
    for fused in (True, False):
        assert np.array_equal(got[f"generate_{fused}"], want["generate"]), fused
    assert np.array_equal(one["generate_True"], want["generate"])
    if serve:
        for name in ("dense", "paged"):
            greedy = {rid: toks for rid, toks in got[name].items() if not REQS[rid][4]}
            assert greedy == want[name] == {k: one[name][k] for k in want[name]}, name
            assert len(got[name][3]) == REQS[3][3]  # the sampled request finished


@functools.lru_cache(maxsize=None)
def _gqa_weights():
    """The unmodified tiny config's weights (4 q / 2 KV heads): JAX's fp32
    params and the int8 tree JAX quantized; the port's copies."""
    import jax

    from paligemma_tpu.core.config import tiny_test_config
    from paligemma_tpu.models import paligemma as j_pg
    from paligemma_tpu.runtime.quantize import quantize_lm_for_serving

    jp = j_pg.init_params(jax.random.PRNGKey(1), tiny_test_config())
    jq = quantize_lm_for_serving(jp)
    to_port = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    return jp, jq, to_port(jp), to_port(jq)


def _jax_gqa(m):
    """JAX's make_mesh(1, m) engines on the tiny config's weights, each
    asked for its TP kernels (it takes its XLA step: 2 KV heads): the
    prefill logits, generate greedy, the dense and paged engines."""
    import jax.numpy as jnp

    from paligemma_tpu.core.config import tiny_test_config
    from paligemma_tpu.core.mesh import make_mesh as j_make_mesh
    from paligemma_tpu.runtime import serving as j_serving
    from paligemma_tpu.runtime import serving_paged as j_paged
    from paligemma_tpu.runtime.engine import PaliGemmaEngine as JEngine

    jp, jq, _, _ = _gqa_weights()
    cfg, mesh = tiny_test_config(), j_make_mesh(1, m)
    pix, ids, mask = (jnp.asarray(a) for a in _prompt(cfg.image_token_index))
    eng = JEngine(jp, cfg, max_seq_len=64, eos_token_id=1, fused_layer=True, use_flash=False,
                  mesh=mesh, decode_params=jq)
    assert eng._tp_packed is None
    out = {"prefill": np.asarray(eng.prefill(pix, ids, mask)[0]).reshape(1, -1),
           "generate": np.asarray(eng.generate(pix, ids, mask, max_new_tokens=6,
                                               do_sample=False, sync_every=3))}
    for name, eng in (("dense", j_serving.ServingEngine(
            jp, cfg, max_slots=2, max_seq_len=32, use_flash=False, decode_params=jq, mesh=mesh,
            fused_decode=True)),
                      ("paged", j_paged.PagedServingEngine(
            jp, cfg, max_slots=2, max_seq_len=32, page_size=16, use_flash=False,
            decode_params=jq, mesh=mesh))):
        assert getattr(eng, "_tp_packed", None) is None
        reqs = _requests(j_serving.Request, sampled=False, image_token=cfg.image_token_index)
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out[name] = {r.request_id: list(r.tokens) for r in reqs}
    return out


@pytest.mark.parametrize("m", [2, 4])
def test_tp_engines_gqa_match_jax_and_one_card(tmp_path, m):
    """The unmodified tiny config (4 q / 2 KV heads; m = 2: a KV head a
    rank, m = 4: two ranks a KV head) on m gloo ranks: every engine takes
    the torch-op TP step on its own (and raises when the TP chain is asked
    for explicitly), ``unshard_params`` inverts ``shard_params``; the
    prefill logits equal JAX's make_mesh(1, m) engine's and the port's one
    card's within 1e-4 of the largest (fp32 sums in another order), and the
    greedy tokens of generate and of the dense and paged engines equal
    theirs exactly (the sampled request's identical on every rank)."""
    got = _spawn(tmp_path, m, None, True)
    want = _jax_gqa(m)
    _, _, tp, tq = _gqa_weights()
    one = _gqa_port_runs(tp, tq, None)
    assert got["paths"] == [False] * 5 and got["round_trip"] == [True, True]
    for ref in (want["prefill"], one["prefill"]):
        assert np.abs(got["prefill"] - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.array_equal(got["generate"], want["generate"])
    assert np.array_equal(one["generate"], want["generate"])
    for name in ("dense", "paged"):
        greedy = {rid: toks for rid, toks in got[name].items() if not REQS[rid][4]}
        assert greedy == want[name] == {k: one[name][k] for k in want[name]}, name
        assert len(got[name][3]) == REQS[3][3]
