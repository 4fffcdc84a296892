"""The port's tensor-parallel engines as a whole against the JAX package's
(CPU; the JAX side on the conftest's 8 virtual devices, Pallas in interpret
mode), on tests/test_torch_tp.py's tiny config and weights.

``torch.multiprocessing`` spawns m ranks on gloo (a ``file://`` store in
``tmp_path``); each runs the port's engines under ``make_mesh`` and writes
its tokens. Greedy tokens must equal JAX's ``make_mesh(1, m)`` engines' and
the port's one-card engines'; sampled tokens must be equal on every rank
(each rank's generator draws from the same seed over the same gathered
logits). The spawned entry ``_rank_main`` and this module's top level
import no JAX (the JAX imports live in the test functions and in
test_torch_tp's helpers), so the children do not load it.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from paligemma_tpu_torch.core.mesh import make_mesh
from test_torch_tp import N_IMG, _cfg, _jcfg, _weights

torch.set_num_threads(2)

REQS = ((0, 10, 3, 5, False), (1, 11, 5, 4, False), (2, 12, 4, 6, False),
        (3, 13, 3, 5, True))  # (id, seed, text tokens, new tokens, sample)


def _requests(cls, sampled=True):
    """REQS as ``cls`` (either package's Request); ``sampled=False`` drops
    the sampled one."""
    out = []
    for rid, seed, n_txt, n_new, sample in REQS:
        if sample and not sampled:
            continue
        r = np.random.default_rng(seed)
        ids = np.concatenate([np.full((N_IMG,), 250), r.integers(3, 240, (n_txt,))])
        out.append(cls(request_id=rid, input_ids=ids.astype(np.int32),
                       pixel_values=r.normal(size=(3, 28, 28)).astype(np.float32),
                       max_new_tokens=n_new, do_sample=sample, temperature=0.9, top_p=0.9,
                       eos_token_id=-1))
    return out


def _prompt():
    """generate's one prompt: the image tokens and 4 text tokens."""
    rng = np.random.default_rng(0)
    ids = np.concatenate([np.full((1, N_IMG), 250), rng.integers(5, 240, (1, 4))], 1)
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


def _rank_main(rank, world, init, weights_file, out_dir, serve):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        params, qparams, vocab = torch.load(weights_file, weights_only=True)
        out = _port_runs(params, qparams, _cfg(vocab), make_mesh(1, world), serve)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, m, vocab, serve):
    _, _, tp, tq = _weights(vocab)
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
