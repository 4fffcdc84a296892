"""Tensor-parallel serving at the JAX package's feature set (CPU): a
multi-LoRA bank, grammars, the prefix cache and speculation under a mesh,
on tests/test_torch_tp.py's tiny config and weights.

Pieces, in one process (a hand-built ``Mesh`` names the rank):
``core/mesh.shard_lora`` against the slices of JAX's ``lora_specs`` (k and
v kept whole: one KV head), K1's plain version summed over ranks against
the one-card residual epilogue with the expand, the pack of a shard of the
bank against the pack of the whole bank sliced, and the shrink's plan at a
rank's K.

Engines: ``torch.multiprocessing`` spawns m = 2 gloo ranks once for the
module (a ``file://`` store in a temporary directory); each runs the
port's TP engines (the kernel path, whose wrappers run their plain
versions on the CPU) on every feature group and writes its tokens. Greedy
tokens must equal JAX's ``make_mesh(1, 2)`` engines' (on the conftest's 8
virtual devices) and the port's one-card engines'; every rank must emit
the same tokens, sampled ones included; an adapter row's logits through
the engine's own tick must equal the one-card engine's to fp32 sum order.
The spawned entry ``_rank_main`` and this module's top level import no JAX.

The launcher (cli/ranks): a rank that raises ends the rank that waits for
it in a collective, and the launching process exits 1.
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
from paligemma_tpu_torch.core.mesh import Mesh, make_mesh, shard_lora
from paligemma_tpu_torch.kernels import decode_layer as t_dl
from paligemma_tpu_torch.kernels.int8_gemv import int8_gemv_reference
from paligemma_tpu_torch.kernels.lora import ShrinkPlan, lora_shrink_reference
from paligemma_tpu_torch.train.lora import stack_lora_bank
from test_torch_tp import N_IMG, _cfg, _jcfg, _weights

torch.set_num_threads(2)

M = 2  # ranks of the spawned model axis
EOS = 1
LORA_RANK = 4
# ids 10..17 are text pieces (tests/test_grammar.py's synthetic vocab)
TOKEN_STRS = [""] * 256
for _i, _s in {10: "a", 11: "b", 12: "ab", 13: "c", 14: "x", 15: "yz", 16: "12",
               17: "3"}.items():
    TOKEN_STRS[_i] = _s
GRAMMAR = ("g", "(ab)+c?")
# (id, seed, text tokens, new tokens, adapter, grammar, sampled): base and
# adapter rows (tests/test_multilora.py:160-163), a constrained row, a
# byte-identical repeat of request 1 (a prefix-cache hit) and a sampled row
SERVE_REQS = ((0, 1, 6, 6, None, None, False), (1, 2, 5, 6, "x", None, False),
              (2, 3, 7, 6, "y", None, False), (3, 4, 4, 6, "x", None, False),
              (4, 5, 5, 6, None, "g", False), (5, 2, 5, 6, "x", None, False),
              (6, 7, 5, 6, None, None, True))
# speculation (greedy only, no bank): a constrained row and a repeat
SPEC_REQS = ((0, 1, 6, 8, None, None, False), (1, 5, 5, 8, None, "g", False),
             (2, 1, 6, 8, None, None, False), (3, 3, 4, 8, None, None, False))
SPEC_K = 3
# engine run -> (engine, requests, with the bank ("bf16": its adapters held
# in bf16 in both frameworks), spec_decode, kernel path)
RUNS = {
    "dense": ("dense", SERVE_REQS, True, False, True),
    "dense_bf16_bank": ("dense", SERVE_REQS, "bf16", False, True),
    "dense_plain": ("dense", SERVE_REQS, True, False, False),
    "paged": ("paged", SERVE_REQS, True, False, True),
    "paged_plain": ("paged", SERVE_REQS, True, False, False),
    "dense_spec": ("dense", SPEC_REQS, False, True, True),
    "paged_spec": ("paged", SPEC_REQS, False, True, True),
}


def _adapter_np(seed, cfg):
    """A LoRA tree with nonzero deltas on every projection, as numpy."""
    h, nq, hd, inter = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim, cfg.head_dim, \
        cfg.intermediate_size
    dims = {"q": (h, nq), "k": (h, hd), "v": (h, hd), "o": (nq, h), "gate": (h, inter),
            "up": (h, inter), "down": (inter, h)}
    rng = np.random.default_rng(seed)
    n = cfg.num_hidden_layers
    return {"layers": {name: {
        "a": (rng.normal(size=(n, i, LORA_RANK)) * i**-0.5).astype(np.float32),
        "b": (rng.normal(size=(n, LORA_RANK, o)) * 0.05).astype(np.float32),
        "alpha": np.full((n,), 8.0, np.float32)} for name, (i, o) in dims.items()}}


def _adapters():
    tc = _cfg().text_config
    return {"x": _adapter_np(11, tc), "y": _adapter_np(12, tc)}


def _grammars(pkg):
    dfa = pkg.compile_regex(GRAMMAR[1])
    return {GRAMMAR[0]: pkg.compile_token_dfa(dfa, TOKEN_STRS, EOS)}


def _req(cls, rid, seed, n_txt, max_new, lora, grammar, sample):
    r = np.random.default_rng(seed)
    ids = np.concatenate([np.full((N_IMG,), 250), r.integers(3, 240, (n_txt,))])
    return cls(request_id=rid, input_ids=ids.astype(np.int32),
               pixel_values=r.normal(size=(3, 28, 28)).astype(np.float32),
               max_new_tokens=max_new, do_sample=sample, temperature=0.9, top_p=0.9,
               eos_token_id=EOS, lora=lora, grammar=grammar)


def _prompt():
    rng = np.random.default_rng(0)
    ids = np.concatenate([np.full((1, N_IMG), 250), rng.integers(5, 240, (1, 4))], 1)
    return (rng.normal(size=(1, 3, 28, 28)).astype(np.float32), ids.astype(np.int32),
            np.ones((1, ids.shape[1]), np.int32))


def _engine_kw(bank, spec, kernel):
    return dict(max_slots=2, max_seq_len=64, sync_every=2, use_flash=False,
                fused_decode=kernel, prefix_cache=True, lora_bank=bank, spec_decode=spec,
                spec_draft_k=SPEC_K)


def _bank_logits(eng, spec, steps=4):
    """Request ``spec``'s fp32 logits through ``eng``'s bank (the engine's
    own prefill and tick: the plain path or the kernel chain): its prefill,
    then ``steps`` decode steps on its own greedy tokens. (steps + 1, V)."""
    from paligemma_tpu_torch.models import gemma, paligemma
    from paligemma_tpu_torch.runtime.serving import Request

    req = _req(Request, *spec)
    cfg = eng.config
    n = len(req.input_ids)
    ids = torch.from_numpy(req.input_ids[None].astype(np.int64))
    aid = torch.tensor([eng._lora_index[req.lora]], dtype=torch.int32)
    cache = gemma.init_kv_cache(cfg.text_config, 1, 64, eng.cache_dtype, device="cpu")
    logits, cache = paligemma.prefill(eng.params, cfg, torch.from_numpy(req.pixel_values[None]),
                                      ids, torch.ones_like(ids, dtype=torch.int32), cache,
                                      last_only=True, lora=eng.lora_bank, adapter_ids=aid,
                                      mesh=eng.mesh)
    out = [logits[0, 0]]
    valid = torch.zeros((1, 64), dtype=torch.bool)
    valid[0, :n] = True
    for t in range(steps):
        pos = torch.tensor([n + t], dtype=torch.int32)
        valid[0, n + t] = True
        step, _ = paligemma.decode_step(eng.decode_params, cfg, out[-1].argmax()[None], cache,
                                        cache_pos=pos, kv_valid=valid, position_ids=pos + 1,
                                        fused_layer=eng.fused_decode, lora=eng._lora_arg(),
                                        adapter_ids=aid, mesh=eng.mesh)
        out.append(step[0])
    return torch.stack(out).numpy()


def _port_runs(params, qparams, adapters, mesh):
    """The port's engines on every run of RUNS and generate_spec (each
    request's tokens), under ``mesh`` or on one card."""
    from paligemma_tpu_torch.processing import grammar as t_grammar
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import Request, ServingEngine
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    cfg = _cfg()
    banks = {dtype: {n: params_from_numpy(a, "cpu", dtype) for n, a in adapters.items()}
             for dtype in (None, torch.bfloat16)}
    out = {}
    for run, (kind, specs, with_bank, spec, kernel) in RUNS.items():
        bank = banks[torch.bfloat16 if with_bank == "bf16" else None]
        kw = _engine_kw(bank if with_bank else None, spec, kernel)
        if kind == "paged":
            eng = PagedServingEngine(params, cfg, page_size=16, n_pages=24, decode_params=qparams,
                                     mesh=mesh, grammars=_grammars(t_grammar), **kw)
            assert eng.paged_kernel == (("fused" if mesh is None else "fused_tp") if kernel
                                        else "xla")
        else:
            eng = ServingEngine(params, cfg, decode_params=qparams, mesh=mesh,
                                grammars=_grammars(t_grammar), **kw)
        assert eng.fused_decode == kernel
        if with_bank and kernel:
            assert eng._lora_fused_pack is not None  # the bank rides the chain
        reqs = [_req(Request, *s) for s in specs]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out[run] = {r.request_id: list(r.tokens) for r in reqs}
        out[run + "_hits"] = eng.cache_hits
        if with_bank is True and kind == "dense":  # request 1: adapter "x", fp32 bank
            out[run + "_logits"] = _bank_logits(eng, specs[1])
    eng = PaliGemmaEngine(params, cfg, max_seq_len=64, eos_token_id=EOS, use_flash=False,
                          decode_params=qparams, fused_layer=True, mesh=mesh)
    pix, ids, mask = _prompt()
    out["generate_spec"] = eng.generate_spec(pix, ids, mask, max_new_tokens=8, draft_k=SPEC_K,
                                             sync_every=2)
    return out


def _rank_main(rank, world, init, weights_file, out_dir):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        params, qparams, adapters = torch.load(weights_file, weights_only=False)
        out = _port_runs(params, qparams, adapters, make_mesh(1, world))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The m = 2 ranks' outputs (identical on every rank, checked here)."""
    d = tmp_path_factory.mktemp("tp_features")
    _, _, tp, tq = _weights()
    wf = str(d / "weights.pt")
    torch.save((tp, tq, _adapters()), wf)
    ctx = tmp.start_processes(_rank_main, args=(M, str(d / "init"), wf, str(d)), nprocs=M,
                              start_method="spawn", join=False)
    deadline = time.monotonic() + 400
    while not ctx.join(timeout=5):  # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{M} ranks did not finish in 400 s")
    outs = [torch.load(str(d / f"rank{r}.pt"), weights_only=False) for r in range(M)]
    for o in outs[1:]:
        for k in outs[0]:
            v0, v = outs[0][k], o[k]
            assert (np.array_equal(v0, v) if isinstance(v0, np.ndarray) else v0 == v), k
    return outs[0]


@pytest.mark.parametrize("run", ["dense", "dense_plain"])
def test_tp_bank_logits_match_one_card(ranks, run):
    """An adapter row's logits (prefill, then 4 greedy decode steps through
    the engine's tick: the TP chain with K1, or the plain sharded layers)
    on the m = 2 ranks against the one-card engine's: within 1e-4 of the
    largest logit (fp32 on the CPU: the ranks' sum order; each rank's
    partial delta of o and down must be summed across ranks)."""
    got, want = ranks[run + "_logits"], _one_card()[run + "_logits"]
    assert got.shape == want.shape == (5, 256)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _one_card():
    _, _, tp, tq = _weights()
    return _port_runs(tp, tq, _adapters(), None)


def _jax_run(run):
    """JAX's make_mesh(1, 2) engine of ``run`` (the sampled row left out);
    the port's kernel and plain paths share it."""
    return _jax_tokens(*RUNS[run][:4])


@functools.lru_cache(maxsize=None)
def _jax_tokens(kind, specs, with_bank, spec):
    import jax
    import jax.numpy as jnp

    from paligemma_tpu.core.mesh import make_mesh as j_make_mesh
    from paligemma_tpu.processing import grammar as j_grammar
    from paligemma_tpu.runtime import serving as j_serving
    from paligemma_tpu.runtime import serving_paged as j_paged

    jp, jq, _, _ = _weights()
    cfg, mesh = _jcfg(), j_make_mesh(1, M)
    dtype = jnp.bfloat16 if with_bank == "bf16" else jnp.float32
    bank = ({n: jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), a)
             for n, a in _adapters().items()} if with_bank else None)
    kw = dict(max_slots=2, max_seq_len=64, sync_every=2, use_flash=False, decode_params=jq,
              mesh=mesh, prefix_cache=True, lora_bank=bank, spec_decode=spec,
              spec_draft_k=SPEC_K, grammars=_grammars(j_grammar))
    if kind == "paged":
        eng = j_paged.PagedServingEngine(jp, cfg, page_size=16, n_pages=24, **kw)
    else:
        eng = j_serving.ServingEngine(jp, cfg, fused_decode=True, **kw)
    reqs = [_req(j_serving.Request, *s) for s in specs if not s[6]]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return {r.request_id: list(r.tokens) for r in reqs}


@functools.lru_cache(maxsize=None)
def _jax_generate():
    """JAX's greedy generate under make_mesh(1, 2): generate_spec's tokens."""
    import jax.numpy as jnp

    from paligemma_tpu.core.mesh import make_mesh as j_make_mesh
    from paligemma_tpu.runtime.engine import PaliGemmaEngine as JEngine

    jp, jq, _, _ = _weights()
    eng = JEngine(jp, _jcfg(), max_seq_len=64, eos_token_id=EOS, fused_layer=True,
                  use_flash=False, mesh=j_make_mesh(1, M), decode_params=jq)
    pix, ids, mask = _prompt()
    return np.asarray(eng.generate(jnp.asarray(pix), jnp.asarray(ids), jnp.asarray(mask),
                                   max_new_tokens=8, do_sample=False))


def _greedy(tokens, specs):
    return {rid: t for rid, t in tokens.items() if not specs[rid][6]}


@pytest.mark.parametrize("run", list(RUNS))
def test_tp_engine_features_match_jax_and_one_card(ranks, run):
    """A bank (base and adapter rows), a constrained row, a prefix-cache
    repeat and a sampled row (dense / paged, the TP chain and the plain
    sharded tick), and speculation with a grammar and the prefix cache:
    the greedy tokens of the m = 2 ranks equal JAX's make_mesh(1, 2)
    engine's and the port's one-card engine's; the repeat is a cache hit;
    every request finished."""
    specs = RUNS[run][1]
    got = ranks[run]
    want = _jax_run(run)
    one = _one_card()[run]
    assert _greedy(got, specs) == want == _greedy(one, specs), run
    assert all(len(got[s[0]]) >= 1 for s in specs)
    assert ranks[run + "_hits"] == _one_card()[run + "_hits"] >= 1
    constrained = [t for s in specs if s[5] for t in got[s[0]] if t != EOS]
    assert constrained and all(TOKEN_STRS[t] for t in constrained)  # inside the grammar
    if RUNS[run][2]:  # with the bank
        by_adapter = {s[4]: got[s[0]] for s in specs if not s[5] and not s[6]}
        assert len({tuple(v) for v in by_adapter.values()}) > 1  # adapters move tokens


def test_generate_spec_under_a_mesh(ranks):
    """generate_spec on the m = 2 ranks: the tokens of JAX's greedy generate
    under make_mesh(1, 2), and of the one-card port's generate_spec."""
    want = _jax_generate()
    got = ranks["generate_spec"]
    n = got.shape[1]
    assert np.array_equal(got, want[:, :n]) and n == 8
    assert np.array_equal(got, _one_card()["generate_spec"])


# ------------------------------------------------------------ pieces ----
@pytest.mark.parametrize("m", [1, 2, 4])
def test_shard_lora_matches_jax_lora_specs(m):
    """Each rank's adapter slices are JAX's lora_specs slices, except k and
    v (one KV head): the port keeps their B whole, as it keeps their weights
    whole (JAX shards their B). The stacked bank's shard is the stack of the
    adapters' shards, a_cat and b_cat included."""
    from paligemma_tpu.core.mesh import lora_specs

    from test_torch_tp import _local

    adapters = _adapters()
    specs = lora_specs(adapters["x"])
    port = {n: params_from_numpy(a, "cpu") for n, a in adapters.items()}
    bank = stack_lora_bank([port["x"], port["y"]])
    for r in range(m):
        mesh = Mesh(model=m, rank=r)
        got = shard_lora(port["x"], mesh)["layers"]
        for name, p in adapters["x"]["layers"].items():
            for key in ("a", "b", "alpha"):
                spec = specs["layers"][name][key]
                want = (p[key] if name in ("k", "v") and key == "b"
                        else _local(p[key], tuple(spec), m, r))
                assert np.array_equal(got[name][key].numpy(), want), (m, r, name, key)
        want_bank = stack_lora_bank([shard_lora(port[n], mesh) for n in ("x", "y")])
        got_bank = shard_lora(bank, mesh)
        for name, p in want_bank["layers"].items():
            for key, t in p.items():
                assert torch.equal(got_bank["layers"][name][key], t), (m, r, name, key)


def _o_case(m, seed=0):
    """An o-shaped row-parallel projection (K = nq, N = hidden): (x, w8, s,
    the residual h, a bank's o basis a_cat (K, G) with rank 4, its rows b
    (G, N), the rows' adapter ids)."""
    rng = np.random.default_rng(seed)
    k, n, g, b = 1024, 256, 16, 3
    x = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(torch.bfloat16)
    w8 = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy((rng.random(n) * 1e-3 + 1e-4).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(torch.bfloat16)
    a_cat = torch.from_numpy((rng.normal(size=(k, g)) * k**-0.5).astype(np.float32))
    lb = torch.from_numpy((rng.normal(size=(g, n)) * 0.5).astype(np.float32))
    ids = torch.tensor([0, 1, 3], dtype=torch.int32)
    return x, w8, s, h, a_cat, lb, ids


@pytest.mark.parametrize("m", [1, 2, 4])
def test_k1_plain_summed_over_ranks_is_the_one_card_epilogue(m, monkeypatch):
    """K1's plain version (int8_gemv_reference(out_fp32=True, lora=)) on
    each rank's K rows, summed over ranks and added as
    decode_layer_tp.add_partial adds it, against the one-card residual
    epilogue with the expand: the same bits at m = 1; at m > 1 within
    2e-2 of max |out| (each rank rounds its basis z_r to bf16, and the
    base partial's fp32 sum order changes)."""
    from paligemma_tpu_torch.core import mesh as mesh_lib
    from paligemma_tpu_torch.kernels.decode_layer_tp import add_partial

    monkeypatch.setattr(mesh_lib, "psum", lambda t, mesh: t)  # summed here
    x, w8, s, h, a_cat, lb, ids = _o_case(m)
    k = x.shape[1]
    z = lora_shrink_reference(x, a_cat, ids, 4, lb.shape[0])
    want = int8_gemv_reference(x, w8, s, residual=h, lora=(z, lb, ()))
    total = None
    for r in range(m):
        rows = slice(r * k // m, (r + 1) * k // m)
        zr = lora_shrink_reference(x[:, rows].contiguous(), a_cat[rows], ids, 4, lb.shape[0])
        part = int8_gemv_reference(x[:, rows].contiguous(), w8[rows], s, out_fp32=True,
                                   lora=(zr, lb, ()))
        assert part.shape == (x.shape[0], 2 * w8.shape[1]) and part.dtype == torch.float32
        total = part if total is None else total + part
    got = add_partial(h, total, None)
    if m == 1:
        assert torch.equal(got, want)
    else:
        err = float((got.float() - want.float()).abs().max())
        assert 0 < err <= 2e-2 * float(want.float().abs().max()), err


@pytest.mark.parametrize("m", [2, 4])
def test_pack_of_a_shard_is_the_whole_pack_sliced(m):
    """repack_lora_bank_fused of a rank's shard (at the rank's widths) is
    the pack of the whole bank sliced: qkv_b's [q_r | k | v] columns,
    gu_b's [gate_r | up_r], o_a's and down_a's rank rows; the A operands of
    column-parallel targets and the B of row-parallel ones whole."""
    tc = _cfg().text_config
    port = [params_from_numpy(a, "cpu") for a in _adapters().values()]
    bank = stack_lora_bank(port)
    h, nh, hd, inter = tc.hidden_size, tc.num_attention_heads, tc.head_dim, tc.intermediate_size
    whole = t_dl.repack_lora_bank_fused(bank["layers"], n_heads=nh, head_dim=hd, hidden=h,
                                        intermediate=inter)
    nq = nh * hd
    for r in range(m):
        got = t_dl.repack_lora_bank_fused(shard_lora(bank, Mesh(model=m, rank=r))["layers"],
                                          n_heads=nh // m, head_dim=hd, hidden=h,
                                          intermediate=inter // m)
        ql, il = nq // m, inter // m
        q_cols = list(range(r * ql, (r + 1) * ql)) + list(range(nq, nq + 2 * hd))
        gu_cols = list(range(r * il, (r + 1) * il)) + list(range(inter + r * il,
                                                                 inter + (r + 1) * il))
        assert torch.equal(got["qkv_b"], whole["qkv_b"][..., q_cols])
        assert torch.equal(got["gu_b"], whole["gu_b"][..., gu_cols])
        assert torch.equal(got["o_a"], whole["o_a"][:, r * ql:(r + 1) * ql])
        assert torch.equal(got["down_a"], whole["down_a"][:, r * il:(r + 1) * il])
        for key in ("qkv_a", "gu_a", "o_b", "down_b"):
            assert torch.equal(got[key], whole[key]), key
        assert (got["g_true"], got["rank"]) == (whole["g_true"], whole["rank"])


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_shrink_plan_takes_a_ranks_k(m):
    """The shrink of a row-parallel target reads a rank's K rows: o's
    2048 / m and down's 16384 / m at Gemma-2B's widths take a plan whose
    ranks cover K in multiples of 8, every rank with rows."""
    for k in (2048 // m, 16384 // m):
        for g in (8, 32):
            plan = ShrinkPlan.make(k, g)
            assert plan.k_per_cta % 8 == 0 and 1 <= plan.cluster <= 8
            assert (plan.cluster - 1) * plan.k_per_cta < k <= plan.cluster * plan.k_per_cta


def _rank1_raises(argv, rank):
    """cli/ranks entry: rank 1 raises while rank 0 waits in a collective."""
    if rank.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    dist.barrier()


def test_a_failed_rank_ends_the_others():
    """cli/ranks.launch: a rank that raises ends the rank blocked in a
    collective (no hang) and the launching process exits 1."""
    from paligemma_tpu_torch.cli import ranks

    t0 = time.monotonic()
    with pytest.raises(SystemExit) as ei:
        ranks.launch(_rank1_raises, [], 2, True, 120)
    assert ei.value.code == 1 and time.monotonic() - t0 < 100
