"""The port's serving engines against the JAX engines (CPU, fp32, seeded
requests): the cases of tests/test_serving.py and tests/test_paged.py give
identical tokens from both frameworks, on the port's plain path and on its
kernel path (``fused_decode=True``, whose wrappers run their plain versions
on the CPU).

Both paths run one config: the tiny vision tower with the MQA /
head_dim-128 decoder the kernels take, prefill in fp32 and decode on the
int8 tree JAX quantized. Each JAX engine run is made once per case and
shared by the two paths."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import GemmaConfig, PaliGemmaConfig, tiny_test_config
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.ops import sampling as j_sampling
from paligemma_tpu.runtime import serving as j_serving
from paligemma_tpu.runtime import serving_paged as j_paged
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.ops import sampling as t_sampling
from paligemma_tpu_torch.runtime import serving as t_serving
from paligemma_tpu_torch.runtime import serving_paged as t_paged

torch.set_num_threads(2)

PATHS = ["plain", "kernel"]


def _config():
    tiny = tiny_test_config()
    return PaliGemmaConfig(
        vision_config=tiny.vision_config,
        text_config=GemmaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=1, head_dim=128),
        projection_dim=128, hidden_size=128, image_token_index=510, vocab_size=512,
    )


CFG = _config()


@functools.lru_cache(maxsize=None)
def _weights():
    jp = j_pg.init_params(jax.random.PRNGKey(0), CFG)
    jq = j_qserve(jp)
    to_port = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")  # noqa: E731
    return jp, jq, to_port(jp), to_port(jq)


def _spec(rid, seed, n_txt, max_new, sample=False):
    return (rid, seed, n_txt, max_new, sample)


def _req(cls, spec, eos=-1):
    rid, seed, n_txt, max_new, sample = spec
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((CFG.vision_config.num_patches,), CFG.image_token_index),
                          rng.integers(3, 100, (n_txt,))]).astype(np.int32)
    pixels = rng.normal(size=(3, 28, 28)).astype(np.float32)
    return cls(request_id=rid, input_ids=ids, pixel_values=pixels, max_new_tokens=max_new,
               do_sample=sample, temperature=0.9, top_p=0.9, eos_token_id=eos)


def _jax_engine(paged, **kw):
    jp, jq, _, _ = _weights()
    if paged:
        # "multi" on the CPU: JAX's plain page walk (its default "fused"
        # would run the Pallas kernel in interpret mode)
        return j_paged.PagedServingEngine(jp, CFG, decode_params=jq, use_flash=False,
                                          paged_kernel="multi", **kw)
    return j_serving.ServingEngine(jp, CFG, decode_params=jq, use_flash=False, **kw)


def _port_engine(paged, path, **kw):
    _, _, tp, tq = _weights()
    kernel = path == "kernel"
    cls = t_paged.PagedServingEngine if paged else t_serving.ServingEngine
    eng = cls(tp, CFG, decode_params=tq, use_flash=kernel, fused_decode=kernel, **kw)
    assert eng.fused_decode == kernel
    return eng


def _serve(eng, specs, eos=-1, pipeline=None, cls=None):
    reqs = [_req(cls, s, eos) for s in specs]
    for r in reqs:
        eng.submit(r)
    done = eng.run_to_completion(pipeline=pipeline)
    assert sorted(r.request_id for r in done) == sorted(s[0] for s in specs)
    return {r.request_id: list(r.tokens) for r in reqs}


@functools.lru_cache(maxsize=None)
def _jax_run(paged, kw, specs, eos=-1, pipeline=None):
    """JAX engine tokens and preemption count, once per setting (the two
    port paths share them)."""
    eng = _jax_engine(paged, **dict(kw))
    return _serve(eng, specs, eos, pipeline, j_serving.Request), getattr(eng, "preemptions", 0)


def _jax_tokens(case):
    paged, kw, specs, pipeline, _ = CASES[case]
    return _jax_run(paged, kw, specs, -1, pipeline)


def _eos():
    """The 2nd greedy token of request (0, 1, 4) as an EOS id."""
    return _jax_tokens("batching")[0][0][1]


# case -> (paged, engine kwargs, request specs, JAX pipeline, port pipeline)
CASES = {
    # tests/test_serving.py:30 (slots reused by queued requests)
    "batching": (False, (("max_slots", 2), ("max_seq_len", 32)),
                 (_spec(0, 1, 4, 6), _spec(1, 2, 7, 4), _spec(2, 3, 4, 5)), None, None),
    # tests/test_serving.py:73
    "queueing": (False, (("max_slots", 1), ("max_seq_len", 32)),
                 tuple(_spec(i, 10 + i, 4, 3) for i in range(3)), None, None),
    # tests/test_serving.py:84 (bf16/fp32 prefill + int8 decode in every case here)
    "int8_decode": (False, (("max_slots", 2), ("max_seq_len", 32)),
                    (_spec(0, 1, 4, 4), _spec(1, 2, 6, 4)), None, None),
    # tests/test_serving.py:289 (stepwise JAX vs pipelined port)
    "pipelined": (False, (("max_slots", 2), ("max_seq_len", 32), ("sync_every", 4)),
                  tuple(_spec(i, 10 + i, 3 + i % 4, 3 + i % 5) for i in range(6)), False, True),
    # tests/test_serving.py:343
    "budgets": (False, (("max_slots", 4), ("max_seq_len", 32), ("sync_every", 4)),
                tuple(_spec(i, 20 + i, 4, 2 + 3 * i) for i in range(4)), True, True),
    # tests/test_paged.py:281 (pool half the dense reservation)
    "paged": (True, (("max_slots", 2), ("max_seq_len", 32), ("page_size", 16)),
              (_spec(0, 1, 4, 6), _spec(1, 2, 7, 4), _spec(2, 3, 4, 5)), None, None),
    # tests/test_paged.py:305 (16 slots from a quarter of the dense reservation)
    "paged_slots": (True, (("max_slots", 16), ("max_seq_len", 32), ("page_size", 16),
                           ("n_pages", 9)),
                    tuple(_spec(i, 100 + i, 3 + i % 5, 4) for i in range(10)), None, None),
    # tests/test_paged.py:332 (pool too small: preemption and recompute)
    "preemption": (True, (("max_slots", 2), ("max_seq_len", 64), ("page_size", 16),
                          ("n_pages", 5), ("sync_every", 4)),
                   (_spec(0, 1, 4, 40), _spec(1, 2, 4, 40)), False, False),
    # tests/test_paged.py:819 (stepwise JAX vs pipelined port)
    "paged_pipelined": (True, (("max_slots", 2), ("max_seq_len", 32), ("page_size", 16),
                               ("sync_every", 4)),
                        tuple(_spec(i, 30 + i, 3 + i % 4, 3 + i % 5) for i in range(6)), False,
                        True),
    # request 0 (slot 0) has its budget capped so that it fills max_seq_len
    # exactly; its slot's write position then stays at the end of the cache
    # while row 1 runs on, and request 2 takes the slot afterwards
    "fill_dense": (False, (("max_slots", 2), ("max_seq_len", 32), ("sync_every", 4)),
                   (_spec(0, 40, 20, 30), _spec(1, 41, 2, 24), _spec(2, 42, 4, 6)), True, True),
    "fill_paged": (True, (("max_slots", 2), ("max_seq_len", 32), ("page_size", 16),
                          ("sync_every", 4)),
                   (_spec(0, 40, 20, 30), _spec(1, 41, 2, 24), _spec(2, 42, 4, 6)), True, True),
}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", ["batching", "queueing", "int8_decode", "pipelined",
                                  "budgets", "paged", "paged_slots", "preemption",
                                  "paged_pipelined", "fill_dense", "fill_paged"])
def test_engine_matches_jax_engine(case, path):
    want, want_preemptions = _jax_tokens(case)
    paged, kw, specs, _, pipeline = CASES[case]
    eng = _port_engine(paged, path, **dict(kw))
    # where JAX ran stepwise and the port pipelined, the tokens must not
    # depend on the schedule
    got = _serve(eng, specs, -1, pipeline, t_serving.Request)
    assert got == want
    for s in specs:
        # every budget met (capped at the cache's end), never overrun
        cap = dict(kw)["max_seq_len"] - CFG.vision_config.num_patches - s[2]
        assert len(got[s[0]]) == min(s[3], cap)
    if case.startswith("fill"):
        assert len(got[0]) < specs[0][3] and len(got[1]) > len(got[0])
    if case == "preemption":
        assert want_preemptions >= 1 and eng.preemptions == want_preemptions


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("pipeline", [False, True])
def test_eos_retires_slot_early(path, pipeline):
    """tests/test_serving.py:51 and :314: EOS mid-window ends the request at
    the EOS token (overshoot discarded), with JAX's tokens."""
    eos = _eos()
    specs = (_spec(0, 1, 4, 12), _spec(1, 2, 5, 6))
    kw = (("max_slots", 2), ("max_seq_len", 32), ("sync_every", 4))
    want = _jax_run(False, kw, specs, eos, pipeline)[0]
    got = _serve(_port_engine(False, path, **dict(kw)), specs, eos, pipeline, t_serving.Request)
    assert got == want
    assert got[0][-1] == eos and eos not in got[0][:-1] and len(got[0]) <= 3


@pytest.mark.parametrize("path", PATHS)
def test_cancel_pending_and_seated(path):
    """tests/test_serving.py:361: a queued request never runs; a seated one
    stops and frees its slot, keeping the tokens accepted before."""
    specs = (_spec(0, 1, 4, 8), _spec(1, 2, 5, 8), _spec(2, 3, 4, 5))
    results = []
    for make, cls in ((lambda: _jax_engine(False, max_slots=2, max_seq_len=32, sync_every=2),
                       j_serving.Request),
                      (lambda: _port_engine(False, path, max_slots=2, max_seq_len=32,
                                            sync_every=2), t_serving.Request)):
        eng = make()
        reqs = [_req(cls, s) for s in specs]
        for r in reqs:
            eng.submit(r)
        assert eng.cancel(2) and reqs[2].done and reqs[2].tokens == []
        eng.step()  # seats 0 and 1, decodes one window
        partial = len(reqs[0].tokens)
        assert eng.cancel(0) and reqs[0].done
        done = eng.run_to_completion()
        assert {r.request_id for r in done} == {1}
        assert len(reqs[1].tokens) == 8 and len(reqs[0].tokens) == partial
        assert not eng.cancel(0) and not eng.cancel(99)
        results.append([r.tokens for r in reqs])
    assert results[0] == results[1]


@pytest.mark.parametrize("path", PATHS)
def test_paged_greedy_rows_unchanged_by_sampled_windows(path):
    """tests/test_paged.py:636: windows switch between the greedy fast path
    and the sampled (logits) tick as sampling requests come and go; the
    greedy requests' tokens equal JAX's page-walk engine's (sampled rows
    draw from different generators and are not compared)."""
    specs = (_spec(0, 78, 3, 3, True), _spec(1, 79, 4, 8), _spec(2, 77, 5, 9),
             _spec(3, 80, 6, 4, True))
    kw = (("max_slots", 2), ("max_seq_len", 64), ("page_size", 16), ("sync_every", 1))
    want = _jax_run(True, kw, specs)[0]
    eng = _port_engine(True, path, paged_kernel="fused", **dict(kw))
    assert eng.paged_kernel == ("fused" if path == "kernel" else "xla")
    got = _serve(eng, specs, -1, None, t_serving.Request)
    for rid in (1, 2):
        assert got[rid] == want[rid]
    assert [len(got[s[0]]) for s in specs] == [s[3] for s in specs]


def test_paged_page_walk_kernels_match_fused():
    """Every paged_kernel value on the kernel path gives the same tokens
    ("staged" is "fused" here; the page-walk names share one kernel)."""
    specs = (_spec(0, 1, 4, 6), _spec(1, 2, 7, 4), _spec(2, 3, 4, 5))
    kw = dict(max_slots=2, max_seq_len=32, page_size=16)
    want = _jax_tokens("paged")[0]
    for kernel in ("staged", "one", "multi", "batched", "runs", "xla"):
        eng = _port_engine(True, "kernel", paged_kernel=kernel, **kw)
        assert eng.paged_kernel == ("fused" if kernel == "staged" else kernel)
        assert _serve(eng, specs, -1, None, t_serving.Request) == want


def test_kernel_path_raises_on_unsupported_tree():
    """The kernel path is decided once: a tree or config the kernels cannot
    take raises (GQA config, or the dense decode tree), never falls back."""
    cfg = tiny_test_config()
    tp = params_from_numpy(jax.tree.map(np.asarray, j_pg.init_params(jax.random.PRNGKey(0), cfg)),
                           "cpu")
    with pytest.raises(ValueError, match="fused_decode"):
        t_serving.ServingEngine(tp, cfg, max_slots=2, max_seq_len=32, fused_decode=True)
    with pytest.raises(ValueError, match="paged_kernel='fused'"):
        t_paged.PagedServingEngine(tp, cfg, max_slots=2, max_seq_len=32, page_size=16,
                                   fused_decode=True)
    from paligemma_tpu_torch.core.mesh import Mesh

    with pytest.raises(ValueError, match="pure TP"):  # the paged engine takes a data axis
        t_serving.ServingEngine(tp, cfg, max_slots=2, max_seq_len=32, spec_decode=True,
                                mesh=Mesh(data=2))
    eng = t_serving.ServingEngine(tp, cfg, max_slots=1, max_seq_len=16)
    with pytest.raises(ValueError, match="exceeds the per-slot budget"):
        eng.submit(_req(t_serving.Request, _spec(0, 1, 20, 2)))
    assert not eng.has_work


def test_request_metrics_stamped():
    eng = _port_engine(False, "plain", max_slots=1, max_seq_len=32, sync_every=2)
    r = _req(t_serving.Request, _spec(0, 1, 4, 5))
    eng.submit(r)
    eng.run_to_completion()
    m = r.metrics()
    assert set(m) == {"queue_ms", "ttft_ms", "total_ms", "decode_tokens_per_sec"}
    assert 0 <= m["queue_ms"] <= m["ttft_ms"] <= m["total_ms"]


def test_sample_top_p_per_row_matches_jax():
    """Per-row temperature and top-p (the serving tick's vmap) on shared
    Gumbel draws: the same tokens as JAX's per-row sample_top_p."""
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(4, 64)).astype(np.float32) * 3
    temps = np.array([0.5, 0.8, 1.0, 1.3], np.float32)
    top_ps = np.array([0.3, 0.9, 0.6, 1.0], np.float32)
    u = rng.random((4, 64)).astype(np.float32)
    noise = -np.log(-np.log(u))
    got = t_sampling.sample_top_p(None, torch.from_numpy(logits), torch.from_numpy(temps),
                                  torch.from_numpy(top_ps), noise=torch.from_numpy(noise))
    for r in range(4):
        probs = jax.nn.softmax(jnp.asarray(logits[r]) / temps[r])
        order = jnp.argsort(-probs)
        kept = j_sampling.top_p_mask_probs(probs[order][None], float(top_ps[r]))[0]
        kept = kept / kept.sum()
        logk = jnp.where(kept > 0, jnp.log(jnp.where(kept > 0, kept, 1e-38)), -jnp.inf)
        want = int(order[int(jnp.argmax(logk + noise[r]))])
        assert int(got[r]) == want
        one = t_sampling.sample_top_p(None, torch.from_numpy(logits[r:r + 1]), float(temps[r]),
                                      float(top_ps[r]), noise=torch.from_numpy(noise[r:r + 1]))
        assert int(one[0]) == want
