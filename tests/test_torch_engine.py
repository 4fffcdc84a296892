"""The port's PaliGemmaEngine end to end against the JAX engine (CPU, fp32,
seeded numpy inputs): the same greedy tokens at sync_every 1 and 4, on the
plain path and on the int8 kernel path (whose wrappers run their plain
versions on the CPU)."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core.config import (GemmaConfig, PaliGemmaConfig,
                                       tiny_test_config)
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.runtime.engine import PaliGemmaEngine as JaxEngine
from paligemma_tpu.runtime.quantize import quantize_lm_for_serving as j_qserve
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mqa_config():
    """tiny vision tower + the MQA / head_dim-128 decoder the fused decode
    path supports (one KV head, head_dim/2 a power of two)."""
    tiny = tiny_test_config()
    return PaliGemmaConfig(
        vision_config=tiny.vision_config,
        text_config=GemmaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=1, head_dim=128),
        projection_dim=128, hidden_size=128, image_token_index=510, vocab_size=512,
    )


def _inputs(cfg, b=2, n_txt=5, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full((b, cfg.vision_config.num_patches), cfg.image_token_index),
                          rng.integers(3, 100, (b, n_txt))], 1).astype(np.int32)
    pixels = rng.normal(size=(b, 3, 28, 28)).astype(np.float32)
    return pixels, ids, np.ones_like(ids)


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("sync_every", [1, 4])
def test_generate_plain_matches_jax_engine(sync_every):
    cfg = tiny_test_config()
    jp = j_pg.init_params(jax.random.PRNGKey(0), cfg)
    pixels, ids, mask = _inputs(cfg)
    want = JaxEngine(jp, cfg, max_seq_len=48, use_flash=False).generate(
        jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=10,
        eos_token_id=-1)
    eng = PaliGemmaEngine(_to_port(jp), cfg, max_seq_len=48)
    assert not eng.use_flash and not eng.fused_layer  # CPU defaults
    got = eng.generate(pixels, ids, mask, max_new_tokens=10, eos_token_id=-1,
                       sync_every=sync_every)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("sync_every", [1, 4])
def test_generate_int8_kernel_path_matches_jax_engine(sync_every):
    """decode on the int8 tree through layers_decode_fused + the GEMV head
    (sync_every=1) or the argmax head (sync_every=4), against the JAX engine's
    XLA int8 decode on the same int8 tree."""
    cfg = _mqa_config()
    jp = j_pg.init_params(jax.random.PRNGKey(1), cfg)
    jq = j_qserve(jp)
    pixels, ids, mask = _inputs(cfg, seed=1)
    want = JaxEngine(jp, cfg, max_seq_len=64, use_flash=False, decode_params=jq,
                     fused_layer=False).generate(
        jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=8,
        eos_token_id=-1)
    eng = PaliGemmaEngine(_to_port(jp), cfg, max_seq_len=64, decode_params=_to_port(jq),
                          use_flash=True, fused_layer=True)
    assert eng.fused_layer and eng._greedy_head_fused
    got = eng.generate(pixels, ids, mask, max_new_tokens=8, eos_token_id=-1,
                       sync_every=sync_every)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_generate_fused_mlp_matches_jax_engine(monkeypatch):
    """fused_mlp=True with fused_layer=False: plain layers, each layer's
    decode MLP through kernels/decode_mlp (B7b; its plain version on the
    CPU), against the JAX engine's fused_mlp path (the Pallas MLP kernel in
    interpret mode) on the same int8 tree: the same greedy tokens."""
    from paligemma_tpu_torch.models import gemma as t_gemma

    cfg = _mqa_config()
    jp = j_pg.init_params(jax.random.PRNGKey(3), cfg)
    jq = j_qserve(jp)
    pixels, ids, mask = _inputs(cfg, seed=3)
    jeng = JaxEngine(jp, cfg, max_seq_len=64, use_flash=False, decode_params=jq,
                     fused_layer=False, fused_mlp=True)
    assert jeng.fused_mlp and "gate_blk" in jeng.decode_params["lm"]["layers"]["mlp"]
    want = jeng.generate(jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask),
                         max_new_tokens=6, eos_token_id=-1)
    calls = []
    mlp = t_gemma.mlp_decode_fused
    monkeypatch.setattr(t_gemma, "mlp_decode_fused",
                        lambda y, *a, **kw: calls.append(y.shape) or mlp(y, *a, **kw))
    eng = PaliGemmaEngine(_to_port(jp), cfg, max_seq_len=64, decode_params=_to_port(jq),
                          use_flash=False, fused_layer=False, fused_mlp=True)
    assert eng.fused_mlp and not eng.fused_layer
    got = eng.generate(pixels, ids, mask, max_new_tokens=6, eos_token_id=-1)
    assert len(calls) == 6 * cfg.text_config.num_hidden_layers  # every layer of every step
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("case", ["gqa_config", "dense_decode_tree"])
def test_fused_layer_on_unsupported_tree_raises(case):
    """An explicit fused_layer=True the kernels cannot take raises; the
    engine never clears it and decodes on the plain path instead."""
    cfg = tiny_test_config() if case == "gqa_config" else _mqa_config()
    params = _to_port(j_pg.init_params(jax.random.PRNGKey(0), cfg))
    decode = _to_port(j_qserve(j_pg.init_params(jax.random.PRNGKey(0), cfg)))
    with pytest.raises(ValueError, match="fused_layer"):
        PaliGemmaEngine(params, cfg, max_seq_len=48, fused_layer=True,
                        decode_params=decode if case == "gqa_config" else None)


def test_fused_layer_batch_above_32_takes_kernel_chain(monkeypatch):
    """B=33 lockstep rows decode through layers_decode_fused (the port's
    kernels have no 32-row cap) with the plain path's greedy tokens."""
    from paligemma_tpu_torch.kernels import decode_layer as t_layer

    cfg = _mqa_config()
    jp = j_pg.init_params(jax.random.PRNGKey(2), cfg)
    params, decode = _to_port(jp), _to_port(j_qserve(jp))
    pixels, ids, mask = _inputs(cfg, b=33, n_txt=3, seed=2)
    want = PaliGemmaEngine(params, cfg, max_seq_len=32, decode_params=decode,
                           fused_layer=False).generate(pixels, ids, mask, max_new_tokens=3,
                                                       eos_token_id=-1)
    calls = []
    chain = t_layer.layers_decode_fused
    monkeypatch.setattr(t_layer, "layers_decode_fused",
                        lambda x, *a, **kw: calls.append(x.shape[0]) or chain(x, *a, **kw))
    got = PaliGemmaEngine(params, cfg, max_seq_len=32, decode_params=decode,
                          fused_layer=True).generate(pixels, ids, mask, max_new_tokens=3,
                                                     eos_token_id=-1)
    assert calls and set(calls) == {33}  # every decode step
    np.testing.assert_array_equal(got, want)


def test_generate_eos_and_streaming():
    cfg = tiny_test_config()
    eng = PaliGemmaEngine(_to_port(j_pg.init_params(jax.random.PRNGKey(0), cfg)), cfg,
                          max_seq_len=48)
    pixels, ids, mask = _inputs(cfg, b=1)
    probe = eng.generate(pixels, ids, mask, max_new_tokens=3, eos_token_id=-1)
    eos = int(probe[0, 2])
    k = int(np.argmax(probe[0] == eos))
    seen = []
    per_token = eng.generate(pixels, ids, mask, max_new_tokens=9, eos_token_id=eos,
                             on_token=lambda i, t: seen.append(i))
    chunked = eng.generate(pixels, ids, mask, max_new_tokens=9, eos_token_id=eos,
                           sync_every=4)
    assert per_token.shape[1] == k + 1 and per_token[0, k] == eos
    assert seen == list(range(k + 1))
    np.testing.assert_array_equal(chunked[:, : k + 1], per_token)
    assert (chunked[:, k:] == eos).all()
    with pytest.raises(ValueError):
        eng.generate(pixels, ids, mask, max_new_tokens=100)


def test_sampled_generate_same_draws_at_any_sync():
    cfg = tiny_test_config()
    eng = PaliGemmaEngine(_to_port(j_pg.init_params(jax.random.PRNGKey(0), cfg)), cfg,
                          max_seq_len=48)
    pixels, ids, mask = _inputs(cfg)
    runs = [eng.generate(pixels, ids, mask, max_new_tokens=6, do_sample=True,
                         eos_token_id=-1, sync_every=s,
                         generator=torch.Generator().manual_seed(7)) for s in (1, 3)]
    np.testing.assert_array_equal(runs[0], runs[1])


def test_port_runs_without_jax():
    """A fresh interpreter imports the port (the serving, training, LoRA,
    ablation, processing, checkpoint and CLI modules included), runs a tiny
    CPU generate, a single-copy W8A8 generate, a tiny paged serving run, one
    with a multi-LoRA bank, a training step, the tower with attn="fused",
    the ablation entry points,
    the device preprocessing, the mask decoder, an HF export -> load round
    trip, a batch run of cli.serve on the export and one epoch of
    cli.finetune on it (with an evaluation and --export_hf), and never
    imports jax or any module of the JAX package."""
    code = textwrap.dedent("""
        import dataclasses
        import os
        import sys
        import tempfile
        import numpy as np
        import torch
        import paligemma_tpu_torch
        import json
        from chip_smoke import _StandIns
        from paligemma_tpu_torch.cli import finetune, infer, ranks, serve
        from paligemma_tpu_torch.core.mesh import Mesh, shard_lora
        from paligemma_tpu_torch.processing import mask_vae
        from paligemma_tpu_torch.runtime.logging import MetricsLogger
        from paligemma_tpu_torch.train import data, hf_dataset
        from paligemma_tpu_torch.checkpoints.hf_export import export_hf_checkpoint
        from paligemma_tpu_torch.checkpoints.hf_loader import load_hf_model
        from paligemma_tpu_torch.processing.images import preprocess_device
        from paligemma_tpu_torch.processing.processor import PaliGemmaProcessor
        from paligemma_tpu_torch.convert import init_params, init_vision_params
        from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
        from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving
        from paligemma_tpu_torch.runtime.serving import Request, ServingEngine
        from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine
        from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer
        from paligemma_tpu_torch.train.lora import init_lora, stack_lora_bank
        from paligemma_tpu_torch.kernels import lora as kernels_lora
        from paligemma_tpu_torch.kernels.ablation import (
            decode_attention, quant4, quant_pallas, vision_attention)
        from paligemma_tpu_torch.models import siglip
        torch.set_num_threads(1)
        cfg = paligemma_tpu_torch.tiny_test_config()
        # the TP launcher's pieces and a rank's shard of a bank
        assert ranks.backend_for([torch.device("cpu")] * 2) == "gloo"
        bank = stack_lora_bank([init_lora(torch.Generator(), cfg.text_config, rank=2)])
        half = shard_lora(bank, Mesh(model=2, rank=1))["layers"]
        assert half["o"]["a_cat"].shape[-2] * 2 == bank["layers"]["o"]["a_cat"].shape[-2]
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
        eng = PaliGemmaEngine(params, cfg, max_seq_len=32,
                              decode_params=quantize_lm_for_serving(params))
        n = cfg.vision_config.num_patches
        ids = np.array([[cfg.image_token_index] * n + [5, 6]], np.int32)
        out = eng.generate(np.zeros((1, 3, 28, 28), np.float32), ids, np.ones_like(ids),
                           max_new_tokens=3, eos_token_id=-1)
        assert out.shape == (1, 3), out.shape
        # single-copy serving: the int8 tree alone, a W8A8 prefill of 256 rows
        from paligemma_tpu_torch.kernels import w8a8
        q = quantize_lm_for_serving(params)
        one = PaliGemmaEngine(q, cfg, max_seq_len=300, decode_params=q, int8_act_prefill=True)
        long_ids = np.array([[cfg.image_token_index] * n + [5] * (256 - n)], np.int32)
        out8 = one.generate(np.zeros((1, 3, 28, 28), np.float32), long_ids,
                            np.ones_like(long_ids), max_new_tokens=2, eos_token_id=-1)
        assert out8.shape == (1, 2) and w8a8.w8a8_gemm.launches == 0
        # speculative decoding: the proposer, generate_spec, both engines
        from paligemma_tpu_torch.ops.ngram import propose_ngram
        assert propose_ngram(torch.tensor([[1, 2, 1, 2]]), torch.tensor([4]), 1, 2).shape == (1, 2)
        spec = eng.generate_spec(np.zeros((1, 3, 28, 28), np.float32), ids, np.ones_like(ids),
                                 max_new_tokens=3, eos_token_id=-1, draft_k=2)
        assert spec.tolist() == out.tolist(), (spec, out)
        for cls, kw in ((ServingEngine, {}), (PagedServingEngine, {"page_size": 16})):
            srv = cls(params, cfg, max_slots=2, max_seq_len=32, spec_decode=True, spec_draft_k=2,
                      **kw)
            srv.submit(Request(request_id=0, input_ids=ids[0], max_new_tokens=3,
                               pixel_values=np.zeros((3, 28, 28), np.float32), eos_token_id=-1))
            assert [len(r.tokens) for r in srv.run_to_completion()] == [3]
        paged = PagedServingEngine(params, cfg, max_slots=2, max_seq_len=32, page_size=16)
        for i in range(3):
            paged.submit(Request(request_id=i, input_ids=ids[0], max_new_tokens=3,
                                 pixel_values=np.zeros((3, 28, 28), np.float32),
                                 eos_token_id=-1))
        done = paged.run_to_completion()
        assert sorted(len(r.tokens) for r in done) == [3, 3, 3]
        bank = {"x": init_lora(torch.Generator().manual_seed(3), cfg.text_config, rank=2)}
        assert stack_lora_bank(list(bank.values()))["layers"]["q"]["a"].shape[1] == 2
        paged = PagedServingEngine(params, cfg, max_slots=2, max_seq_len=32, page_size=16,
                                   lora_bank=bank)
        for i, name in enumerate((None, "x")):
            paged.submit(Request(request_id=i, input_ids=ids[0], max_new_tokens=2, lora=name,
                                 pixel_values=np.zeros((3, 28, 28), np.float32),
                                 eos_token_id=-1))
        assert [len(r.tokens) for r in paged.run_to_completion()] == [2, 2]
        assert kernels_lora.lora_shrink.launches == 0
        tr = Trainer(params, cfg, TrainConfig(lora_rank=2, use_flash=True))
        loss = tr.train_step({"pixel_values": np.zeros((1, 3, 28, 28), np.float32),
                              "input_ids": ids, "attention_mask": np.ones_like(ids),
                              "token_type_ids": (np.arange(ids.shape[1]) >= n)[None].astype(np.int32),
                              "labels": ids})
        assert np.isfinite(loss), loss
        vcfg = dataclasses.replace(cfg.vision_config, image_size=32, patch_size=2)
        vp = init_vision_params(vcfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
        feats = siglip.encode(vp, vcfg, torch.zeros(1, 3, 32, 32), attn="fused")
        assert feats.shape == (1, 256, vcfg.hidden_size), feats.shape
        x = torch.randn(2, 128)
        q4 = quant4.quantize_int4(torch.randn(128, 32))
        assert quant4.int4_matmul(x, q4["w4p"], q4["s"]).shape == (2, 32)
        q8 = quant_pallas.quantize_int8_nmajor(torch.randn(128, 32))
        assert quant_pallas.int8_matmul_nmajor(x, q8["w8t"], q8["s"]).shape == (2, 32)
        n = torch.tensor([5, 9])
        out = decode_attention.decode_attention(torch.randn(2, 4, 16), torch.randn(2, 12, 2, 16),
                                                torch.randn(2, 12, 2, 16), n, n, n)
        assert out.shape == (2, 4, 16)
        assert vision_attention.vision_attention.launches == 0
        px = preprocess_device(np.zeros((1, 40, 30, 3), np.uint8), 28, device="cpu")
        assert px.shape == (1, 3, 28, 28), px.shape
        with tempfile.TemporaryDirectory() as d:
            export_hf_checkpoint(cfg, params, d)
            again, cfg2 = load_hf_model(d, torch.float32, device="cpu")
            # a batch run of the serving CLI, with chip_smoke's stand-ins
            # for PIL.Image.open and transformers.AutoTokenizer (whose ids
            # pass 1156: the processor adds 1153 tokens)
            scfg = paligemma_tpu_torch.tiny_test_config(2048)
            export_hf_checkpoint(scfg, init_params(scfg, torch.Generator().manual_seed(2),
                                                   "cpu", torch.float32), d)
            np.save(d + "/img.npy", np.zeros((40, 30, 3), np.uint8))
            with open(d + "/reqs.jsonl", "w") as fh:
                for p in ("caption en", "caption en", "describe"):
                    fh.write(json.dumps({"prompt": p, "image": d + "/img.npy",
                                         "max_new_tokens": 3}) + "\\n")
            with open(d + "/train.jsonl", "w") as fh:
                for t in ({"total": "7"}, "seven words"):
                    fh.write(json.dumps({"image": d + "/img.npy", "prompt": "extract",
                                         "target": t}) + "\\n")
            with _StandIns(scfg.image_token_index):
                serve.main(["--model_path", d, "--requests_jsonl", d + "/reqs.jsonl",
                            "--only_cpu", "--dtype", "float32", "--max_slots", "2",
                            "--max_seq_len", "64", "--quantize_int8", "--prefix_cache"])
                finetune.main(["--model_path", d, "--train_jsonl", d + "/train.jsonl",
                               "--eval_jsonl", d + "/train.jsonl", "--eval_every", "1",
                               "--max_new_tokens_eval", "2", "--output_dir", d + "/ft",
                               "--epochs", "1", "--grad_accum", "1", "--lora_rank", "2",
                               "--max_length", "64", "--export_hf", "--only_cpu"])
            ft = [json.loads(x) for x in open(d + "/ft/metrics.jsonl")]
            assert [sorted(r) for r in ft] == [
                ["epoch", "step", "step_ms", "time", "tokens_per_sec", "train_loss"],
                ["step", "time", "val_edit_distance"]], ft
            assert sorted(os.listdir(d + "/ft")) == ["epoch_0", "final", "hf_export",
                                                     "metrics.jsonl"]
            masks = mask_vae.reconstruct_masks(mask_vae.init_params(torch.Generator(), 16),
                                               np.zeros((1, 16), np.int32))
            assert masks.shape == (1, 64, 64)
        assert cfg2 == cfg and torch.equal(again["lm"]["embed"], params["lm"]["embed"])
        assert "jax" not in sys.modules
        foreign = [m for m in sys.modules if m.split(".")[0] == "paligemma_tpu"]
        assert not foreign, foreign
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert res.stdout.count('"request_id"') == 3, res.stdout  # the serving CLI's lines
