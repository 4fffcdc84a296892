"""The port's fine-tuning CLI (``python -m paligemma_tpu_torch.cli.finetune``)
against the JAX package's, on a fabricated tiny HF checkpoint directory
(CPU):

* the same manifest and initial adapters (the port's ``init_lora`` patched
  to return JAX's ``PRNGKey(0)`` draw) through both CLIs, with evaluation,
  early stopping and ``--export_hf``: per-step ``train_loss`` within 1e-2
  (both train bf16 weights, rounded at other places), the same
  ``val_edit_distance`` values and early-stopping step, and the exported
  tensors equal to JAX's (the adapted projections within 1e-2);
* the export is read by both packages' ``cli.infer``, and ``cli.serve
  --lora NAME=<out>/final`` serves the run's adapters;
* the batches (order per epoch and seed, the tail row copied with its
  labels at -100, ``--shuffle_seed -1``, ``--hf_dataset``) equal JAX's,
  array for array;
* ``--resume_from`` continues the optimizer state; QLoRA (``--base_quant
  nf4``) and ``--full_finetune`` runs;
* the mesh flags (``--data_parallel``, ``--model_parallel``, ``--fsdp``,
  ``--multihost`` with torchrun's environment or ``--coordinator``) on
  gloo ranks against the one-card run;
* an orbax ``--resume_from``, no card without ``--only_cpu``, a
  ``--model_parallel`` the heads do not divide, and user mistakes exit 2
  with a one-line reason.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from paligemma_tpu_torch.cli import finetune as t_ft
from paligemma_tpu_torch.convert import params_from_numpy
from test_torch_cli import mqa_checkpoint_dir  # noqa: F401 (one KV head: TP can shard it)

torch.set_num_threads(2)

VOCAB = 288
LOSS_TOL = 1e-2  # absolute, on losses ~5.4: bf16 weights and activations on both sides
# absolute, on merged weights ~0.08: where rounding flips an Adam update's
# sign, the adapters part by up to 2 lr a step (measured 4.6e-3 after 6 steps)
EXPORT_TOL = 1e-2


# ---- fixture copied from tests/test_cli.py ----
@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")

    # ---- tiny HF PaliGemma with real safetensors ----
    cfg = transformers.PaliGemmaConfig(
        vision_config=dict(
            image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, projection_dim=48,
            vision_use_head=False,
        ),
        text_config=dict(
            vocab_size=VOCAB, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, model_type="gemma",
            bos_token_id=2, eos_token_id=1, pad_token_id=0,
        ),
        projection_dim=48, image_token_index=280, pad_token_id=0,
        vocab_size=VOCAB,
    )
    torch.manual_seed(0)
    model = transformers.PaliGemmaForConditionalGeneration(cfg).eval()
    model.save_pretrained(str(d), safe_serialization=True)

    # ---- tiny fast tokenizer (word-level) ----
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["this", "building", "is", "a", "answer", "in", "english", "hello",
             "world", "describe", "the", "image", "extract", "json"]
    vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "\n": 3, "<unk>": 4}
    for w in words:
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok,
        pad_token="<pad>", eos_token="<eos>", bos_token="<bos>", unk_token="<unk>",
    )
    fast.save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    from PIL import Image

    p = tmp_path_factory.mktemp("img") / "pic1.png"
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(p)
    return str(p)


@pytest.fixture(scope="module")
def hf_dataset_dir(tmp_path_factory, image_path):
    """Tiny CORD-shaped HF dataset (image + ground_truth JSON), saved to
    disk — the offline stand-in for naver-clova-ix/cord-v2
    (ref: Paligemma_FT.ipynb cell 20)."""
    datasets = pytest.importorskip("datasets")
    from PIL import Image as PILImage

    img = PILImage.open(image_path)
    rows = {
        "image": [img] * 4,
        "ground_truth": [
            json.dumps({"gt_parse": {"total": str(10 + i), "menu": [
                {"nm": "building", "price": str(i)}]}})
            for i in range(4)
        ],
    }
    ds = datasets.Dataset.from_dict(rows).cast_column(
        "image", datasets.Image()
    )
    d = tmp_path_factory.mktemp("hfds")
    ds.save_to_disk(str(d / "cord_tiny"))
    return str(d / "cord_tiny")
# ---- end of the copied fixtures ----


WORDS = ["this", "building", "is", "a", "answer", "in", "english", "hello", "world"]


@pytest.fixture(scope="module")
def data(tmp_path_factory, image_path):
    """5 training rows (frames of two sizes; JSON and string targets of
    in-vocabulary words) and 2 eval rows."""
    from PIL import Image

    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(1)
    second = str(d / "pic2.png")
    Image.fromarray(rng.integers(0, 255, (30, 50, 3), dtype=np.uint8)).save(second)
    rows = []
    for i in range(5):
        words = [WORDS[j] for j in rng.integers(0, len(WORDS), 2 + i)]
        target = ({"total": words[0], "menu": [{"nm": w} for w in words[1:]]} if i % 2
                  else " ".join(words))
        rows.append({"image": (image_path, second)[i % 2], "prompt": "extract json",
                     "target": target})
    train, ev = d / "train.jsonl", d / "eval.jsonl"
    train.write_text("\n".join(json.dumps(r) for r in rows))
    ev.write_text("\n".join(json.dumps(r) for r in rows[:2]))
    return str(train), str(ev)


def _argv(checkpoint_dir, out, train, *extra):
    return ["--model_path", checkpoint_dir, "--train_jsonl", train, "--output_dir", str(out),
            "--batch_size", "2", "--grad_accum", "1", "--lora_rank", "2", "--warmup_steps", "0",
            "--max_length", "64", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jax_lora(generator, cfg, rank=8, alpha=8.0, *args, **kw):
    """JAX's Trainer's initial adapters (init_lora at PRNGKey(0)), as the
    port's tensors: JAX's init_lora reads only the config's widths."""
    from paligemma_tpu.train.lora import init_lora

    tree = init_lora(jax.random.PRNGKey(0), cfg, rank, alpha)
    return params_from_numpy(jax.tree.map(np.asarray, tree), generator.device)


# lr 1e-3: at bf16 a larger step lets Adam turn rounding-level gradient
# differences into O(lr) parameter differences (at 5e-2 the losses part by
# 0.14 within 4 steps); eval every 3 steps with patience 1
MAIN_FLAGS = ("--epochs", "3", "--learning_rate", "1e-3", "--eval_every", "3",
              "--eval_subset", "2", "--max_new_tokens_eval", "4",
              "--early_stopping_patience", "1", "--export_hf")


@pytest.fixture(scope="module")
def runs(checkpoint_dir, data, tmp_path_factory):
    """One JAX run and one port run of MAIN_FLAGS from the same adapters."""
    from paligemma_tpu.cli.finetune import main as jax_main
    from paligemma_tpu_torch.train import lora as t_lora

    train, ev = data
    base = tmp_path_factory.mktemp("runs")
    jax_out, port_out = base / "jax", base / "port"
    jax_main(_argv(checkpoint_dir, jax_out, train, "--eval_jsonl", ev, *MAIN_FLAGS))
    mp = pytest.MonkeyPatch()
    mp.setattr(t_lora, "init_lora", _jax_lora)
    try:
        t_ft.main(_argv(checkpoint_dir, port_out, train, "--eval_jsonl", ev, *MAIN_FLAGS,
                        "--only_cpu"))
    finally:
        mp.undo()
    return str(jax_out), str(port_out)


def test_losses_and_evals_follow_jax(runs):
    jax_out, port_out = runs
    want, got = _metrics(jax_out), _metrics(port_out)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    losses = [(g["train_loss"], w["train_loss"]) for g, w in zip(got, want) if "train_loss" in w]
    assert len(losses) >= 4
    np.testing.assert_allclose(*zip(*losses), atol=LOSS_TOL, rtol=0)
    assert losses[-1][0] < losses[0][0]  # it trains
    evals = [(g["val_edit_distance"], w["val_edit_distance"])
             for g, w in zip(got, want) if "val_edit_distance" in w]
    assert len(evals) >= 2
    assert [g for g, _ in evals] == [w for _, w in evals]
    for r in got:
        assert r.get("epoch", 0) in range(3) and r.get("step_ms", 1) > 0


def test_early_stopping_and_outputs_follow_jax(runs):
    jax_out, port_out = runs
    for out in runs:
        names = sorted(os.listdir(out))
        assert "final" in names and "hf_export" in names and "metrics.jsonl" in names
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out))
    assert os.path.isfile(os.path.join(port_out, "final", "state.pt"))
    want = sorted(os.listdir(os.path.join(jax_out, "hf_export")))
    assert sorted(os.listdir(os.path.join(port_out, "hf_export"))) == want
    last = [_metrics(o)[-1]["step"] for o in runs]
    assert last[0] == last[1] < 9  # stopped before 3 epochs of 3 steps, at the same step


def test_export_follows_jax_and_reads_back(runs):
    """The exported (merged, fp32) tensors: the LM projections the adapters
    land on within EXPORT_TOL of JAX's, every other tensor bit for bit; the
    export loads in both packages' loaders."""
    import jax.numpy as jnp

    from paligemma_tpu.checkpoints.hf_loader import load_hf_model as j_load
    from paligemma_tpu_torch.checkpoints.hf_loader import load_hf_model as t_load
    from paligemma_tpu_torch.checkpoints.safetensors import load_file

    jax_out, port_out = runs
    want = load_file(os.path.join(jax_out, "hf_export", "model.safetensors"))
    got = load_file(os.path.join(port_out, "hf_export", "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = want[k], got[k]
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, k
        adapted = k.startswith("language_model.") and (".self_attn." in k or ".mlp." in k)
        torch.testing.assert_close(g, w, atol=EXPORT_TOL if adapted else 0, rtol=0, msg=k)
    tp, tcfg = t_load(os.path.join(port_out, "hf_export"), torch.float32, device="cpu")
    jp, jcfg = j_load(os.path.join(port_out, "hf_export"), jnp.float32)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(np.asarray(jp["lm"]["embed"]), tp["lm"]["embed"].numpy())


def test_both_infer_clis_read_the_export(runs, image_path, capsys):
    from paligemma_tpu.cli.infer import main as jax_infer
    from paligemma_tpu_torch.cli import infer as t_infer

    exp = os.path.join(runs[1], "hf_export")
    argv = ["--model_path", exp, "--prompt", "describe the image", "--image_file_path",
            image_path, "--max_tokens_to_generate", "4", "--dtype", "float32"]
    jax_infer(argv)
    want = capsys.readouterr().out.split("Running inference\n", 1)[1]
    t_infer.main(argv + ["--only_cpu"])
    got = capsys.readouterr().out.split("Running inference\n", 1)[1]
    assert got == want and got.startswith("describe the image")
    res = t_infer.run(t_infer.parse_args(argv + ["--only_cpu", "--quantize_int8"]))
    assert res.tokens.shape == (1, 4)


def test_serve_lora_serves_the_final_adapters(runs, checkpoint_dir, image_path, tmp_path,
                                              capsys):
    """``cli.serve --lora tuned=<out>/final`` over the base checkpoint
    serves a request under the run's adapters beside one on the base."""
    from paligemma_tpu_torch.checkpoints.local import restore_pytree
    from paligemma_tpu_torch.cli import serve

    final = os.path.join(runs[1], "final")
    assert set(restore_pytree(final)) == {"lora", "opt_state"}
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps({"prompt": "describe the image", "image": image_path,
                                          "max_new_tokens": 4, "request_id": i, **extra})
                              for i, extra in enumerate(({"lora": "tuned"}, {}))))
    serve.main(["--model_path", checkpoint_dir, "--requests_jsonl", str(reqs), "--only_cpu",
                "--dtype", "float32", "--max_slots", "2", "--max_seq_len", "64",
                "--lora", f"tuned={final}"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert sorted(r["request_id"] for r in lines) == [0, 1]
    assert all(r["num_tokens"] == 4 for r in lines)


def test_evaluation_takes_the_plain_decode(checkpoint_dir, data, tmp_path, monkeypatch):
    """The evaluation engine is built with ``fused_layer=False``: on the
    card the default would take the decode kernels, which refuse the merged
    bf16 tree (they raise, as shown here with the flag set), where JAX's
    engine turns its fused layer off by itself."""
    from paligemma_tpu_torch.runtime import engine as t_engine

    made, real = [], t_engine.PaliGemmaEngine

    class Recording(real):
        def __init__(self, params, config, *args, **kw):
            made.append(kw)
            if made[0].get("fused_layer") is not False:
                raise AssertionError("the evaluation engine left fused_layer to the default")
            with pytest.raises(ValueError, match="fused_layer"):
                real(params, config, *args, **{**kw, "fused_layer": True})
            super().__init__(params, config, *args, **kw)

    monkeypatch.setattr(t_engine, "PaliGemmaEngine", Recording)
    t_ft.main(_argv(checkpoint_dir, tmp_path / "out", data[0], "--epochs", "1",
                    "--eval_jsonl", data[1], "--eval_every", "3", "--max_new_tokens_eval", "2",
                    "--only_cpu"))
    assert len(made) == 1 and made[0]["fused_layer"] is False


class _RecordingTrainer:
    """Stands in for either package's Trainer: records the batches it is
    given and trains nothing."""

    batches = []

    def __init__(self, params, config, train_config, mesh=None, *args, **kw):
        pass

    def train_step(self, batch):
        type(self).batches.append({k: np.array(v) for k, v in batch.items()})
        return 0.0

    def save(self, path):
        os.makedirs(path, exist_ok=True)


@pytest.mark.parametrize("source", ["seed0", "seed-1", "hf_dataset"])
def test_batches_follow_jax(checkpoint_dir, data, hf_dataset_dir, tmp_path, monkeypatch,
                            source):
    """5 rows at batch size 2 over 2 epochs: the per-epoch order, the tail
    batch (its copy of the first row has every label at -100), and no
    shuffle at --shuffle_seed -1; and the rows of an HF dataset."""
    from paligemma_tpu.cli.finetune import main as jax_main
    from paligemma_tpu.train import trainer as j_trainer
    from paligemma_tpu_torch.train import trainer as t_trainer

    monkeypatch.setattr(j_trainer, "Trainer", _RecordingTrainer)
    monkeypatch.setattr(t_trainer, "Trainer", _RecordingTrainer)
    if source == "hf_dataset":
        src = ["--hf_dataset", hf_dataset_dir]
    else:
        src = ["--train_jsonl", data[0], "--shuffle_seed", source[4:]]
    flags = ["--model_path", checkpoint_dir, *src, "--batch_size", "2", "--epochs", "2",
             "--max_length", "64"]
    got = []
    for main, tag in ((jax_main, "jax"), (t_ft.main, "port")):
        _RecordingTrainer.batches = []
        main(flags + ["--output_dir", str(tmp_path / tag)]
             + (["--only_cpu"] if tag == "port" else []))
        got.append(_RecordingTrainer.batches)
    want, mine = got
    assert len(mine) == len(want) == (4 if source == "hf_dataset" else 6)
    for b_w, b_t in zip(want, mine):
        assert sorted(b_t) == sorted(b_w)
        for k in b_w:
            np.testing.assert_array_equal(b_t[k], b_w[k], err_msg=k)
    if source != "hf_dataset":
        tails = [mine[2], mine[5]]
        for t in tails:
            assert (t["labels"][1] == -100).all() and (t["labels"][0] >= 0).any()
            np.testing.assert_array_equal(t["input_ids"][1], t["input_ids"][0])
        first = [b["input_ids"][0] for b in (mine[0], mine[3])]
        assert (not np.array_equal(*first)) == (source == "seed0")


def test_resume_continues_the_optimizer_state(runs, checkpoint_dir, data, tmp_path):
    """--resume_from <out>/final: the run starts from those adapters and
    optimizer counts and saves them advanced by its own steps."""
    from paligemma_tpu_torch.checkpoints.local import restore_pytree

    final = os.path.join(runs[1], "final")
    before = restore_pytree(final)
    out = tmp_path / "resumed"
    t_ft.main(_argv(checkpoint_dir, out, data[0], "--epochs", "1", "--resume_from", final,
                    "--learning_rate", "5e-2", "--only_cpu"))
    after = restore_pytree(str(out / "final"))
    steps = len(_metrics(str(out)))
    assert steps == 3
    assert after["opt_state"]["count"] == before["opt_state"]["count"] + steps
    assert not torch.equal(after["lora"]["layers"]["q"]["b"], before["lora"]["layers"]["q"]["b"])


def test_restore_pairs_moments_by_target_name(tmp_path):
    """A trainer whose adapter dict was built in another key order (JAX's
    tree comes back from ``jax.tree.map`` with sorted keys) restores the
    moments of each target under its name, not by position: k and v have
    one shape, so a positional pairing would swap them silently."""
    import paligemma_tpu_torch
    from paligemma_tpu_torch.convert import init_params
    from paligemma_tpu_torch.train.lora import init_lora
    from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = paligemma_tpu_torch.tiny_test_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    lora = init_lora(torch.Generator().manual_seed(1), cfg.text_config, 2)
    shuffled = {"layers": dict(sorted(lora["layers"].items()))}
    assert list(shuffled["layers"]) != list(lora["layers"])
    tc = TrainConfig(lora_rank=2, learning_rate=1e-2, grad_accum_steps=2)
    n = cfg.vision_config.num_patches
    rng = np.random.default_rng(0)
    ids = np.concatenate([np.full((2, n), cfg.image_token_index),
                          rng.integers(4, 100, (2, 12))], 1).astype(np.int32)
    ttype = np.broadcast_to(np.arange(ids.shape[1]) >= n + 4, ids.shape).astype(np.int32)
    batch = {"pixel_values": rng.standard_normal((2, 3, 28, 28)).astype(np.float32),
             "input_ids": ids, "attention_mask": np.ones_like(ids), "token_type_ids": ttype,
             "labels": np.where(ttype == 1, ids, -100).astype(np.int32)}
    a = Trainer(params, cfg, tc, lora=shuffled)
    for _ in range(3):
        a.train_step(batch)
    a.save(str(tmp_path / "ckpt"))
    b = Trainer(params, cfg, tc, lora=lora)
    b.restore(str(tmp_path / "ckpt"))
    names = [(t, k) for t, leaf in a.lora["layers"].items() for k in leaf]
    mine = [(t, k) for t, leaf in b.lora["layers"].items() for k in leaf]
    for key in ("mu", "nu", "acc"):
        by_name = dict(zip(names, a.opt_state[key]))
        for name, t in zip(mine, b.opt_state[key]):
            assert torch.equal(t, by_name[name]), (key, name)
    assert a.train_step(batch) == b.train_step(batch)


@pytest.mark.parametrize("extra", [("--base_quant", "nf4"), ("--full_finetune",),
                                   ("--quantize_int8",)])
def test_qlora_and_full_finetune_follow_jax(checkpoint_dir, data, tmp_path, monkeypatch,
                                            extra):
    """One epoch over an NF4 or int8 base, or a full LM fine-tune: the
    losses of JAX's CLI on the same rows and adapters (LOSS_TOL)."""
    from paligemma_tpu.cli.finetune import main as jax_main
    from paligemma_tpu_torch.train import lora as t_lora

    monkeypatch.setattr(t_lora, "init_lora", _jax_lora)
    flags = ("--epochs", "1", "--learning_rate", "1e-2", *extra)
    jax_main(_argv(checkpoint_dir, tmp_path / "jax", data[0], *flags))
    t_ft.main(_argv(checkpoint_dir, tmp_path / "port", data[0], *flags, "--only_cpu"))
    want, got = _metrics(str(tmp_path / "jax")), _metrics(str(tmp_path / "port"))
    assert len(got) == len(want) == 3
    np.testing.assert_allclose([r["train_loss"] for r in got], [r["train_loss"] for r in want],
                               atol=LOSS_TOL, rtol=0)
    from paligemma_tpu_torch.checkpoints.local import restore_pytree

    saved = restore_pytree(str(tmp_path / "port" / "final"))  # what the mode trains
    assert ("params" in saved) == ("--full_finetune" in extra) != ("lora" in saved)


# ---- the mesh flags: --data_parallel, --model_parallel, --fsdp, --multihost ----
# losses of a mesh run against one card's run of the same flags on the same
# bf16 checkpoint: the ranks sum in another order (bf16 partials of the
# row-parallel projections, gradients over the data group); measured apart
# by up to 3.9e-4 over 3 steps at lr 1e-3 (FSDP's full fine-tune; 9e-5 TP,
# 5e-7 DP). final/'s trees: where bf16 rounding flips the sign of an Adam
# update an element parts by up to 2 lr a step (measured 2.04e-3 after 3
# steps), so each leaf is held at 3 lr elementwise and at 0.2 lr on the
# mean of its differences (measured up to 6.1e-5)
MESH_LOSS_TOL = 5e-3
MESH_TREE_TOL = 3e-3
MESH_TREE_MEAN_TOL = 2e-4
# 5 rows at batch 2: three steps, the last with a padding row whose labels
# are all -100, which under --data_parallel 2 is one shard's only row
MESH_FLAGS = ("--epochs", "1", "--learning_rate", "1e-3", "--eval_every", "3",
              "--eval_subset", "1", "--max_new_tokens_eval", "3")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mesh_flags(case, data):
    """(mesh flags, flags the one-card run shares, whether it resumes)."""
    lora = ("--eval_jsonl", data[1], "--export_hf", *MESH_FLAGS)
    return {
        "data_parallel": (("--data_parallel", "2"), lora, False),
        "model_parallel": (("--model_parallel", "2"), MESH_FLAGS, True),
        "fsdp": (("--fsdp", "--data_parallel", "2"), ("--full_finetune", *MESH_FLAGS), False),
        "multihost": (("--multihost",), MESH_FLAGS, False),
        "coordinator": (("--multihost", "--coordinator", "127.0.0.1:{port}",
                         "--num_processes", "2", "--process_id", "{pid}"), MESH_FLAGS, True),
    }[case]


@pytest.fixture(scope="module")
def one_card_runs(mqa_checkpoint_dir, data, tmp_path_factory):
    """The one-card CLI on the MQA checkpoint for every case's shared flags:
    LoRA with an evaluation and the export, LoRA alone, the full fine-tune,
    and LoRA resumed from the first run's final/."""
    base = tmp_path_factory.mktemp("one_card")
    out = {}
    for name, flags in (("eval", ("--eval_jsonl", data[1], "--export_hf", *MESH_FLAGS)),
                        ("lora", MESH_FLAGS), ("full", ("--full_finetune", *MESH_FLAGS))):
        t_ft.main(_argv(mqa_checkpoint_dir, base / name, data[0], *flags, "--only_cpu"))
        out[name] = str(base / name)
    t_ft.main(_argv(mqa_checkpoint_dir, base / "resumed", data[0], *MESH_FLAGS, "--only_cpu",
                    "--resume_from", os.path.join(out["eval"], "final")))
    out["resumed"] = str(base / "resumed")
    return out


def _two_processes(argv, env_of):
    """``python -m paligemma_tpu_torch.cli.finetune`` as 2 processes of a
    --multihost run; ``env_of(pid)``: the environment's additions."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(2):
        env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **env_of(pid)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paligemma_tpu_torch.cli.finetune",
             *[a.format(pid=pid) for a in argv]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=repo))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return outs


@pytest.mark.parametrize("case", ["data_parallel", "model_parallel", "fsdp", "multihost",
                                  "coordinator", "model_parallel_3"])
def test_unported_flags_exit_2(mqa_checkpoint_dir, data, one_card_runs, tmp_path, capsys,
                               case):
    """The name is older than the mesh (these flags once exited 2). Each
    mesh flag as the JAX CLI takes it, on gloo ranks on the CPU: 2 spawned
    data shards (LoRA, with an evaluation and --export_hf; the last batch's
    padding row is one shard's only row), 2 tensor-parallel ranks resuming
    the one-card run's final/, --fsdp --full_finetune over 2 data shards,
    and --multihost as two processes joined through torchrun's environment
    or --coordinator (a 1 x 2 mesh: both on one host). metrics.jsonl's
    losses (and evaluations) and final/ follow the one-card run of the same
    flags; the evaluation and export come from rank 0 alone.
    ``model_parallel_3`` (3 ranks over 4 heads) exits 2 before any rank
    starts, as JAX's sharding refuses it."""
    from paligemma_tpu_torch.checkpoints.local import restore_pytree

    out = tmp_path / "out"
    if case == "model_parallel_3":
        with pytest.raises(SystemExit) as ei:
            t_ft.main(_argv(mqa_checkpoint_dir, out, data[0], "--only_cpu", "--model_parallel",
                            "3", *MESH_FLAGS))
        assert ei.value.code == 2
        assert "--model_parallel 3" in capsys.readouterr().err and not out.exists()
        return
    mesh, shared, resume = _mesh_flags(case, data)
    argv = _argv(mqa_checkpoint_dir, out, data[0], *shared, *mesh, "--only_cpu")
    if resume:
        argv += ["--resume_from", os.path.join(one_card_runs["eval"], "final")]
    want_dir = one_card_runs[{"data_parallel": "eval", "fsdp": "full"}.get(
        case, "resumed" if resume else "lora")]
    if case == "coordinator":
        port = _free_port()
        _two_processes([a.replace("{port}", str(port)) for a in argv], lambda pid: {})
    elif case == "multihost":
        port = _free_port()
        _two_processes(argv, lambda pid: {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                                          "RANK": str(pid), "WORLD_SIZE": "2"})
    else:
        t_ft.main(argv)
    got, want = _metrics(str(out)), _metrics(want_dir)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    losses = [(g["train_loss"], w["train_loss"]) for g, w in zip(got, want) if "train_loss" in w]
    assert len(losses) == 3
    np.testing.assert_allclose(*zip(*losses), atol=MESH_LOSS_TOL, rtol=0)
    evals = [(g["val_edit_distance"], w["val_edit_distance"])
             for g, w in zip(got, want) if "val_edit_distance" in w]
    assert [g for g, _ in evals] == [w for _, w in evals]
    assert sorted(os.listdir(out)) == sorted(os.listdir(want_dir))
    a, b = restore_pytree(str(out / "final")), restore_pytree(os.path.join(want_dir, "final"))
    assert a["opt_state"]["count"] == b["opt_state"]["count"]
    key = "params" if case == "fsdp" else "lora"
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a[key]),
                            jax.tree.leaves(b[key])):
        torch.testing.assert_close(x.float(), y.float(), atol=MESH_TREE_TOL, rtol=0,
                                   msg=jax.tree_util.keystr(path))
        assert float((x.float() - y.float()).abs().mean()) <= MESH_TREE_MEAN_TOL, path


def test_orbax_resume_exits_2(checkpoint_dir, data, tmp_path, capsys):
    """A JAX training state (orbax) is refused before the model loads."""
    import jax.numpy as jnp

    from paligemma_tpu.checkpoints.local import save_pytree

    orbax_dir = tmp_path / "jax_final"
    save_pytree(str(orbax_dir), {"lora": {"a": jnp.zeros((2, 2))}})
    assert os.listdir(orbax_dir)
    with pytest.raises(SystemExit) as ei:
        t_ft.main(_argv(checkpoint_dir, tmp_path / "out", data[0], "--only_cpu",
                        "--resume_from", str(orbax_dir)))
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert "state.pt" in err and "orbax" in err and len(err.strip().splitlines()) == 1


def test_no_card_and_user_mistakes_exit_2(checkpoint_dir, data, tmp_path, capsys,
                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ei:
        t_ft.main(_argv(checkpoint_dir, tmp_path / "out", data[0]))
    assert ei.value.code == 2 and "--only_cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit) as ei:  # tests/test_cli.py's friendly error
        t_ft.main(_argv(checkpoint_dir, tmp_path / "out", "/nonexistent/train.jsonl",
                        "--only_cpu"))
    assert ei.value.code == 2 and "not found" in capsys.readouterr().err
    with pytest.raises(SystemExit) as ei:
        t_ft.main(["--model_path", checkpoint_dir, "--output_dir", str(tmp_path / "o"),
                   "--only_cpu"])
    assert ei.value.code == 2 and "--train_jsonl or --hf_dataset" in capsys.readouterr().err
