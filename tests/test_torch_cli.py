"""The port's inference CLI (``python -m paligemma_tpu_torch.cli.infer``)
against the JAX package's CLI, on a fabricated tiny HF checkpoint directory
(config.json + model.safetensors + fast tokenizer), the artifact a user
points ``--model_path`` at (CPU):

* ``--only_cpu --dtype float32`` prints the JAX CLI's ``prompt + decoded``
  lines exactly, for one row and with ``--decode_detections``;
* a sampled batch is deterministic per ``--seed``;
* ``--quantize_int8`` gives the port engine's tokens on the int8 tree;
  ``--quantize_int8 --int8_prefill`` prints the JAX CLI's rows on a prompt
  long enough for W8A8 (single-copy serving);
* ``--speculative`` prints the JAX CLI's ``--speculative`` rows, which are
  its greedy rows, and refuses sampling and batches as the JAX CLI does;
* user mistakes, flags of parts not yet ported, ``--int8_prefill`` without
  ``--quantize_int8``, a missing card and ``--dtype float32`` on a card
  exit 2 with a one-line reason;
* ``--only_cpu --model_parallel 2`` (two spawned gloo ranks, cli/ranks) on
  a checkpoint with one KV head prints, from rank 0 only, the JAX CLI's
  ``--model_parallel 2`` rows and the port's one-rank rows, greedy and
  ``--speculative``; a rank that raises makes the command exit nonzero.
"""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from paligemma_tpu_torch.cli import infer as t_infer
from paligemma_tpu_torch.checkpoints.hf_loader import load_hf_model
from paligemma_tpu_torch.processing.processor import PaliGemmaProcessor
from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving

torch.set_num_threads(2)

VOCAB = 288


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
# ---- end of the copied fixture ----


def _rows(out: str):
    """The lines printed after "Running inference"."""
    lines = out.splitlines()
    return lines[lines.index("Running inference") + 1:]


def _argv(checkpoint_dir, image_path, prompts, *extra):
    argv = ["--model_path", checkpoint_dir]
    for p in prompts:
        argv += ["--prompt", p, "--image_file_path", image_path]
    return argv + list(extra)


@pytest.mark.parametrize("prompts,extra", [
    (["describe the image"], []),
    (["detect this building", "answer in english"], ["--decode_detections"]),
], ids=["one_row", "detections"])
def test_cli_prints_the_jax_cli_rows(checkpoint_dir, image_path, capsys, prompts, extra):
    from paligemma_tpu.cli.infer import main as jax_main

    argv = _argv(checkpoint_dir, image_path, prompts, "--max_tokens_to_generate", "5",
                 "--dtype", "float32", *extra)
    jax_main(argv)
    want = _rows(capsys.readouterr().out)
    t_infer.main(argv + ["--only_cpu"])
    cap = capsys.readouterr()
    got = _rows(cap.out)
    assert got == want
    assert len(got) == len(prompts) * (2 if extra else 1)
    assert all(r.startswith(p) for r, p in zip(got[::2 if extra else 1], prompts))
    if extra:
        assert all(isinstance(json.loads(r), list) for r in got[1::2])
    assert cap.out.splitlines()[:2] == ["Device in use: cpu", "Loading model"]
    timings = json.loads(cap.err.split("timings: ", 1)[1].splitlines()[0])
    assert timings["tokens"] == 5 and timings["prefill_ms"] > 0 and "quantize_s" not in timings


def test_cli_sampled_batch_is_deterministic_per_seed(checkpoint_dir, image_path, capsys):
    def sample(seed):
        argv = _argv(checkpoint_dir, image_path, ["hello world", "this building is a"],
                     "--max_tokens_to_generate", "6", "--do_sample", "--temperature", "0.7",
                     "--top_p", "0.9", "--seed", str(seed), "--only_cpu")
        res = t_infer.run(t_infer.parse_args(argv))
        # a decoded row may hold a newline token
        assert _rows(capsys.readouterr().out) == "\n".join(res.texts).splitlines()
        return res

    a, b, c = sample(0), sample(0), sample(1)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.texts == b.texts and a.texts[0].startswith("hello world")
    assert not np.array_equal(a.tokens, c.tokens)


def test_cli_quantize_int8_gives_the_engine_tokens(checkpoint_dir, image_path, capsys):
    """The CLI (default bf16, --quantize_int8) against PaliGemmaEngine on
    the int8 tree of the same checkpoint, fed the port processor's inputs
    for the same image and prompts."""
    from PIL import Image

    prompts = ["describe the image", "hello"]
    res = t_infer.run(t_infer.parse_args(_argv(
        checkpoint_dir, image_path, prompts, "--max_tokens_to_generate", "7",
        "--quantize_int8", "--only_cpu")))
    capsys.readouterr()
    assert res.pixel_route in ("native", "pil") and "quantize_s" in res.timings

    params, cfg = load_hf_model(checkpoint_dir, torch.bfloat16, device="cpu")
    tok = transformers.AutoTokenizer.from_pretrained(checkpoint_dir, padding_side="right")
    proc = PaliGemmaProcessor(tok, cfg.vision_config.num_image_tokens,
                              cfg.vision_config.image_size)
    inputs = proc(images=[Image.open(image_path)] * 2, text=prompts)
    assert proc.last_route == res.pixel_route
    eng = PaliGemmaEngine(params, cfg, max_seq_len=1024, eos_token_id=tok.eos_token_id,
                          decode_params=quantize_lm_for_serving(params))
    want = eng.generate(inputs["pixel_values"], inputs["input_ids"], inputs["attention_mask"],
                        max_new_tokens=7, sync_every=t_infer.SYNC_EVERY)
    np.testing.assert_array_equal(res.tokens, want)


def test_cli_int8_prefill_prints_the_jax_cli_rows(checkpoint_dir, image_path, capsys,
                                                  monkeypatch):
    """--quantize_int8 --int8_prefill (single-copy, W8A8 prefill) on a
    prompt of 260+ tokens: the JAX CLI's rows; the prefill's 4 products a
    layer took W8A8."""
    from paligemma_tpu.cli.infer import main as jax_main
    from paligemma_tpu_torch.kernels import quant as t_quant

    argv = _argv(checkpoint_dir, image_path, [" ".join(["hello", "world"] * 130)],
                 "--max_tokens_to_generate", "5", "--dtype", "float32", "--quantize_int8",
                 "--int8_prefill")
    jax_main(argv)
    want = _rows(capsys.readouterr().out)
    calls = []
    plain = t_quant._w8a8_matmul
    monkeypatch.setattr(t_quant, "_w8a8_matmul", lambda *a: calls.append(a[0].shape) or plain(*a))
    res = t_infer.run(t_infer.parse_args(argv + ["--only_cpu"]))
    assert _rows(capsys.readouterr().out) == want
    assert len(calls) == 4 * 2 and all(s[1] >= 256 for s in calls)
    assert res.tokens.shape == (1, 5) and "quantize_s" in res.timings


def test_cli_friendly_errors(checkpoint_dir, image_path, capsys):
    """User mistakes exit 2 with a one-line message (as the JAX CLI's)."""
    with pytest.raises(SystemExit) as ei:
        t_infer.main(["--model_path", checkpoint_dir, "--prompt", "a", "--prompt", "b",
                      "--image_file_path", image_path, "--only_cpu"])
    assert ei.value.code == 2
    assert "one image per prompt" in capsys.readouterr().err

    with pytest.raises(SystemExit) as ei:
        t_infer.main(["--model_path", checkpoint_dir, "--prompt", "a",
                      "--image_file_path", "/nonexistent/pic.png", "--only_cpu"])
    assert ei.value.code == 2
    assert "file not found" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [[], ["--quantize_int8"]], ids=["bf16", "int8"])
def test_cli_speculative_prints_the_jax_cli_rows(checkpoint_dir, image_path, capsys, extra):
    """--speculative (generate_spec) against the JAX CLI's --speculative
    (fp32 weights; each CLI quantizes its own int8 tree, so the int8 run is
    held against the port's greedy rows only), and against the port's own
    greedy rows."""
    from paligemma_tpu.cli.infer import main as jax_main

    argv = _argv(checkpoint_dir, image_path, ["describe the image"], "--max_tokens_to_generate",
                 "9", "--dtype", "float32", *extra)
    spec = t_infer.run(t_infer.parse_args(argv + ["--only_cpu", "--speculative",
                                                  "--draft_k", "3"]))
    got = _rows(capsys.readouterr().out)
    greedy = t_infer.run(t_infer.parse_args(argv + ["--only_cpu"]))
    capsys.readouterr()
    if not extra:
        jax_main(argv + ["--speculative", "--draft_k", "3"])
        assert got == _rows(capsys.readouterr().out)
    assert spec.texts == greedy.texts and len(got) == 1
    np.testing.assert_array_equal(spec.tokens, greedy.tokens)
    assert 1 <= spec.timings["spec_cycles"] <= spec.tokens.shape[1]


@pytest.mark.parametrize("flags,match", [
    (["--do_sample"], "greedy-only"),
    (["--prompt", "b", "--image_file_path", None], "one image/prompt"),
], ids=["sampled", "batch"])
def test_cli_speculative_rules_exit_2(checkpoint_dir, image_path, capsys, flags, match):
    flags = [image_path if f is None else f for f in flags]
    with pytest.raises(SystemExit) as ei:
        t_infer.main(_argv(checkpoint_dir, image_path, ["a"], "--only_cpu", "--speculative",
                           *flags))
    assert ei.value.code == 2
    cap = capsys.readouterr()
    assert match in cap.err and "Loading model" not in cap.out


@pytest.mark.parametrize("flag,match", [
    pytest.param(["--int8_prefill"], "--int8_prefill requires --quantize_int8",
                 id="flag0---int8_prefill requires --quantize_int8"),
    pytest.param(["--data_parallel", "2"], "pass a multiple of 2 prompts",
                 id="flag1-ROADMAP item 14"),
    pytest.param(["--data_parallel", "2", "--model_parallel", "2"],
                 "pass a multiple of 2 prompts", id="flag2-ROADMAP item 14"),
])
def test_cli_unported_flags_exit_2(checkpoint_dir, image_path, capsys, flag, match):
    """Flag combinations the CLI refuses exit 2 before anything loads: a
    data axis the one prompt does not divide over (also beside a model
    axis); --int8_prefill without --quantize_int8, with the JAX CLI's
    message."""
    with pytest.raises(SystemExit) as ei:
        t_infer.main(_argv(checkpoint_dir, image_path, ["a"], "--only_cpu", *flag))
    assert ei.value.code == 2
    cap = capsys.readouterr()
    assert flag[0] in cap.err and match in cap.err
    assert "Loading model" not in cap.out


def test_cli_without_a_card_does_not_run_on_the_cpu(checkpoint_dir, image_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    with pytest.raises(SystemExit) as ei:
        t_infer.main(_argv(checkpoint_dir, image_path, ["a"]))
    assert ei.value.code == 2
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and "--only_cpu" in cap.err
    assert "Loading model" not in cap.out
    with pytest.raises(t_infer.CliError):
        t_infer.run(t_infer.parse_args(_argv(checkpoint_dir, image_path, ["a"])))


def test_cli_float32_on_the_card_exits_2(checkpoint_dir, image_path, capsys, monkeypatch):
    """--dtype float32 runs on the card through the kernels' fp32 forms: alone
    and with every flag (--quantize_int8, --speculative, --int8_prefill,
    --model_parallel 2, --data_parallel 2) it passes the device check, and
    nothing loads there. (The name is from when the last three exited 2.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for prompts, extra in ((["a"], []), (["a"], ["--quantize_int8"]), (["a"], ["--speculative"]),
                           (["a"], ["--quantize_int8", "--int8_prefill"]),
                           (["a"], ["--model_parallel", "2"]),
                           (["a", "b"], ["--data_parallel", "2"])):
        args = t_infer.parse_args(_argv(checkpoint_dir, image_path, prompts, "--dtype", "float32",
                                        *extra))
        assert t_infer._device(args) == torch.device("cuda", 0), extra
    assert "Loading model" not in capsys.readouterr().out


# ---- tensor parallel: --model_parallel 2 on two spawned gloo ranks ----
@pytest.fixture(scope="module")
def mqa_checkpoint_dir(tmp_path_factory):
    """The fixture's checkpoint with one KV head (the port's tensor-parallel
    rule: one KV head, or one per query head) and 4 query heads of 32, in
    the fixture's tokenizer."""
    d = tmp_path_factory.mktemp("mqa_ckpt")
    cfg = transformers.PaliGemmaConfig(
        vision_config=dict(
            image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, projection_dim=64,
            vision_use_head=False,
        ),
        text_config=dict(
            vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
            head_dim=32, model_type="gemma",
            bos_token_id=2, eos_token_id=1, pad_token_id=0,
        ),
        projection_dim=64, image_token_index=280, pad_token_id=0,
        vocab_size=VOCAB,
    )
    torch.manual_seed(1)
    transformers.PaliGemmaForConditionalGeneration(cfg).eval().save_pretrained(
        str(d), safe_serialization=True)
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["this", "building", "is", "a", "answer", "in", "english", "hello",
             "world", "describe", "the", "image", "extract", "json"]
    vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "\n": 3, "<unk>": 4}
    for w in words:
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="<pad>", eos_token="<eos>", bos_token="<bos>",
        unk_token="<unk>").save_pretrained(str(d))
    return str(d)


@pytest.mark.parametrize("extra", [[], ["--speculative", "--draft_k", "3"]],
                         ids=["greedy", "speculative"])
def test_cli_model_parallel_prints_the_jax_cli_rows(mqa_checkpoint_dir, image_path, capfd,
                                                    extra):
    """Rank 0 alone prints the rows and the timings; both ranks on the CPU
    over gloo; the rows are the JAX CLI's --model_parallel 2 rows (its
    make_mesh(1, 2) on the virtual devices) and the port's one-rank rows."""
    from paligemma_tpu.cli.infer import main as jax_main

    argv = _argv(mqa_checkpoint_dir, image_path, ["describe the image"],
                 "--max_tokens_to_generate", "6", "--dtype", "float32", *extra)
    jax_main(argv + ["--model_parallel", "2"])
    want = _rows(capfd.readouterr().out)
    t_infer.main(argv + ["--only_cpu", "--model_parallel", "2"])
    cap = capfd.readouterr()
    got = _rows(cap.out)
    t_infer.main(argv + ["--only_cpu"])
    one = _rows(capfd.readouterr().out)
    assert got == want == one and len(got) == 1
    assert cap.out.count("Running inference") == 1 and cap.err.count("timings: ") == 1
    assert "ranks: 2 over gloo, devices cpu, cpu" in cap.err
    timings = json.loads(cap.err.split("timings: ", 1)[1].splitlines()[0])
    assert timings["tokens"] == 6 and ("spec_cycles" in timings) == bool(extra)


def test_cli_model_parallel_rank_failure_exits_nonzero(mqa_checkpoint_dir, image_path, capfd):
    """--model_parallel 3 over 4 heads: every rank raises while sharding;
    the command exits nonzero with the rank's reason (no hang, no rows)."""
    with pytest.raises(SystemExit) as ei:
        t_infer.main(_argv(mqa_checkpoint_dir, image_path, ["a"], "--only_cpu", "--dtype",
                           "float32", "--model_parallel", "3"))
    assert ei.value.code not in (0, None)
    cap = capfd.readouterr()
    assert "do not split over 3 ranks" in cap.err and "Running inference" not in cap.out


# ---- data parallel: --data_parallel 2 (x --model_parallel 2) on spawned gloo ranks ----
@pytest.mark.parametrize("mesh", [["--data_parallel", "2"],
                                  ["--data_parallel", "2", "--model_parallel", "2"]],
                         ids=["data_parallel", "data_parallel_x_model_parallel"])
def test_cli_data_parallel_prints_the_jax_cli_rows(mqa_checkpoint_dir, image_path, capfd, mesh):
    """Two prompts over a data axis of 2 (alone and beside a model axis of
    2): rank 0 alone prints both rows in prompt order and the timings; the
    rows are the JAX CLI's (its make_mesh on the virtual devices) and the
    port's one-rank rows; --speculative with a data axis exits 2."""
    from paligemma_tpu.cli.infer import main as jax_main

    argv = _argv(mqa_checkpoint_dir, image_path, ["describe the image", "hello world"],
                 "--max_tokens_to_generate", "6", "--dtype", "float32")
    jax_main(argv + mesh)
    want = _rows(capfd.readouterr().out)
    t_infer.main(argv + ["--only_cpu", *mesh])
    cap = capfd.readouterr()
    got = _rows(cap.out)
    t_infer.main(argv + ["--only_cpu"])
    one = _rows(capfd.readouterr().out)
    assert got == want == one and len(got) == 2
    assert got[0].startswith("describe the image") and got[1].startswith("hello world")
    assert cap.out.count("Running inference") == 1 and cap.err.count("timings: ") == 1
    world = 2 * (2 if "--model_parallel" in mesh else 1)
    assert f"ranks: {world} over gloo" in cap.err and "mesh data 2 x model" in cap.err
    with pytest.raises(SystemExit) as ei:
        t_infer.main(_argv(mqa_checkpoint_dir, image_path, ["a", "b"], "--only_cpu",
                           "--speculative", *mesh))
    assert ei.value.code == 2 and "cannot split over --data_parallel 2" in capfd.readouterr().err
