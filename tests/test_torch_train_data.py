"""The port's fine-tuning data, HF-dataset and metrics modules against the
JAX package's (CPU):

* ``json2token`` / ``token2json`` / ``normalized_edit_distance`` give the
  same strings, trees and floats, exactly;
* ``collate`` builds the same batches, array for array (pixels, ids,
  masks, ``token_type_ids`` and the ``-100`` labels), with targets, without
  them, and truncated at ``max_length``;
* ``HFDatasetAdapter`` / ``load_hf_rows`` give the same rows from a
  CORD-style dataset written with ``save_to_disk``;
* ``MetricsLogger`` writes the same keys and values.
"""

import json

import numpy as np
import pytest

from paligemma_tpu.processing.processor import PaliGemmaProcessor as JProcessor
from paligemma_tpu.runtime import logging as j_logging
from paligemma_tpu.train import data as j_data
from paligemma_tpu_torch.processing.processor import PaliGemmaProcessor as TProcessor
from paligemma_tpu_torch.runtime import logging as t_logging
from paligemma_tpu_torch.train import data as t_data

PIL = pytest.importorskip("PIL")
from PIL import Image

IMAGE_TOKEN = "<image>"
WORDS = ["alpha", "beta", "gamma", "delta", "menu", "price", "total", "latte", "4.00"]


class StubTokenizer:
    """Whitespace tokenizer with the interface collate uses (as in
    tests/test_processing.py); ids are given in order of first sight."""

    bos_token = "<bos>"
    eos_token_id = 1

    def __init__(self):
        self.vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "\n": 3}

    def add_special_tokens(self, d):
        for t in d.get("additional_special_tokens", []):
            self.vocab.setdefault(t, len(self.vocab))

    def add_tokens(self, toks):
        for t in toks:
            self.vocab.setdefault(t, len(self.vocab))

    def convert_tokens_to_ids(self, tok):
        return self.vocab[tok]

    def _encode(self, s):
        ids = []
        while s:
            for t in (IMAGE_TOKEN, self.bos_token, "\n"):
                if s.startswith(t):
                    ids.append(self.vocab[t])
                    s = s[len(t):]
                    break
            else:
                if s.startswith(" "):
                    s = s[1:]
                    continue
                w = s.split(" ")[0].split("\n")[0]
                self.vocab.setdefault(w, len(self.vocab))
                ids.append(self.vocab[w])
                s = s[len(w):]
        return ids


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _target(rng):
    """A seeded JSON target: nested dicts, lists and strings."""
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), 6)]
    kinds = rng.integers(0, 3)
    if kinds == 0:
        return {"total": words[0], "menu": [{"nm": words[1], "price": words[2]},
                                            {"nm": words[3], "price": words[4]}]}
    if kinds == 1:
        return {"menu": {"nm": words[0], "cnt": words[1]}, "sub": [words[2], words[3]]}
    return {"text_sequence": " ".join(words)}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sort_json_key", [True, False])
def test_json2token_and_back_equal_jax(seed, sort_json_key):
    obj = _target(np.random.default_rng(seed))
    want = j_data.json2token(obj, sort_json_key)
    got = t_data.json2token(obj, sort_json_key)
    assert got == want
    assert t_data.token2json(got) == j_data.token2json(want)
    # a top-level list of dicts, and unclosed / stray markers
    for s in (f"{want}<sep/>{want}", "<s_a>x</s_a><s_b>y", "<s_a><sep/>z</s_a>", ""):
        assert t_data.token2json(s) == j_data.token2json(s), s


def test_normalized_edit_distance_equals_jax():
    rng = np.random.default_rng(3)
    alphabet = np.array(list("ab<>/s_ "))
    pairs = [("", ""), ("a", ""), ("kitten", "sitting")]
    pairs += [("".join(rng.choice(alphabet, rng.integers(0, 20))),
               "".join(rng.choice(alphabet, rng.integers(0, 20)))) for _ in range(40)]
    for a, b in pairs:
        assert t_data.normalized_edit_distance(a, b) == j_data.normalized_edit_distance(a, b)


def _processors(image_size=28, n_image=4):
    return (JProcessor(StubTokenizer(), num_image_tokens=n_image, image_size=image_size),
            TProcessor(StubTokenizer(), num_image_tokens=n_image, image_size=image_size))


@pytest.mark.parametrize("case", ["train", "eval", "truncated"])
def test_collate_equals_jax(case):
    """Frames of three sizes (the PIL route of both packages), prompts of
    two lengths, JSON-derived targets; the tail of a truncated row keeps its
    suffix type and labels as far as it goes."""
    jp, tp = _processors()
    rng = np.random.default_rng(5)
    images = [_image(i, *hw) for i, hw in enumerate([(40, 40), (60, 30), (28, 28)])]
    prompts = ["extract json", "describe the menu and the total", "extract json"]
    targets = [j_data.json2token(_target(rng)) for _ in prompts]
    kw = {"targets": None if case == "eval" else targets,
          "max_length": 9 if case == "truncated" else 512, "pad_to_multiple": 8}
    want = j_data.collate(jp, images, prompts, **kw)
    got = t_data.collate(tp, images, prompts, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case == "train":
        assert (got["labels"] == -100).any() and (got["labels"] >= 0).any()
        sfx = got["token_type_ids"] == 1
        np.testing.assert_array_equal(got["labels"][sfx], got["input_ids"][sfx])
    if case == "truncated":
        assert got["input_ids"].shape[1] == 16 and got["attention_mask"].sum(1).max() == 9


@pytest.fixture(scope="module")
def cord_dir(tmp_path_factory):
    """A CORD-shaped dataset saved to disk: gt_parse rows, a gt_parses row
    (the first parse wins), as in tests/test_cli.py's hf_dataset_dir."""
    datasets = pytest.importorskip("datasets")
    imgs = [_image(i, 40, 30 + 10 * i) for i in range(4)]
    gts = [json.dumps({"gt_parse": {"total": str(10 + i),
                                    "menu": [{"nm": WORDS[i], "price": str(i)}]}})
           for i in range(3)]
    gts.append(json.dumps({"gt_parses": [{"total": "a"}, {"total": "b"}]}))
    ds = datasets.Dataset.from_dict({"image": imgs, "ground_truth": gts}).cast_column(
        "image", datasets.Image())
    d = tmp_path_factory.mktemp("hfds") / "cord_tiny"
    datasets.DatasetDict({"train": ds, "validation": ds.select([3, 0])}).save_to_disk(str(d))
    return str(d)


@pytest.mark.parametrize("split", ["train", "validation"])
def test_hf_rows_equal_jax(cord_dir, split):
    from paligemma_tpu.train import hf_dataset as j_hf
    from paligemma_tpu_torch.train import hf_dataset as t_hf

    want = list(j_hf.load_hf_rows(cord_dir, split=split, prompt="extract JSON.").rows())
    got = list(t_hf.load_hf_rows(cord_dir, split=split, prompt="extract JSON.").rows())
    assert len(got) == len(want) == (4 if split == "train" else 2)
    for g, w in zip(got, want):
        assert g["prompt"] == w["prompt"] and g["target"] == w["target"]
        np.testing.assert_array_equal(np.asarray(g["image"]), np.asarray(w["image"]))
    assert got[-1 if split == "train" else 0]["target"] == "<s_total>a</s_total>"


def test_hf_adapter_target_column_equals_jax():
    """Rows with a plain ``target`` column (a string or a JSON tree)."""
    from paligemma_tpu.train import hf_dataset as j_hf
    from paligemma_tpu_torch.train import hf_dataset as t_hf

    rows = [{"image": None, "target": "plain words"},
            {"image": None, "target": {"total": "3", "menu": ["a", "b"]}}]
    for sort in (True, False):
        want = list(j_hf.HFDatasetAdapter(rows, prompt="p", sort_json_key=sort).rows())
        got = list(t_hf.HFDatasetAdapter(rows, prompt="p", sort_json_key=sort).rows())
        assert got == want


def test_metrics_logger_lines_equal_jax(tmp_path):
    """The same keys in the same order and the same values (the wall-clock
    ``time`` apart), a float-convertible value written as a float."""
    lines = []
    for mod, name in ((j_logging, "j"), (t_logging, "t")):
        path = tmp_path / name / "metrics.jsonl"
        with mod.MetricsLogger(str(path), flush_every=2) as log:
            log.log(1, epoch=0, train_loss=np.float32(1.5), step_ms=12.0, tokens_per_sec=3)
            log.log(1, val_edit_distance=0.25)
            log.log(2, note="text")
        lines.append([json.loads(x) for x in path.read_text().splitlines()])
    want, got = lines
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        g.pop("time"), w.pop("time")
        assert g == w
    assert got[0]["train_loss"] == 1.5 and isinstance(got[0]["tokens_per_sec"], float)
