"""The port's image processing against the JAX package's (CPU):

* ``process_images_host`` (PIL) bit for bit;
* ``preprocess_device`` (torch, antialiased bicubic) within 1e-4 in
  normalized units of JAX's ``jax.image.resize`` path (measured ~2e-5);
* the native C++ library, built from the port's own copy of the source
  into the port's build tree, bit for bit at 1 and 8 threads;
* ``PaliGemmaProcessor``: the same ``input_ids``, ``attention_mask`` and
  ``pixel_values`` for padded batches on the native and the PIL routes,
  and no fallback to PIL when the native library fails;
* ``processing/detection.py`` against JAX's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL")
from PIL import Image

from paligemma_tpu.processing import detection as j_det
from paligemma_tpu.processing import images as j_images
from paligemma_tpu.processing import native as j_native
from paligemma_tpu.processing import processor as j_processor
from paligemma_tpu_torch.processing import detection as t_det
from paligemma_tpu_torch.processing import images as t_images
from paligemma_tpu_torch.processing import native as t_native
from paligemma_tpu_torch.processing import processor as t_processor

torch.set_num_threads(2)

IMAGE_TOKEN = "<image>"


class StubTokenizer:
    """Minimal HF-tokenizer-compatible stub (whitespace tokens), as in
    tests/test_processing.py."""

    bos_token = "<bos>"
    eos_token_id = 1

    def __init__(self):
        self.vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "\n": 3}
        self.add_eos_token = True
        self.add_bos_token = True

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
            if s.startswith(IMAGE_TOKEN):
                ids.append(self.vocab[IMAGE_TOKEN]); s = s[len(IMAGE_TOKEN):]
            elif s.startswith(self.bos_token):
                ids.append(self.vocab["<bos>"]); s = s[len(self.bos_token):]
            elif s.startswith("\n"):
                ids.append(self.vocab["\n"]); s = s[1:]
            elif s.startswith(" "):
                s = s[1:]
            else:
                w = s.split(" ")[0].split("\n")[0]
                self.vocab.setdefault(w, len(self.vocab))
                ids.append(self.vocab[w]); s = s[len(w):]
        return ids

    def __call__(self, texts, return_tensors="np", truncation=True, padding="longest"):
        seqs = [self._encode(t) for t in texts]
        maxlen = max(len(s) for s in seqs)
        ids = np.zeros((len(seqs), maxlen), np.int64)
        mask = np.zeros((len(seqs), maxlen), np.int64)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _raw(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _image(seed, h, w):
    return Image.fromarray(_raw(seed, 1, h, w)[0])


@pytest.mark.parametrize("hw,size", [((300, 400), 224), ((40, 40), 28), ((20, 30), 28)])
def test_process_images_host_matches_jax_bitwise(hw, size):
    imgs = [_image(i, *hw) for i in range(2)]
    want = j_images.process_images_host(imgs, size)
    got = t_images.process_images_host(imgs, size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(300, 400), (500, 300), (100, 150)])
def test_preprocess_device_matches_jax(hw):
    raw = _raw(1, 2, *hw)
    want = np.asarray(j_images.preprocess_device(jnp.asarray(raw), 224))
    got = t_images.preprocess_device(raw, 224, device="cpu")
    assert got.shape == want.shape == (2, 3, 224, 224) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # a tensor runs where it lies; float input the same as uint8
    same = t_images.preprocess_device(torch.from_numpy(raw).float(), 224)
    assert same.device.type == "cpu"
    np.testing.assert_allclose(same.numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_preprocess_device_numpy_goes_to_the_card():
    """A numpy array goes to the card unless device="cpu" is given: with
    no card it raises, it does not run on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_images.preprocess_device(_raw(0, 1, 32, 32), 28)


def _needs_native():
    if not (t_native.native_available() and j_native.native_available()):
        pytest.skip("g++ not available to build the native library")


@pytest.mark.parametrize("threads", [1, 8])
def test_native_matches_jax_bitwise(threads):
    _needs_native()
    for raw, size in ((_raw(2, 8, 64, 48), 28), (_raw(3, 3, 300, 400), 224),
                      (_raw(4, 2, 16, 16), 28)):
        want = j_native.preprocess_images_native(raw, size, num_threads=threads)
        got = t_native.preprocess_images_native(raw, size, num_threads=threads)
        np.testing.assert_array_equal(got, want)


def test_native_builds_from_its_own_source_into_the_build_tree():
    _needs_native()
    so = t_native.library_path()
    assert so.exists() and so.parent.name.startswith("native-")
    assert so.parent.parent == t_native.BUILD_ROOT
    assert t_native._LIB._name == str(so)
    port_src = t_native.SOURCE
    jax_src = os.path.join(os.path.dirname(j_native.__file__), "..", "native", "preprocess.cc")
    with open(port_src, "rb") as a, open(jax_src, "rb") as b:
        assert a.read() == b.read()  # a byte-for-byte copy
    assert not os.path.exists(port_src.parent / "libpreprocess.so")
    with pytest.raises(ValueError):
        t_native.preprocess_images_native(np.zeros((1, 8, 8), np.uint8), 28)


@pytest.mark.parametrize("route", ["native", "pil"])
def test_processor_matches_jax(route):
    """A padded batch of three: same-size images take the native library,
    mixed sizes PIL, in both packages. Each processor gets a fresh
    tokenizer (the processor adds 1,153 tokens to the one it is given)."""
    if route == "native":
        _needs_native()
        images = [_image(i, 60, 80) for i in range(3)]
    else:
        images = [_image(0, 60, 80), _image(1, 40, 40), _image(2, 90, 30)]
    prompts = ["caption en", "detect cat ; dog", "answer en what is this"]
    want = j_processor.PaliGemmaProcessor(StubTokenizer(), num_image_tokens=4,
                                          image_size=28)(images=images, text=prompts)
    proc = t_processor.PaliGemmaProcessor(StubTokenizer(), num_image_tokens=4, image_size=28)
    got = proc(images=images, text=prompts)
    assert proc.last_route == route
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mask = got["attention_mask"]
    assert mask.sum(1).tolist() != [mask.shape[1]] * 3  # padded
    assert (np.diff(mask, axis=1) <= 0).all()  # on the right
    assert proc.build_prompt("x") == IMAGE_TOKEN * 4 + "<bos>x\n"
    with pytest.raises(ValueError, match="pair 1:1"):
        proc(images=images[:2], text=prompts)


def test_processor_raises_when_the_native_library_fails(monkeypatch):
    """No quiet swap to PIL pixels: native and PIL differ by up to 0.35."""
    _needs_native()

    def broken(raw, image_size, num_threads=0):
        raise RuntimeError("native preprocessor failed")

    monkeypatch.setattr(t_processor, "preprocess_images_native", broken)
    proc = t_processor.PaliGemmaProcessor(StubTokenizer(), num_image_tokens=4, image_size=28)
    with pytest.raises(RuntimeError, match="native preprocessor failed"):
        proc(images=[_image(0, 40, 40)] * 2, text=["a", "b"])


def test_processor_takes_pil_without_the_native_library(monkeypatch):
    monkeypatch.setattr(t_processor, "native_available", lambda: False)
    images = [_image(i, 60, 80) for i in range(2)]
    proc = t_processor.PaliGemmaProcessor(StubTokenizer(), num_image_tokens=4, image_size=28)
    got = proc(images=images, text=["a", "b"])
    assert proc.last_route == "pil"
    np.testing.assert_array_equal(got["pixel_values"],
                                  j_images.process_images_host(images, 28))


DETECTION_STRINGS = [
    "<loc0100><loc0200><loc0300><loc0400> cat ; <loc0000><loc0000><loc1023><loc1023> dog",
    "prompt echo <loc0512> <loc0256> <loc0768> <loc0900> "
    + " ".join(f"<seg{i:03d}>" for i in range(16)) + " car",
    "<loc0010><loc0020> broken ; <loc0001><loc0002><loc0003><loc0004>",
    "no objects here",
]


@pytest.mark.parametrize("text", DETECTION_STRINGS)
def test_detection_matches_jax(text):
    want, got = j_det.extract_objects(text), t_det.extract_objects(text)
    assert [(d.box, d.label, d.seg_indices) for d in got] == \
        [(d.box, d.label, d.seg_indices) for d in want]
    for h, w in ((480, 640), (37, 11)):
        assert [d.box_pixels(h, w) for d in got] == [d.box_pixels(h, w) for d in want]
        np.testing.assert_array_equal(t_det.boxes_array(got, h, w), j_det.boxes_array(want, h, w))
        np.testing.assert_array_equal(t_det.render_box_masks(got, h, w),
                                      j_det.render_box_masks(want, h, w))
    assert t_det.format_objects(got) == j_det.format_objects(want)
    mask = np.random.default_rng(0).random((64, 64))
    for d in got:
        np.testing.assert_array_equal(t_det.paste_mask_in_box(mask, d.box, 50, 70),
                                      j_det.paste_mask_in_box(mask, d.box, 50, 70))
