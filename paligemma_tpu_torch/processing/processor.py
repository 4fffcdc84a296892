"""PaliGemma prompt/image processor (port of
paligemma_tpu/processing/processor.py).

Reproduces the reference processor behavior (ref: processing_paligemma.py:94-212):

* registers ``<image>`` as an additional special token plus 128 ``<seg###>``
  and 1024 ``<loc####>`` task tokens (ref: 129-145), disables the tokenizer's
  automatic BOS/EOS (ref: 125-127);
* builds the "gemma string" ``{<image>*N}{bos}{prefix}\\n`` — fixed image
  placeholder count, BOS, prompt, trailing newline tokenized together with
  the prefix (HF convention; ref: 77-89);
* runs the image pipeline and tokenizes with longest-padding + truncation.

Pixels: a batch of images of one size goes through the native C++
preprocessor (processing/native.py) when it is built, anything else through
PIL. A native library that fails raises: the two filters differ by up to
0.35, so one is never swapped for the other behind the caller's back.
``last_route`` says which one the last call took.

Outputs are numpy (host); the engine moves them to its device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .images import process_images_host
from .native import native_available, preprocess_images_native

IMAGE_TOKEN = "<image>"


class PaliGemmaProcessor:
    def __init__(self, tokenizer, num_image_tokens: int, image_size: int):
        self.tokenizer = tokenizer
        self.image_seq_len = num_image_tokens
        self.image_size = image_size
        self.last_route = None  # "native" or "pil" after a call

        # Right padding is a framework invariant (last-valid-token logits at
        # prefill, contiguous-prefix flash masks, engine write_pos math).
        self.tokenizer.padding_side = "right"
        self._add_new_tokens_to_tokenizer()
        self.tokenizer.add_eos_token = False
        self.tokenizer.add_bos_token = False

    def _add_new_tokens_to_tokenizer(self):
        self.tokenizer.add_special_tokens(
            {"additional_special_tokens": [IMAGE_TOKEN]}
        )
        extra = [f"<seg{i:03d}>" for i in range(128)]
        extra += [f"<loc{i:04d}>" for i in range(1024)]
        self.tokenizer.add_tokens(extra)
        self.tokenizer.image_token_id = self.tokenizer.convert_tokens_to_ids(
            IMAGE_TOKEN
        )

    def build_prompt(self, prefix_prompt: str) -> str:
        """The gemma string (ref: processing_paligemma.py:77-89)."""
        return f"{IMAGE_TOKEN * self.image_seq_len}{self.tokenizer.bos_token}{prefix_prompt}\n"

    def _pixel_values(self, images) -> np.ndarray:
        sizes = {getattr(im, "size", None) for im in images}
        if len(sizes) == 1 and None not in sizes and native_available():
            raw = np.stack([np.asarray(im.convert("RGB"), np.uint8) for im in images])
            self.last_route = "native"
            return preprocess_images_native(raw, self.image_size)
        self.last_route = "pil"
        return process_images_host(images, self.image_size)

    def __call__(
        self,
        images: Sequence,
        text: Sequence[str],
        padding: str = "longest",
        truncation: bool = True,
    ) -> dict:
        if len(images) != len(text):
            raise ValueError(f"images and prompts must pair 1:1, got {len(images)} images "
                             f"and {len(text)} prompts")
        pixel_values = self._pixel_values(images)

        prompts = [self.build_prompt(t) for t in text]
        toks = self.tokenizer(
            prompts,
            return_tensors="np",
            truncation=truncation,
            padding=padding,
        )
        return {
            "pixel_values": pixel_values,
            "input_ids": np.asarray(toks["input_ids"], np.int32),
            "attention_mask": np.asarray(toks["attention_mask"], np.int32),
        }
