"""Dataset utilities for structured fine-tuning (the port's own copy of
paligemma_tpu/train/data.py: numpy and ``re`` only; batches stay numpy and
the Trainer moves them to its device).

Reproduces the reference fine-tune's data machinery (ref: Paligemma_FT.ipynb
cells 20, 27, 53-55):

* ``json2token``: nested JSON ground truth -> Donut-style token string with
  ``<s_key>...</s_key>`` markers and ``<sep/>`` between list items.
* ``token2json``: inverse regex parser back to (nested) JSON.
* ``collate``: batch of (image, prompt, target) -> model batch with
  ``token_type_ids`` (prefix vs suffix) and ``labels`` (-100 on prefix/pads),
  matching the HF processor-with-suffix convention.
* ``normalized_edit_distance``: the reference's validation metric
  (nltk.edit_distance / max length, FT notebook cell 38).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence

import numpy as np


def json2token(
    obj: Any,
    sort_json_key: bool = True,
) -> str:
    """Nested JSON -> token sequence (Donut convention)."""
    if isinstance(obj, dict):
        if len(obj) == 1 and "text_sequence" in obj:
            return obj["text_sequence"]
        keys = sorted(obj.keys(), reverse=True) if sort_json_key else obj.keys()
        return "".join(
            f"<s_{k}>" + json2token(obj[k], sort_json_key) + f"</s_{k}>" for k in keys
        )
    if isinstance(obj, list):
        return "<sep/>".join(json2token(item, sort_json_key) for item in obj)
    return str(obj)


def token2json(tokens: str, is_inner_value: bool = False) -> Any:
    """Token sequence -> JSON (inverse of json2token; ref: FT notebook cell 55)."""
    output: Dict[str, Any] = {}

    while tokens:
        start_token = re.search(r"<s_(.*?)>", tokens, re.IGNORECASE)
        if start_token is None:
            break
        key = start_token.group(1)
        end_token = re.search(rf"</s_{re.escape(key)}>", tokens, re.IGNORECASE)
        start_token_str = start_token.group()
        if end_token is None:
            tokens = tokens.replace(start_token_str, "", 1)
            continue
        content = tokens[
            start_token.end():end_token.start()
        ]
        if content.strip():
            if re.search(r"<s_(.*?)>", content, re.IGNORECASE):
                value = token2json(content, is_inner_value=True)
                if value:
                    output[key] = value if len(value) > 1 else value[0]
            else:
                output[key] = []
                for leaf in content.split("<sep/>"):
                    leaf = leaf.strip()
                    if leaf:
                        output[key].append(leaf)
                if len(output[key]) == 1:
                    output[key] = output[key][0]
        tokens = tokens[end_token.end():]
        if tokens.strip().startswith("<sep/>") and not is_inner_value:
            # top-level list of dicts
            rest = token2json(tokens.split("<sep/>", 1)[1], is_inner_value=True)
            return [output] + (rest if isinstance(rest, list) else [rest])

    if is_inner_value:
        return [output] if output else []
    return output


def normalized_edit_distance(pred: str, answer: str) -> float:
    """Levenshtein distance / max(len) (ref: FT notebook cell 38)."""
    m, n = len(pred), len(answer)
    if max(m, n) == 0:
        return 0.0
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (pred[i - 1] != answer[j - 1]),
            )
        prev = cur
    return prev[n] / max(m, n)


def collate(
    processor,
    images: Sequence,
    prompts: Sequence[str],
    targets: Optional[Sequence[str]] = None,
    max_length: int = 512,
    pad_to_multiple: int = 64,
) -> Dict[str, np.ndarray]:
    """Build a train/eval batch.

    Train (targets given): rows are ``<image>*N + bos + prompt + \\n``
    (prefix, token_type 0) followed by ``target + eos`` (suffix, token_type
    1, causally masked, supervised via labels). Eval: prefix only.
    Mirrors the reference collate fns (FT notebook cell 27).
    """
    pixel_values = __import__(
        "paligemma_tpu_torch.processing.images", fromlist=["process_images_host"]
    ).process_images_host(images, processor.image_size)

    tok = processor.tokenizer
    rows, types = [], []
    for i, prompt in enumerate(prompts):
        prefix = processor.build_prompt(prompt)
        prefix_ids = tok(prefix)["input_ids"] if not hasattr(
            tok, "_encode"
        ) else tok._encode(prefix)
        if isinstance(prefix_ids, dict):
            prefix_ids = prefix_ids["input_ids"]
        row = list(prefix_ids)
        ttype = [0] * len(row)
        if targets is not None:
            sfx = tok._encode(targets[i]) if hasattr(tok, "_encode") else tok(
                targets[i]
            )["input_ids"]
            if isinstance(sfx, dict):
                sfx = sfx["input_ids"]
            sfx = list(sfx) + [tok.eos_token_id]
            row += sfx
            ttype += [1] * len(sfx)
        rows.append(row[:max_length])
        types.append(ttype[:max_length])

    maxlen = max(len(r) for r in rows)
    maxlen = ((maxlen + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    b = len(rows)
    input_ids = np.zeros((b, maxlen), np.int32)
    attention_mask = np.zeros((b, maxlen), np.int32)
    token_type_ids = np.zeros((b, maxlen), np.int32)
    labels = np.full((b, maxlen), -100, np.int32)
    for i, (row, ttype) in enumerate(zip(rows, types)):
        L = len(row)
        input_ids[i, :L] = row
        attention_mask[i, :L] = 1
        token_type_ids[i, :L] = ttype
        sfx = np.asarray(ttype) == 1
        labels[i, :L][sfx] = np.asarray(row)[sfx]

    out = {
        "pixel_values": pixel_values,
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "token_type_ids": token_type_ids,
    }
    if targets is not None:
        out["labels"] = labels
    return out
