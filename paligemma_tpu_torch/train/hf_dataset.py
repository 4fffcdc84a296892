"""HF-datasets adapter for CORD-style structured fine-tuning (the port's
own copy of paligemma_tpu/train/hf_dataset.py; ``datasets`` is imported
only inside ``load_hf_rows``).

The reference fine-tunes straight off ``naver-clova-ix/cord-v2`` with a
``CustomDataset`` that parses each row's ``ground_truth`` JSON and converts
the ``gt_parse`` tree to a Donut token string (ref: Paligemma_FT.ipynb cell
20). This adapter reproduces that contract for ANY HF image+JSON dataset
and yields rows in this framework's manifest shape
(``{"image": PIL-or-path, "prompt": str, "target": str}``), pluggable into
``train.data.collate`` and the finetune CLI (``--hf_dataset``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional

from .data import json2token


class HFDatasetAdapter:
    """Wraps an HF ``datasets.Dataset`` of CORD-style rows.

    Each source row must have an ``image`` column (PIL) and either a
    ``ground_truth`` column (JSON string holding ``gt_parse`` or
    ``gt_parses``, the CORD/Donut convention) or a plain ``target`` column.
    Ground-truth trees are converted lazily with json2token; rows with
    multiple ``gt_parses`` use the first (the reference converts all and
    indexes one per epoch — deterministic here).
    """

    def __init__(
        self,
        dataset,
        prompt: str = "extract JSON.",
        sort_json_key: bool = True,
        image_column: str = "image",
        gt_column: str = "ground_truth",
    ):
        self.dataset = dataset
        self.prompt = prompt
        self.sort_json_key = sort_json_key
        self.image_column = image_column
        self.gt_column = gt_column

    def __len__(self) -> int:
        return len(self.dataset)

    def _target(self, row: Dict[str, Any]) -> str:
        if "target" in row and self.gt_column not in row:
            target = row["target"]
            return target if isinstance(target, str) else json2token(
                target, self.sort_json_key
            )
        gt = row[self.gt_column]
        if isinstance(gt, str):
            gt = json.loads(gt)
        if "gt_parses" in gt:  # multiple valid parses (ref cell 20)
            parses = gt["gt_parses"]
            assert isinstance(parses, list) and parses, gt
            parse = parses[0]
        else:
            parse = gt.get("gt_parse", gt)
        return json2token(parse, self.sort_json_key)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        row = self.dataset[int(idx)]
        return {
            "image": row[self.image_column],
            "prompt": self.prompt,
            "target": self._target(row),
        }

    def rows(self) -> Iterator[Dict[str, Any]]:
        for i in range(len(self)):
            yield self[i]


def load_hf_rows(
    path_or_name: str,
    split: str = "train",
    prompt: str = "extract JSON.",
    sort_json_key: bool = True,
) -> HFDatasetAdapter:
    """Load an HF dataset by hub name or local directory and adapt it.

    A directory is loaded offline via ``load_from_disk`` (this environment
    has no network); anything else goes through ``load_dataset`` (e.g.
    ``naver-clova-ix/cord-v2``, the reference's dataset, when online).
    """
    import datasets

    if os.path.isdir(path_or_name):
        ds = datasets.load_from_disk(path_or_name)
        if isinstance(ds, datasets.DatasetDict):
            ds = ds[split]
    else:
        ds = datasets.load_dataset(path_or_name, split=split)
    return HFDatasetAdapter(ds, prompt=prompt, sort_json_key=sort_json_key)
