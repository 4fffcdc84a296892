"""Structured training/serving metrics (the port's own copy of
paligemma_tpu/runtime/logging.py).

The reference's observability is Lightning ``self.log`` calls and a
commented-out WandbLogger (ref: Paligemma_FT.ipynb cells 38/47). This writes
newline-delimited JSON — trivially ingestible by TensorBoard converters,
wandb offline sync, or a pandas one-liner — with no external dependency.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock stamps."""

    def __init__(self, path: str, flush_every: int = 1):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        self._flush_every = max(1, flush_every)
        self._n = 0
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {
            "step": step,
            "time": round(time.time() - self._t0, 3),
            **{k: (float(v) if hasattr(v, "__float__") else v)
               for k, v in metrics.items()},
        }
        self._f.write(json.dumps(rec) + "\n")
        self._n += 1
        if self._n % self._flush_every == 0:
            self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
