"""Local checkpoint save/restore (port of paligemma_tpu/checkpoints/local.py,
with ``torch.save`` in place of orbax).

A tree of nested dicts and lists of tensors and numbers (trainable
parameters plus optimizer state) is written to ``<path>/state.pt`` and read
back with ``torch.load(weights_only=True)``, which loads tensors and plain
containers only, never arbitrary objects.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

_FILE = "state.pt"


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` under the directory ``path`` (created; an existing
    checkpoint there is replaced)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def _like(loaded: Any, like: Any, where: str) -> Any:
    """``loaded`` laid out as ``like``: the same keys and lengths, each
    tensor moved to its counterpart's device and dtype, shapes checked."""
    if isinstance(like, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(like):
            raise ValueError(f"checkpoint tree differs at {where or 'the root'}")
        return {k: _like(loaded[k], like[k], f"{where}/{k}") for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(like):
            raise ValueError(f"checkpoint list differs at {where}")
        return type(like)(_like(a, b, f"{where}[{i}]") for i, (a, b) in enumerate(zip(loaded, like)))
    if torch.is_tensor(like):
        if not torch.is_tensor(loaded) or loaded.shape != like.shape:
            raise ValueError(f"checkpoint tensor differs at {where}")
        return loaded.to(device=like.device, dtype=like.dtype)
    return loaded


def restore_pytree(path: str, like: Optional[Any] = None) -> Any:
    """Read the tree saved under ``path``; with ``like``, checked against it
    and placed on its tensors' devices and dtypes (else on the CPU)."""
    tree = torch.load(os.path.join(os.path.abspath(path), _FILE), map_location="cpu",
                      weights_only=True)
    return tree if like is None else _like(tree, like, "")


def has_pytree(path: str) -> bool:
    """Whether ``path`` holds a checkpoint written by ``save_pytree``."""
    return os.path.isfile(os.path.join(os.path.abspath(path), _FILE))
