"""HF safetensors checkpoint -> the port's parameter tree (port of
paligemma_tpu/checkpoints/hf_loader.py).

The flat HF state dict is remapped onto the stacked-layer tree that
``convert.params_from_numpy`` gives for the JAX loader's tree (same keys,
shapes and dtypes):

* torch ``nn.Linear`` weights are (out, in); the port's are (in, out) ->
  transpose.
* the patch-embedding conv kernel (D, C, p, p) becomes a (p*p*C, D) matmul
  kernel matching models/siglip.patchify's (ph, pw, c) flattening order.
* per-layer tensors are stacked along a leading layer axis.
* ``lm_head.weight`` is ignored (never read): the head is tied to
  ``embed_tokens`` (ref: modeling_gemma.py:492-499).

Both HF key layouts are accepted: the classic checkpoint layout
(``language_model.model.layers...``) and transformers>=4.52's nested layout
(``model.language_model.layers...``).

:func:`load_hf_model` reads one tensor at a time from the files
(checkpoints/safetensors.py), uploads it to the target device as stored,
and casts, transposes, reshapes and stacks it there: the host holds about
one tensor, and the ~2.9 B elements of the 3B model are moved by the
device, not by one host thread.
"""

from __future__ import annotations

import glob
import os
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import PaliGemmaConfig
from .safetensors import SafetensorsFile


def normalize_key(key: str) -> str:
    """Map either HF layout onto canonical ``language_model.layers...`` names."""
    if key.startswith("model."):
        key = key[len("model."):]
    key = key.replace("language_model.model.", "language_model.")
    return key


def _tensor(x) -> torch.Tensor:
    return x.detach() if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _stack(n: int, layer: Callable[[int], Any]):
    """Stack ``layer(0..n-1)`` (trees of tensors, possibly transposed
    views) along a new leading axis, copying each layer into one
    preallocated tensor per leaf."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    first = layer(0)
    out = alloc(first)
    put(out, first, 0)
    for i in range(1, n):
        put(out, layer(i), i)
    return out


def params_from_state_dict(
    cfg: PaliGemmaConfig, state_dict: Mapping, dtype: torch.dtype = torch.float32,
    *, device: Optional[torch.device] = None,
) -> Dict[str, Any]:
    """Build the model tree from a flat HF state dict (tensors or numpy
    arrays). Each entry is moved to ``device`` (None: a tensor stays where
    it is, a numpy array goes to the CPU), then cast to ``dtype`` and laid
    out there. The tree shares no memory with ``state_dict``."""
    names = {normalize_key(k): k for k in state_dict.keys()}

    def get(key):
        src = _tensor(state_dict[names[key]])
        t = (src if device is None else src.to(device)).to(dtype)
        return t.clone() if t is src else t

    def linear_t(key):  # torch (out, in) -> (in, out)
        return get(key).T

    vcfg, tcfg = cfg.vision_config, cfg.text_config

    # ---- vision tower ----
    conv = get("vision_tower.vision_model.embeddings.patch_embedding.weight")
    d, c, p, _ = conv.shape
    patch_kernel = conv.permute(2, 3, 1, 0).reshape(p * p * c, d)
    del conv

    def vlayer(i):
        pre = f"vision_tower.vision_model.encoder.layers.{i}"
        return {
            "ln1": {"scale": get(f"{pre}.layer_norm1.weight"),
                    "bias": get(f"{pre}.layer_norm1.bias")},
            "attn": {
                "q": {"kernel": linear_t(f"{pre}.self_attn.q_proj.weight"),
                      "bias": get(f"{pre}.self_attn.q_proj.bias")},
                "k": {"kernel": linear_t(f"{pre}.self_attn.k_proj.weight"),
                      "bias": get(f"{pre}.self_attn.k_proj.bias")},
                "v": {"kernel": linear_t(f"{pre}.self_attn.v_proj.weight"),
                      "bias": get(f"{pre}.self_attn.v_proj.bias")},
                "o": {"kernel": linear_t(f"{pre}.self_attn.out_proj.weight"),
                      "bias": get(f"{pre}.self_attn.out_proj.bias")},
            },
            "ln2": {"scale": get(f"{pre}.layer_norm2.weight"),
                    "bias": get(f"{pre}.layer_norm2.bias")},
            "mlp": {
                "fc1": {"kernel": linear_t(f"{pre}.mlp.fc1.weight"),
                        "bias": get(f"{pre}.mlp.fc1.bias")},
                "fc2": {"kernel": linear_t(f"{pre}.mlp.fc2.weight"),
                        "bias": get(f"{pre}.mlp.fc2.bias")},
            },
        }

    vision = {
        "patch_embed": {"kernel": patch_kernel,
                        "bias": get("vision_tower.vision_model.embeddings.patch_embedding.bias")},
        "pos_embed": get("vision_tower.vision_model.embeddings.position_embedding.weight"),
        "layers": _stack(vcfg.num_hidden_layers, vlayer),
        "post_ln": {"scale": get("vision_tower.vision_model.post_layernorm.weight"),
                    "bias": get("vision_tower.vision_model.post_layernorm.bias")},
    }

    # ---- projector ----
    projector = {"kernel": linear_t("multi_modal_projector.linear.weight").contiguous()}
    if "multi_modal_projector.linear.bias" in names:
        projector["bias"] = get("multi_modal_projector.linear.bias")

    # ---- language model ----
    def tlayer(i):
        pre = f"language_model.layers.{i}"
        return {
            "input_norm": get(f"{pre}.input_layernorm.weight"),
            "attn": {
                "q": linear_t(f"{pre}.self_attn.q_proj.weight"),
                "k": linear_t(f"{pre}.self_attn.k_proj.weight"),
                "v": linear_t(f"{pre}.self_attn.v_proj.weight"),
                "o": linear_t(f"{pre}.self_attn.o_proj.weight"),
            },
            "post_norm": get(f"{pre}.post_attention_layernorm.weight"),
            "mlp": {
                "gate": linear_t(f"{pre}.mlp.gate_proj.weight"),
                "up": linear_t(f"{pre}.mlp.up_proj.weight"),
                "down": linear_t(f"{pre}.mlp.down_proj.weight"),
            },
        }

    lm = {
        "embed": get("language_model.embed_tokens.weight"),
        "layers": _stack(tcfg.num_hidden_layers, tlayer),
        "final_norm": get("language_model.norm.weight"),
    }
    return {"vision": vision, "projector": projector, "lm": lm}


class _SafetensorsDir(Mapping):
    """The tensors of every ``*.safetensors`` file under a directory, as a
    read-only mapping; each tensor is read from its file when it is looked
    up, onto ``device``. A name in two files takes the later file's."""

    def __init__(self, model_path: str, device="cpu"):
        files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no *.safetensors under {model_path}")
        self.device = device
        self._where: Dict[str, SafetensorsFile] = {}
        for fn in files:
            f = SafetensorsFile(fn)
            for key in f.keys():
                self._where[key] = f

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._where[key].get_tensor(key, self.device)

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def close(self) -> None:
        for f in set(self._where.values()):
            f.close()


def load_state_dict_from_safetensors(model_path: str, *, device="cpu") -> _SafetensorsDir:
    """Glob ``*.safetensors`` under a directory (sorted) into one flat
    mapping (ref: utils.py:15-22); tensors are read on lookup, onto
    ``device``; ``close()`` releases the files' mappings."""
    return _SafetensorsDir(model_path, device)


def load_hf_model(
    model_path: str, dtype: torch.dtype = torch.bfloat16, *, device=None,
) -> Tuple[Dict[str, Any], PaliGemmaConfig]:
    """Load config + weights from an HF checkpoint directory
    (ref: utils.py:9-37). Returns (params tree, config).

    ``device=None`` is the card; the CPU only when asked
    (``device="cpu"``). With no card and no ``device`` it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("load_hf_model: no CUDA device; pass device='cpu' to load "
                               "on the host")
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = PaliGemmaConfig.from_hf_json(model_path)
    sd = load_state_dict_from_safetensors(model_path, device=device)
    try:
        params = params_from_state_dict(cfg, sd, dtype, device=device)
    finally:
        sd.close()
    return params, cfg
