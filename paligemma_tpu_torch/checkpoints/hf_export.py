"""Export a params tree back to an HF-format checkpoint directory (port of
paligemma_tpu/checkpoints/hf_export.py).

Writes ``model.safetensors`` (classic PaliGemma key layout:
``vision_tower.vision_model...``, ``language_model.model...``), fp32 as the
JAX package writes it, plus ``config.json``, so the result loads in HF
transformers or back into either package (checkpoints.hf_loader). The
inverse of hf_loader.params_from_state_dict.

The file is streamed (checkpoints/safetensors.write_stream): each tensor is
cast and transposed on the params' device when its turn comes, copied to
the host and written, so the host holds one tensor at a time.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..core.config import PaliGemmaConfig
from .safetensors import write_stream

# (HF name, source tensor, how): how is None (as is), "T" (the port's
# (in, out) back to torch's (out, in)) or "patch" (the matmul kernel back to
# the (D, C, p, p) conv kernel)
_Entry = Tuple[str, torch.Tensor, Any]


def _entries(cfg: PaliGemmaConfig, params: Dict[str, Any]) -> List[_Entry]:
    vcfg, tcfg = cfg.vision_config, cfg.text_config
    out: List[_Entry] = []

    # ---- vision ----
    v = params["vision"]
    emb = "vision_tower.vision_model.embeddings"
    out.append((f"{emb}.patch_embedding.weight", v["patch_embed"]["kernel"], "patch"))
    out.append((f"{emb}.patch_embedding.bias", v["patch_embed"]["bias"], None))
    out.append((f"{emb}.position_embedding.weight", v["pos_embed"], None))
    vl = v["layers"]
    for i in range(vcfg.num_hidden_layers):
        pre = f"vision_tower.vision_model.encoder.layers.{i}"
        out.append((f"{pre}.layer_norm1.weight", vl["ln1"]["scale"][i], None))
        out.append((f"{pre}.layer_norm1.bias", vl["ln1"]["bias"][i], None))
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("o", "out_proj")):
            out.append((f"{pre}.self_attn.{theirs}.weight", vl["attn"][ours]["kernel"][i], "T"))
            out.append((f"{pre}.self_attn.{theirs}.bias", vl["attn"][ours]["bias"][i], None))
        out.append((f"{pre}.layer_norm2.weight", vl["ln2"]["scale"][i], None))
        out.append((f"{pre}.layer_norm2.bias", vl["ln2"]["bias"][i], None))
        for fc in ("fc1", "fc2"):
            out.append((f"{pre}.mlp.{fc}.weight", vl["mlp"][fc]["kernel"][i], "T"))
            out.append((f"{pre}.mlp.{fc}.bias", vl["mlp"][fc]["bias"][i], None))
    out.append(("vision_tower.vision_model.post_layernorm.weight", v["post_ln"]["scale"], None))
    out.append(("vision_tower.vision_model.post_layernorm.bias", v["post_ln"]["bias"], None))

    # ---- projector ----
    out.append(("multi_modal_projector.linear.weight", params["projector"]["kernel"], "T"))
    if "bias" in params["projector"]:
        out.append(("multi_modal_projector.linear.bias", params["projector"]["bias"], None))

    # ---- language model ----
    lm = params["lm"]
    ll = lm["layers"]
    out.append(("language_model.model.embed_tokens.weight", lm["embed"], None))
    for i in range(tcfg.num_hidden_layers):
        pre = f"language_model.model.layers.{i}"
        out.append((f"{pre}.input_layernorm.weight", ll["input_norm"][i], None))
        out.append((f"{pre}.post_attention_layernorm.weight", ll["post_norm"][i], None))
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("o", "o_proj")):
            out.append((f"{pre}.self_attn.{theirs}.weight", ll["attn"][ours][i], "T"))
        for ours, theirs in (("gate", "gate_proj"), ("up", "up_proj"),
                             ("down", "down_proj")):
            out.append((f"{pre}.mlp.{theirs}.weight", ll["mlp"][ours][i], "T"))
    out.append(("language_model.model.norm.weight", lm["final_norm"], None))
    return out


def _shape(cfg: PaliGemmaConfig, t: torch.Tensor, how) -> Tuple[int, ...]:
    if how == "T":
        return tuple(t.shape[::-1])
    if how == "patch":
        v = cfg.vision_config
        return (v.hidden_size, v.num_channels, v.patch_size, v.patch_size)
    return tuple(t.shape)


def _make(cfg: PaliGemmaConfig, dtype: torch.dtype) -> Callable[[torch.Tensor, Any], torch.Tensor]:
    v = cfg.vision_config
    p, c, d = v.patch_size, v.num_channels, v.hidden_size

    def make(t, how):
        """The HF tensor: a new contiguous tensor on the source's device
        (one pass casts and lays it out)."""
        if how == "T":
            t = t.T
        elif how == "patch":
            t = t.reshape(p, p, c, d).permute(3, 2, 0, 1)
        return t.to(dtype, copy=True, memory_format=torch.contiguous_format)

    return make


def state_dict_from_params(cfg: PaliGemmaConfig, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of hf_loader.params_from_state_dict (classic key layout):
    fp32 tensors on the CPU."""
    make = _make(cfg, torch.float32)
    return {name: make(t, how).cpu() for name, t, how in _entries(cfg, params)}


def export_hf_checkpoint(
    cfg: PaliGemmaConfig, params: Dict[str, Any], out_dir: str,
    *, dtype: torch.dtype = torch.float32,
) -> int:
    """Write ``model.safetensors`` (``dtype``: fp32 as the JAX package
    writes it; bf16 halves the file) and ``config.json`` under ``out_dir``.
    Returns the bytes of the safetensors file."""
    os.makedirs(out_dir, exist_ok=True)
    entries = _entries(cfg, params)
    make = _make(cfg, dtype)
    specs = [(name, dtype, _shape(cfg, t, how)) for name, t, how in entries]
    by_name = {name: (t, how) for name, t, how in entries}
    n_bytes = write_stream(os.path.join(out_dir, "model.safetensors"), specs,
                           lambda name: make(*by_name[name]))

    vd = dataclasses.asdict(cfg.vision_config)
    td = dataclasses.asdict(cfg.text_config)
    config = {
        "model_type": "paligemma",
        "projection_dim": cfg.projection_dim,
        "ignore_index": cfg.ignore_index,
        "image_token_index": cfg.image_token_index,
        "pad_token_id": cfg.pad_token_id,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "vision_config": vd,
        "text_config": td,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return n_bytes
