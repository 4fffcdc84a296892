"""LoRA adapters for the Gemma decoder (port of paligemma_tpu/train/lora.py;
the multi-adapter serving bank ``stack_lora_bank`` is not ported).

Rank r, alpha, targets q/k/v/o/gate/up/down of every decoder layer (the
reference's Q-LoRA recipe). Adapters are a separate tree stacked over
layers, ``{"layers": {name: {"a": (L, in, r), "b": (L, r, out),
"alpha": (L,)}}}``, applied un-merged in the forward
(models/gemma._lora_delta), so only they get gradients and optimizer state.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from ..core.config import GemmaConfig
from ..kernels.quant import dequantize, dequantize_4bit

DEFAULT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def _target_dims(cfg: GemmaConfig, name: str) -> Tuple[int, int]:
    h = cfg.hidden_size
    hq = cfg.num_attention_heads * cfg.head_dim
    hkv = cfg.num_key_value_heads * cfg.head_dim
    return {
        "q": (h, hq),
        "k": (h, hkv),
        "v": (h, hkv),
        "o": (hq, h),
        "gate": (h, cfg.intermediate_size),
        "up": (h, cfg.intermediate_size),
        "down": (cfg.intermediate_size, h),
    }[name]


def init_lora(
    generator: torch.Generator,
    cfg: GemmaConfig,
    rank: int = 8,
    alpha: float = 8.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, Any]:
    """A: gaussian / sqrt(in) from ``generator`` (on its device), B: zeros,
    so the delta starts at 0."""
    n_layers = cfg.num_hidden_layers
    dev = generator.device
    layers = {}
    for name in targets:
        in_dim, out_dim = _target_dims(cfg, name)
        a = torch.randn((n_layers, in_dim, rank), generator=generator, device=dev, dtype=dtype)
        layers[name] = {
            "a": a * in_dim**-0.5,
            "b": torch.zeros((n_layers, rank, out_dim), dtype=dtype, device=dev),
            "alpha": torch.full((n_layers,), alpha, dtype=dtype, device=dev),
        }
    return {"layers": layers}


def num_trainable_params(lora: Dict[str, Any]) -> int:
    return sum(p[x].numel() for p in lora["layers"].values() for x in ("a", "b"))


def merge_lora(base_lm_params: Dict[str, Any], lora: Dict[str, Any]) -> Dict[str, Any]:
    """Fold adapters into the base weights (export, inference).

    Quantized bases (int8 ``{"w8", "s"}``, 4-bit ``{"w4", "s4", "grid"}``)
    dequantize to bf16 where an adapter lands; fused "qkv" / "gateup" slabs
    dequantize and split back into q/k/v (q's width is o's input dim, k and
    v halve the rest) and gate/up halves. The merged tree is unfused; re-fuse
    for serving with runtime.quantize.quantize_lm_for_serving."""

    def dense(w):
        if isinstance(w, dict):
            return (dequantize_4bit(w, torch.bfloat16) if "w4" in w
                    else dequantize(w, torch.bfloat16))
        return w

    def in_dim(w):  # (L, K, N) weights; w4 packs two K rows per byte
        if isinstance(w, dict):
            return 2 * w["w4"].shape[-2] if "w4" in w else w["w8"].shape[-2]
        return w.shape[-2]

    layers = dict(base_lm_params["layers"])
    attn, mlp = dict(layers["attn"]), dict(layers["mlp"])
    if "qkv" in attn:
        qkv = dense(attn.pop("qkv"))  # (L, H, dq + 2 * dkv)
        dq = in_dim(attn["o"])
        dkv = (qkv.shape[-1] - dq) // 2
        attn["q"], attn["k"], attn["v"] = qkv[..., :dq], qkv[..., dq:dq + dkv], qkv[..., dq + dkv:]
    if "gateup" in mlp:
        gu = dense(mlp.pop("gateup"))  # (L, H, 2 * I)
        half = gu.shape[-1] // 2
        mlp["gate"], mlp["up"] = gu[..., :half], gu[..., half:]

    for name, p in lora["layers"].items():
        scale = (p["alpha"] / p["a"].shape[-1])[:, None, None]
        delta = torch.einsum("lir,lro->lio", p["a"], p["b"]) * scale
        group = attn if name in ("q", "k", "v", "o") else mlp
        base = dense(group[name])
        group[name] = base + delta.to(base.dtype)
    layers["attn"], layers["mlp"] = attn, mlp
    return {**base_lm_params, "layers": layers}
