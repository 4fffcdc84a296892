"""LoRA adapters for the Gemma decoder (port of paligemma_tpu/train/lora.py).

Rank r, alpha, targets q/k/v/o/gate/up/down of every decoder layer (the
reference's Q-LoRA recipe). Adapters are a separate tree stacked over
layers, ``{"layers": {name: {"a": (L, in, r), "b": (L, r, out),
"alpha": (L,)}}}``, applied un-merged in the forward
(models/gemma._lora_delta), so only they get gradients and optimizer state.

``stack_lora_bank`` stacks several adapters into the multi-LoRA serving bank
(runtime/serving ``lora_bank``): each batch row decodes under its own
adapter, row 0 of the bank being the all-zero adapter of the base model.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

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


def stack_lora_bank(adapters: Sequence[Dict[str, Any]],
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Stack adapters into a multi-LoRA serving bank.

    Returns ``{"layers": {name: {"a": (L, N+1, in, r), "b": (L, N+1, r,
    out), "alpha": (L, N+1), "a_cat": (L, in, (N+1)*r), "b_cat": (L,
    (N+1)*r, out)}}}``. The adapter axis is second, so one layer's slice is
    an (N+1, ...) bank that per-row ids gather from (models/gemma
    ``_lora_delta``). Index 0 is an all-zero adapter: rows serving the base
    model select it and get a delta of exactly 0. ``a_cat`` puts every
    adapter's A columns side by side and ``b_cat`` stacks the B rows with
    alpha / r folded in, so a row's delta is ``(y @ a_cat) * block_mask @
    b_cat``. Adapters must share their targets and rank."""
    if not adapters:
        raise ValueError("stack_lora_bank needs at least one adapter")
    ref = adapters[0]["layers"]
    for i, ad in enumerate(adapters[1:], start=1):
        for name, p in ad["layers"].items():
            if name not in ref:
                raise ValueError(f"adapter {i} has target '{name}' the first adapter lacks; "
                                 "multi-LoRA serving needs identical targets")
            if p["a"].shape != ref[name]["a"].shape:
                raise ValueError(
                    f"adapter {i} target '{name}' rank/shape {tuple(p['a'].shape)} != "
                    f"{tuple(ref[name]['a'].shape)}; multi-LoRA serving needs one shared rank "
                    "(pad or retrain)")
        if set(ad["layers"]) != set(ref):
            raise ValueError("adapters disagree on target sets; multi-LoRA serving needs "
                             "identical targets")
    layers = {}
    for name in ref:
        p = {k: torch.stack([torch.zeros_like(ref[name][k])]
                            + [ad["layers"][name][k] for ad in adapters], dim=1)
             for k in ("a", "b", "alpha")}
        if dtype is not None:
            p = {k: x.to(dtype) for k, x in p.items()}
        n_layers, n1, in_dim, r = p["a"].shape
        p["a_cat"] = p["a"].permute(0, 2, 1, 3).reshape(n_layers, in_dim, n1 * r)
        scale = (p["alpha"] / r)[:, :, None, None].to(p["b"].dtype)
        p["b_cat"] = (p["b"] * scale).reshape(n_layers, n1 * r, -1)
        layers[name] = p
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
