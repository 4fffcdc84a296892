"""Weight-only quantization of the decoder (port of
paligemma_tpu/runtime/quantize.py).

``quantize_lm_for_serving``: the decoder's seven projections per layer
(stacked) become int8 with per-output-channel scales, with ``fuse`` q/k/v
fused into "qkv" and gate/up into "gateup" (the decode kernels' layout; the
trainer's int8 base keeps them apart), and the tied head gets a transposed
int8 copy ("head_q", (H, V)). ``quantize_lm_for_training``: the same
projections as blockwise 4-bit (NF4 or int4), the frozen QLoRA base. The
embedding table, the norms and the vision tower stay as they are.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..kernels.quant import quantize_4bit, quantize_int8


def quantize_lm_for_serving(params: Dict[str, Any], fuse: bool = True) -> Dict[str, Any]:
    """int8-quantize the decoder (returns a new tree; the input's tensors
    are not modified)."""
    lm = params["lm"]
    layers = lm["layers"]
    attn, mlp = layers["attn"], layers["mlp"]
    if fuse:
        def fuse_quant(*ws):
            # quantize per matrix, then concatenate: scales are per output
            # channel, so this equals quantizing the fused matrix
            qs = [quantize_int8(w) for w in ws]
            return {
                "w8": torch.cat([q["w8"] for q in qs], dim=-1),
                "s": torch.cat([q["s"] for q in qs], dim=-1),
            }

        q_attn = {"qkv": fuse_quant(attn["q"], attn["k"], attn["v"]),
                  "o": quantize_int8(attn["o"])}
        q_mlp = {"gateup": fuse_quant(mlp["gate"], mlp["up"]),
                 "down": quantize_int8(mlp["down"])}
    else:
        q_attn = {name: quantize_int8(w) for name, w in attn.items()}
        q_mlp = {name: quantize_int8(w) for name, w in mlp.items()}
    new_layers = {**layers, "attn": q_attn, "mlp": q_mlp}
    head_q = quantize_int8(lm["embed"].T)  # (H, V)
    return {**params, "lm": {**lm, "layers": new_layers, "head_q": head_q}}


def quantize_lm_for_training(
    params: Dict[str, Any], kind: str = "nf4", group: int = 64, fuse: bool = True,
) -> Dict[str, Any]:
    """Blockwise-4-bit quantize the decoder's projections as a frozen
    fine-tune base (QLoRA: LoRA adapters over an NF4 base). A weight whose
    input dim ``group`` does not divide takes ``gcd(K, group)``; the shared
    codebook is stacked to (L, 16) so a layer slice carries it."""
    lm = params["lm"]
    layers = lm["layers"]
    attn, mlp = layers["attn"], layers["mlp"]
    n_layers = layers["input_norm"].shape[0]

    def q4(w):
        g = group if w.shape[-2] % group == 0 else math.gcd(w.shape[-2], group)
        q = quantize_4bit(w, kind=kind, group=g)
        q["grid"] = q["grid"].expand(n_layers, 16).contiguous()
        return q

    if fuse:
        def fuse_q4(*ws):
            # per-matrix quantize then concat along N: block scales are per
            # (K-group, N-channel), so this equals quantizing the fused matrix
            qs = [q4(w) for w in ws]
            return {
                "w4": torch.cat([q["w4"] for q in qs], dim=-1),
                "s4": torch.cat([q["s4"] for q in qs], dim=-1),
                "grid": qs[0]["grid"],
            }

        q_attn = {"qkv": fuse_q4(attn["q"], attn["k"], attn["v"]), "o": q4(attn["o"])}
        q_mlp = {"gateup": fuse_q4(mlp["gate"], mlp["up"]), "down": q4(mlp["down"])}
    else:
        q_attn = {name: q4(w) for name, w in attn.items()}
        q_mlp = {name: q4(w) for name, w in mlp.items()}
    new_layers = {**layers, "attn": q_attn, "mlp": q_mlp}
    return {**params, "lm": {**lm, "layers": new_layers}}


def quantized_bytes(params: Dict[str, Any]) -> int:
    """Bytes held by the tree's tensor leaves (weights, scales, codebooks)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    return params.numel() * params.element_size() if torch.is_tensor(params) else 0
