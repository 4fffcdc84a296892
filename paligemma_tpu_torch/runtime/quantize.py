"""Serving-side int8 weight-only quantization (port of
paligemma_tpu/runtime/quantize.py ``quantize_lm_for_serving``).

The decoder's projections per layer (stacked) become int8 with
per-output-channel scales, q/k/v fused into "qkv" and gate/up into "gateup",
and the tied head gets a transposed int8 copy ("head_q", (H, V)). The
embedding table and the vision tower stay as they are.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..kernels.quant import quantize_int8


def quantize_lm_for_serving(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8-quantize the decoder for serving (returns a new tree; the
    input's tensors are not modified)."""
    lm = params["lm"]
    layers = lm["layers"]
    attn, mlp = layers["attn"], layers["mlp"]

    def fuse_quant(*ws):
        # quantize per matrix, then concatenate: scales are per output
        # channel, so this equals quantizing the fused matrix
        qs = [quantize_int8(w) for w in ws]
        return {
            "w8": torch.cat([q["w8"] for q in qs], dim=-1),
            "s": torch.cat([q["s"] for q in qs], dim=-1),
        }

    new_layers = {
        **layers,
        "attn": {"qkv": fuse_quant(attn["q"], attn["k"], attn["v"]),
                 "o": quantize_int8(attn["o"])},
        "mlp": {"gateup": fuse_quant(mlp["gate"], mlp["up"]),
                "down": quantize_int8(mlp["down"])},
    }
    head_q = quantize_int8(lm["embed"].T)  # (H, V)
    return {**params, "lm": {**lm, "layers": new_layers, "head_q": head_q}}
