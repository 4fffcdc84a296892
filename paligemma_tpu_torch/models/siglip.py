"""SigLIP vision tower (port of paligemma_tpu/models/siglip.py).

Patch embedding as one GEMM over reshaped patches (the stride == kernel
convolution is exactly that), learned positions, pre-LN encoder blocks
(MHA -> tanh-GELU MLP), final LayerNorm. Stacked per-layer params, weights
(in, out).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.config import SiglipVisionConfig
from ..kernels.flash_attention import flash_attention
from ..ops import attention
from ..ops.activations import gelu_tanh
from ..ops.norms import layer_norm

Params = Dict[str, Any]


def layer_params(tree: Params, i: int) -> Params:
    """Slice layer ``i`` out of a stacked (L, ...) param tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nH*nW, p*p*C), row-major patches, (ph, pw, c)
    flattening order."""
    b, h, w, c = pixel_values.shape
    p = patch_size
    nh, nw = h // p, w // p
    x = pixel_values.reshape(b, nh, p, nw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, p * p * c)


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


def _encoder_block(
    cfg: SiglipVisionConfig, x: torch.Tensor, lp: Params, attn: str = "xla"
) -> torch.Tensor:
    b, s, d = x.shape
    h, hd = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_eps

    residual = x
    y = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps)
    q = _dense(y, lp["attn"]["q"]).reshape(b, s, h, hd)
    k = _dense(y, lp["attn"]["k"]).reshape(b, s, h, hd)
    v = _dense(y, lp["attn"]["v"]).reshape(b, s, h, hd)
    if attn == "flash":
        full = torch.full((b,), s, dtype=torch.int32, device=x.device)
        a = flash_attention(q, k, v, full, full)
    else:
        a = attention.mha(q, k, v)  # non-causal full attention over patches
    x = residual + _dense(a.reshape(b, s, d), lp["attn"]["o"])

    residual = x
    y = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps)
    y = gelu_tanh(_dense(y, lp["mlp"]["fc1"]))
    return residual + _dense(y, lp["mlp"]["fc2"])


def encode(
    params: Params,
    cfg: SiglipVisionConfig,
    pixel_values: torch.Tensor,  # (B, C, H, W)
    attn: str = "xla",
) -> torch.Tensor:
    """Vision forward: (B, C, H, W) pixels -> (B, num_patches, hidden).

    ``attn``: "xla" (plain attention; the choice at 224 px, see
    models/paligemma._vision_attn_mode) or "flash" (the flash kernel)."""
    x = pixel_values.permute(0, 2, 3, 1)  # NCHW -> NHWC
    dtype = params["pos_embed"].dtype
    patches = patchify(x, cfg.patch_size).to(dtype)
    h = _dense(patches, params["patch_embed"]) + params["pos_embed"][None]
    for i in range(cfg.num_hidden_layers):
        h = _encoder_block(cfg, h, layer_params(params["layers"], i), attn=attn)
    return layer_norm(
        h, params["post_ln"]["scale"], params["post_ln"]["bias"], cfg.layer_norm_eps
    )
