"""SigLIP vision tower (port of paligemma_tpu/models/siglip.py).

Patch embedding as one GEMM over reshaped patches (the stride == kernel
convolution is exactly that), learned positions, pre-LN encoder blocks
(MHA -> tanh-GELU MLP), final LayerNorm. Stacked per-layer params, weights
(in, out).

Under a tensor-parallel ``mesh`` (core/mesh) the blocks are Megatron-split:
each rank holds its share of the heads (q/k/v columns) and of fc1's
columns, and the o and fc2 partials are summed across ranks in fp32 before
the cast and the (replicated) bias. The patch embedding stays replicated
(the JAX package shards its D over the model axis): every rank embeds all
patches, as the blocks need the whole embedding as their input. Trained
under a mesh (``freeze_vision=False``), the gradient of each block's
normed input is summed over the ranks (core/mesh.copy_to_model).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import convert
from ..core import mesh as mesh_lib
from ..core.config import SiglipVisionConfig
from ..kernels.flash_attention import flash_attention, flash_attention_sharded
from ..ops import attention
from ..ops.activations import gelu_tanh
from ..ops.norms import layer_norm

Params = Dict[str, Any]
ATTN_MODES = ("xla", "flash", "fused")


def init_params(generator: torch.Generator, cfg: SiglipVisionConfig,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random tower weights (``convert.init_vision_params``), made on the
    generator's device."""
    return convert.init_vision_params(cfg, generator, generator.device, dtype)


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


def _dense_row(x: torch.Tensor, p: Params, mesh) -> torch.Tensor:
    """A row-parallel dense layer (o, fc2): under a mesh the ranks' partial
    products are summed in fp32 and cast, then the bias is added once."""
    if mesh is None:
        return _dense(x, p)
    return mesh_lib.psum((x @ p["kernel"]).float(), mesh).to(x.dtype) + p["bias"]


def _encoder_block(
    cfg: SiglipVisionConfig, x: torch.Tensor, lp: Params, attn: str = "xla", mesh=None,
) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = lp["attn"]["q"]["kernel"].shape[-1] // hd  # this rank's heads under a mesh
    eps = cfg.layer_norm_eps

    residual = x
    y = mesh_lib.copy_to_model(layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps), mesh)
    q = _dense(y, lp["attn"]["q"]).reshape(b, s, h, hd)
    k = _dense(y, lp["attn"]["k"]).reshape(b, s, h, hd)
    v = _dense(y, lp["attn"]["v"]).reshape(b, s, h, hd)
    if attn == "flash":
        full = torch.full((b,), s, dtype=torch.int32, device=x.device)
        a = (flash_attention(q, k, v, full, full) if mesh is None
             else flash_attention_sharded(q, k, v, full, full, mesh))
    elif attn == "fused":
        # the one-shot softmax kernel of the ablation shelf, opt-in only
        from ..kernels.ablation.vision_attention import vision_attention

        a = vision_attention(q, k, v)
    elif attn == "xla":
        a = attention.mha(q, k, v)  # non-causal full attention over patches
    else:
        raise ValueError(f"siglip attn must be one of {ATTN_MODES}, got {attn!r}")
    x = residual + _dense_row(a.reshape(b, s, h * hd), lp["attn"]["o"], mesh)

    residual = x
    y = mesh_lib.copy_to_model(layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps), mesh)
    y = gelu_tanh(_dense(y, lp["mlp"]["fc1"]))
    return residual + _dense_row(y, lp["mlp"]["fc2"], mesh)


def encode(
    params: Params,
    cfg: SiglipVisionConfig,
    pixel_values: torch.Tensor,  # (B, C, H, W)
    use_flash: bool = False,
    mesh=None,
    attn: Optional[str] = None,
) -> torch.Tensor:
    """Vision forward: (B, C, H, W) pixels -> (B, num_patches, hidden).

    ``attn``: "xla" (plain attention; the choice at 224 px, see
    models/paligemma._vision_attn_mode), "flash" (the flash kernel) or
    "fused" (the vision attention kernel of kernels/ablation, opt-in only);
    any other value raises ``ValueError``. ``attn=None`` derives it from
    ``use_flash``, as the JAX function does: "flash" if set, else "xla".
    ``mesh``: tensor parallel over this rank's slices (module docstring)."""
    if attn is None:
        attn = "flash" if use_flash else "xla"
    x = pixel_values.permute(0, 2, 3, 1)  # NCHW -> NHWC
    dtype = params["pos_embed"].dtype
    patches = patchify(x, cfg.patch_size).to(dtype)
    h = _dense(patches, params["patch_embed"]) + params["pos_embed"][None]
    for i in range(cfg.num_hidden_layers):
        h = _encoder_block(cfg, h, layer_params(params["layers"], i), attn=attn, mesh=mesh)
    return layer_norm(
        h, params["post_ln"]["scale"], params["post_ln"]["bias"], cfg.layer_norm_eps
    )
