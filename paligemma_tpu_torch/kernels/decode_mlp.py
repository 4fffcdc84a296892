"""One layer's int8 GeGLU MLP at decode (port of
paligemma_tpu/kernels/decode_mlp.py ``mlp_decode_fused``, B7b).

    out = (gelu_tanh((y @ Wg) * sg) * ((y @ Wu) * su)) @ Wd * sd

The TPU kernel streams the layer's gate, up and down weights through VMEM
in double-buffered chunks so that the MLP is one launch instead of three
XLA ops. On Hopper it is the chain of the hand-written GEMV
(``csrc/int8_gemv.cuh``) that the decode layer already runs: the gate/up GEMV
with the GeGLU epilogue over ``[gate | up]``, then the down GEMV with

* ``out_dtype=None``: the bf16 epilogue (the one-card ``fused_mlp`` route
  of models/gemma.forward, whose caller adds the residual);
* ``out_dtype=torch.float32``: the fp32-partial epilogue
  (``int8_gemv_f32``), which a tensor-parallel rank's down-projection
  leaves in fp32 for the sum across ranks.

``norm=(w, eps)``: the MLP of y's Gemma RMSNorm (the post-attention norm
of the decode layer), computed in the gate/up GEMV's prologue
(kernels/int8_gemv ``norm=``), as the TPU decode layer normalizes h in the
kernel that streams the gate/up weights.

``lora_pack`` / ``adapter_ids`` (a tensor-parallel rank's MLP under a
multi-LoRA bank, kernels/decode_layer_tp; ``out_dtype=torch.float32``
only): the gate/up GEMV adds each row's gate and up deltas before the
GeGLU, and the down partial is K1 (``int8_gemv_f32_lora``), the rank's
partial delta beside the base partial, (B, 2K). On the CPU that chain runs
its kernels' plain versions.

What bounds it: streaming the layer's int8 weights (3 K x I bytes: 100 MB
per layer of Gemma-2B at one rank, 12.6 MB at eight), read once each.

The TPU's chunk-major relayout of gate/up (``repack``) is a DMA layout; the
GEMV reads the (K, 2I) serving tree as it is, so ``repack`` returns it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.activations import gelu_tanh
from .decode_layer import lora_gemv
from .int8_gemv import Norm, int8_gemv, int8_gemv_f32, normed
from .lora import lora_shrink


def pick_block(inter: int) -> Optional[int]:
    """The TPU kernel's chunk width over the intermediate dimension, or
    None where it takes the XLA path (kept as the JAX gate: ``supported``)."""
    for bs in (1024, 512, 256):
        if inter % bs == 0 and inter >= bs:
            return bs
    return None


def supported(mlp: Dict) -> bool:
    """True for the int8 serving MLP (fused ``gateup`` and ``down``) at an
    intermediate size the JAX kernel takes."""
    return (
        isinstance(mlp.get("gateup"), dict)
        and "w8" in mlp["gateup"]
        and isinstance(mlp.get("down"), dict)
        and "w8" in mlp["down"]
        and pick_block(mlp["down"]["w8"].shape[-2]) is not None
    )


def repack(mlp: Dict) -> Dict:
    """The tree :func:`mlp_decode_fused` reads: the serving tree itself. A
    leaf the GEMV cannot read raises here, not at the first decode step."""
    for name in ("gateup", "down"):
        leaf = mlp[name]
        if not (leaf["w8"].dtype == torch.int8 and leaf["w8"].is_contiguous()
                and leaf["s"].dtype == torch.float32 and leaf["s"].is_contiguous()):
            raise ValueError(f"decode_mlp.repack: {name} must be contiguous int8 w8 with "
                             "contiguous fp32 s")
    return mlp


def reference_mlp(y: torch.Tensor, mlp: Dict, layer_idx: int, *,
                  out_dtype: Optional[torch.dtype] = None,
                  norm: Optional[Norm] = None) -> torch.Tensor:
    """Plain version: (with ``norm``, of y's RMSNorm) the GeGLU on fp32 gate
    and up, rounded to the activation dtype, then the fp32 down product and
    scale, rounded to ``out_dtype`` (default: y's)."""
    y = normed(y, norm)
    gu, dn = mlp["gateup"], mlp["down"]
    v = (y.float() @ gu["w8"][layer_idx].float()) * gu["s"][layer_idx]
    inter = v.shape[-1] // 2
    t = (gelu_tanh(v[..., :inter]) * v[..., inter:]).to(y.dtype)
    out = (t.float() @ dn["w8"][layer_idx].float()) * dn["s"][layer_idx]
    return out.to(out_dtype or y.dtype)


def mlp_decode_fused(
    y: torch.Tensor,  # (B, 1, K) or (B, K): one token per row
    mlp: Dict,  # stacked int8 serving MLP ({"gateup", "down"}, (L, ...))
    layer_idx: int,
    *,
    out_dtype: Optional[torch.dtype] = None,  # None: y's dtype; or torch.float32
    norm: Optional[Norm] = None,  # (w (K,), eps): the MLP of y's RMSNorm
    lora_pack: Optional[Dict] = None,  # a rank's decode_layer.repack_lora_bank_fused pack
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) int32 bank rows
) -> torch.Tensor:
    """Layer ``layer_idx``'s MLP for one token per row; y-shaped output
    ((B, 2K) [base | delta] fp32 with ``lora_pack``)."""
    if lora_pack is None and not y.is_cuda:
        return reference_mlp(y, mlp, layer_idx, out_dtype=out_dtype, norm=norm)
    if out_dtype not in (None, y.dtype, torch.float32):
        raise ValueError(f"mlp_decode_fused: out_dtype {out_dtype} (None or torch.float32)")
    if lora_pack is not None and (out_dtype != torch.float32 or adapter_ids is None):
        raise ValueError("mlp_decode_fused: lora_pack takes out_dtype=torch.float32 (the "
                         "tensor-parallel partial) and adapter_ids")
    shape = y.shape
    y2 = y.reshape(-1, shape[-1])
    ids = None if adapter_ids is None else adapter_ids.to(torch.int32).contiguous()
    gu, dn = mlp["gateup"], mlp["down"]
    t = lora_gemv(y2, gu, layer_idx, lora_pack, "gu", ids, (gu["w8"].shape[-1] // 2,),
                  geglu=True, norm=norm)
    if out_dtype == torch.float32:
        lora = None
        if lora_pack is not None:  # K1: the down shrink over this rank's I rows
            z = lora_shrink(t, lora_pack["down_a"][layer_idx], ids, lora_pack["rank"],
                            lora_pack["o_b"].shape[1])
            lora = (z, lora_pack["down_b"][layer_idx], ())
        out = int8_gemv_f32(t, dn["w8"][layer_idx], dn["s"][layer_idx], lora=lora)
    else:
        out = int8_gemv(t, dn["w8"][layer_idx], dn["s"][layer_idx])
    if y.is_cuda:
        mlp_decode_fused.launches += 1
    return out.reshape(*shape[:-1], -1)


mlp_decode_fused.launches = 0
