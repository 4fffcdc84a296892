"""Hand-written Hopper kernels and their wrappers.

Each wrapper carries an integer ``launches`` attribute that it increments
where it launches its kernel (never on the plain CPU path), so a run can
show which kernels its main path went through. A wrapper of a chain of
kernels (``mlp_decode_fused``, ``attn_decode_tp``, ``attn_decode_paged_tp``)
counts its own launches, and each kernel of the chain counts its own.
"""

from __future__ import annotations

from typing import Dict

from . import decode_attention as _decode_attention
from . import decode_elementwise as _decode_elementwise
from . import decode_head as _decode_head
from . import decode_layer_paged_tp as _decode_layer_paged_tp
from . import decode_layer_tp as _decode_layer_tp
from . import decode_mlp as _decode_mlp
from . import flash_attention as _flash_attention
from . import int8_gemv as _int8_gemv
from . import lora as _lora
from . import paged_attention as _paged_attention
from . import w8a8 as _w8a8
from .ablation import decode_attention as _seg_attention
from .ablation import quant4 as _quant4
from .ablation import quant_pallas as _quant_pallas
from .ablation import vision_attention as _vision_attention

# kernel name -> wrapper
WRAPPERS = {
    "flash_attention_fwd": _flash_attention.flash_attention,
    "int8_gemv": _int8_gemv.int8_gemv,
    "decode_attention": _decode_attention.decode_attention,
    # the final norm before the head (the layers' norms are GEMV prologues)
    "rms_norm": _decode_elementwise.rms_norm,
    # the qkv GEMV with RoPE and the fresh K/V rows (dense rows or page
    # slots) in its epilogue
    "int8_gemv_rope_kv": _int8_gemv.int8_gemv_rope_kv,
    "head_argmax": _decode_head.head_argmax_fused,
    "paged_decode_attention": _paged_attention.paged_decode_attention,
    "flash_attention_bwd_dq": _flash_attention.flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": _flash_attention.flash_attention_bwd_dkv,
    "int8_gemv_f32": _int8_gemv.int8_gemv_f32,
    # K1: the fp32 partial with the LoRA expand beside it (a tensor-parallel
    # rank's o / down under a multi-LoRA bank)
    "int8_gemv_f32_lora": _int8_gemv.int8_gemv_f32_lora,
    "mlp_decode_fused": _decode_mlp.mlp_decode_fused,
    "attn_decode_tp": _decode_layer_tp.attn_decode_tp,
    "attn_decode_paged_tp": _decode_layer_paged_tp.attn_decode_paged_tp,
    # the multi-LoRA shrink of the decode chains (kernels/decode_layer,
    # decode_layer_paged with lora_pack); its expand is int8_gemv's epilogue
    "lora_shrink": _lora.lora_shrink,
    # the W8A8 prefill products (kernels/quant.matmul_any with int8_act):
    # each row of x quantized to int8, then the int8 x int8 product
    "w8a8_quant_rows": _w8a8.w8a8_quant_rows,
    "w8a8_gemm": _w8a8.w8a8_gemm,
    # the fp32 forms of the one-card main path (--dtype float32), each
    # counted apart from its bf16 kernel; the wrapper of the bf16 kernel
    # sends fp32 inputs to them
    "flash_attention_fwd_fp32": _flash_attention.flash_attention_fwd_fp32,
    "int8_gemv_fp32": _int8_gemv.int8_gemv_fp32,
    "int8_gemv_rope_kv_fp32": _int8_gemv.int8_gemv_rope_kv_fp32,
    "head_argmax_fp32": _decode_head.head_argmax_fp32,
    "decode_attention_fp32": _decode_attention.decode_attention_fp32,
    "paged_decode_attention_fp32": _paged_attention.paged_decode_attention_fp32,
    "rms_norm_fp32": _decode_elementwise.rms_norm_fp32,
    # the fp32 forms of the LoRA bank, the mesh and W8A8 (the LoRA expand's
    # fp32 form is int8_gemv_fp32's and int8_gemv_rope_kv_fp32's epilogue, as
    # the bf16 expand is int8_gemv's)
    "lora_shrink_fp32": _lora.lora_shrink_fp32,
    "int8_gemv_f32_fp32": _int8_gemv.int8_gemv_f32_fp32,
    "int8_gemv_f32_lora_fp32": _int8_gemv.int8_gemv_f32_lora_fp32,
    "w8a8_quant_rows_fp32": _w8a8.w8a8_quant_rows_fp32,
    "w8a8_gemm_fp32": _w8a8.w8a8_gemm_fp32,
    # the fp32 forms of the flash backward (the Trainer on fp32 parameters)
    "flash_attention_bwd_dq_fp32": _flash_attention.flash_attention_bwd_dq_fp32,
    "flash_attention_bwd_dkv_fp32": _flash_attention.flash_attention_bwd_dkv_fp32,
    # the ablation shelf (kernels/ablation), reached through its own entry
    # points and siglip.encode(attn="fused")
    "vision_attention": _vision_attention.vision_attention,
    "seg_decode_attention": _seg_attention.decode_attention,
    "int4_matmul": _quant4.int4_matmul,
    "int8_matmul": _quant_pallas.int8_matmul,
    "int8_matmul_nmajor": _quant_pallas.int8_matmul_nmajor,
    # the fp32 forms of B12 and B10
    "vision_attention_fp32": _vision_attention.vision_attention_fp32,
    "seg_decode_attention_fp32": _seg_attention.decode_attention_fp32,
    # the mixed forms: a KV cache whose dtype is not the activations' (the
    # engines' cache_dtype), bf16 activations over an fp32 cache and fp32
    # over bf16; the wrapper of the uniform form sends them here
    "int8_gemv_rope_kv_cache_fp32": _int8_gemv.int8_gemv_rope_kv_cache_fp32,
    "int8_gemv_rope_kv_fp32_cache_bf16": _int8_gemv.int8_gemv_rope_kv_fp32_cache_bf16,
    "decode_attention_cache_fp32": _decode_attention.decode_attention_cache_fp32,
    "decode_attention_fp32_cache_bf16": _decode_attention.decode_attention_fp32_cache_bf16,
    "paged_decode_attention_cache_fp32": _paged_attention.paged_decode_attention_cache_fp32,
    "paged_decode_attention_fp32_cache_bf16":
        _paged_attention.paged_decode_attention_fp32_cache_bf16,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
