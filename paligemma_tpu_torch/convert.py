"""Parameter trees for the port: from the JAX package's arrays, or random.

``params_from_numpy`` turns a nested dict of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives for the JAX package's params) into
the port's tensors (model, int8, 4-bit and LoRA trees alike); bf16 arrays
(``ml_dtypes.bfloat16``) go through an fp32 round trip, which is exact.
It also carries the mask decoder's tree (processing/mask_vae: HWIO kernels
kept as they are), and JAX's ``init_lora`` draw, so that both packages can
train from the same adapters.
``init_params`` makes full-width random weights directly on a device from a
``torch.Generator``, in the JAX package's layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .core.config import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig

Params = Dict[str, Any]
_QUANT_META = ("s", "s4", "grid")  # fp32 leaves of quantized weights


def _to_tensor(a: np.ndarray, device, dtype: Optional[torch.dtype], is_scale: bool):
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32))).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    # quantization scales and codebooks stay fp32 whatever the parameter dtype
    if dtype is not None and t.is_floating_point() and not is_scale:
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None, _key: str = ""):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.

    ``dtype`` casts floating leaves (None keeps each leaf's own type);
    int8 / uint8 weights and the fp32 "s" (int8), "s4" and "grid" (4-bit)
    of quantized leaves keep theirs."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        return _to_tensor(np.asarray(tree), device, dtype, _key in _QUANT_META)
    return tree


def _normal(shape, std, gen, device, dtype):
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return t.mul_(std)


def _dense(i, o, gen, device, dtype, lead=()):
    return {
        "kernel": _normal(lead + (i, o), i**-0.5, gen, device, dtype),
        "bias": torch.zeros(lead + (o,), device=device, dtype=dtype),
    }


def init_vision_params(cfg: SiglipVisionConfig, gen, device, dtype) -> Params:
    """Random SigLIP tower weights at the config's full width, made on
    ``device`` with the generator ``gen`` (which must live there)."""
    d, inter, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    n = (cfg.num_hidden_layers,)

    def ln(lead=()):
        return {"scale": torch.ones(lead + (d,), device=device, dtype=dtype),
                "bias": torch.zeros(lead + (d,), device=device, dtype=dtype)}

    return {
        "patch_embed": _dense(p * p * cfg.num_channels, d, gen, device, dtype),
        "pos_embed": _normal((cfg.num_patches, d), 0.02, gen, device, dtype),
        "layers": {
            "ln1": ln(n),
            "attn": {name: _dense(d, d, gen, device, dtype, n) for name in "qkvo"},
            "ln2": ln(n),
            "mlp": {"fc1": _dense(d, inter, gen, device, dtype, n),
                    "fc2": _dense(inter, d, gen, device, dtype, n)},
        },
        "post_ln": ln(),
    }


def init_lm_params(cfg: GemmaConfig, gen, device, dtype) -> Params:
    """Random Gemma decoder weights at the config's full width, made on
    ``device`` with the generator ``gen`` (which must live there)."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    hq = cfg.num_attention_heads * cfg.head_dim
    hkv = cfg.num_key_value_heads * cfg.head_dim
    n = cfg.num_hidden_layers

    def w(i, o):
        return _normal((n, i, o), i**-0.5, gen, device, dtype)

    return {
        "embed": _normal((cfg.vocab_size, h), 0.02, gen, device, dtype),
        "layers": {
            "input_norm": torch.zeros((n, h), device=device, dtype=dtype),
            "attn": {"q": w(h, hq), "k": w(h, hkv), "v": w(h, hkv), "o": w(hq, h)},
            "post_norm": torch.zeros((n, h), device=device, dtype=dtype),
            "mlp": {"gate": w(h, inter), "up": w(h, inter), "down": w(inter, h)},
        },
        "final_norm": torch.zeros((h,), device=device, dtype=dtype),
    }


def init_params(
    cfg: PaliGemmaConfig,
    generator: torch.Generator,
    device,
    dtype: torch.dtype = torch.bfloat16,
) -> Params:
    """Random weights at the config's full width, made on ``device`` (the
    generator must live there too), with the JAX package's init scales."""
    vc = cfg.vision_config
    return {
        "vision": init_vision_params(vc, generator, device, dtype),
        "projector": {"kernel": _normal((vc.hidden_size, cfg.projection_dim),
                                        vc.hidden_size**-0.5, generator, device, dtype)},
        "lm": init_lm_params(cfg.text_config, generator, device, dtype),
    }
